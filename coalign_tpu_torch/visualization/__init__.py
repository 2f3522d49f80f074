"""Host-side renderings of points and boxes (port of
coalign_tpu/visualization/): numpy canvases written as PNGs by
data/image_io.write_png, without PIL."""

from coalign_tpu_torch.visualization.canvas_3d import Canvas3D  # noqa: F401
from coalign_tpu_torch.visualization.canvas_bev import CanvasBEV  # noqa: F401
from coalign_tpu_torch.visualization.simple_vis import visualize  # noqa: F401
