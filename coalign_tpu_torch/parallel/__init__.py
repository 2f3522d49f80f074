"""Data parallelism (mesh.py, distributed.py) and spatial BEV sharding
(spatial.py) over torch.distributed; the port of coalign_tpu/parallel/."""

from coalign_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, shard_batch, replicate)
from coalign_tpu_torch.parallel.distributed import (  # noqa: F401
    get_dist_info, init_distributed_mode)
