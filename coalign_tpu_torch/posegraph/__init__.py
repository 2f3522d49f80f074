from coalign_tpu_torch.posegraph.box_align import (  # noqa: F401
    BoxAlignConfig, align_poses_batch, box_alignment_relative_sample)
