"""The distributed layer of the port on ``torch.distributed``: meshes as
process groups (``mesh``), layouts (``specs``), the sharded steps
(``sharded``) and the multi-rank dry run (``dryrun``)."""

from rgbd_pose_estimation_tpu_torch.parallel.mesh import (
    check_config_consistency,
    distributed_init,
    make_mesh,
    partition_bounds,
)
from rgbd_pose_estimation_tpu_torch.parallel.sharded import (
    ba_step_sharded,
    icp_jtj_sharded,
    ring_similarity,
    score_poses_3d3d_sharded,
)

__all__ = [
    "make_mesh",
    "distributed_init",
    "check_config_consistency",
    "partition_bounds",
    "ba_step_sharded",
    "score_poses_3d3d_sharded",
    "icp_jtj_sharded",
    "ring_similarity",
]
