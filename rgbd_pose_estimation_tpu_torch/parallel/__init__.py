"""The distributed layer of the port. So far only the span-partition policy
(``mesh.partition_bounds``) that ``ba/build.py`` uses; the rest waits."""

from rgbd_pose_estimation_tpu_torch.parallel.mesh import partition_bounds

__all__ = ["partition_bounds"]
