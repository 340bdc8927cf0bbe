from rgbd_pose_estimation_tpu_torch.graph.pose_graph import (
    optimize_pose_graph,
    detect_loop_closures,
    optimize_trajectory,
)

__all__ = ["optimize_pose_graph", "detect_loop_closures", "optimize_trajectory"]
