from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame, make_icp_frame, icp_track

__all__ = ["IcpFrame", "make_icp_frame", "icp_track"]
