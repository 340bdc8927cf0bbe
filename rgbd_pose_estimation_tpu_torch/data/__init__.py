from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_correspondences

__all__ = ["synthetic_correspondences"]
