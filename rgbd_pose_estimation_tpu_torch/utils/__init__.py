from rgbd_pose_estimation_tpu_torch.utils.config import (
    RansacConfig,
    IcpConfig,
    PoseGraphConfig,
    BAConfig,
    MeshConfig,
    PipelineConfig,
    load_yaml_config,
)

__all__ = [
    "RansacConfig",
    "IcpConfig",
    "PoseGraphConfig",
    "BAConfig",
    "MeshConfig",
    "PipelineConfig",
    "load_yaml_config",
]
