from rgbd_pose_estimation_tpu_torch.utils.config import (
    RansacConfig,
    IcpConfig,
    PoseGraphConfig,
    BAConfig,
    MeshConfig,
    KeyframeConfig,
    PipelineConfig,
    load_yaml_config,
)
from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger

__all__ = [
    "RansacConfig",
    "IcpConfig",
    "PoseGraphConfig",
    "BAConfig",
    "MeshConfig",
    "KeyframeConfig",
    "PipelineConfig",
    "load_yaml_config",
    "MetricsLogger",
]
