"""Pinhole camera model: intrinsics, projection, back-projection.

Counterpart of the JAX package's ``core/camera.py`` (TUM defaults: fr1
fx=517.3 fy=516.5 cx=318.6 cy=255.3, depth scale 1/5000 — Sturm et al. 2012).
The intrinsics object is a hashable frozen dataclass of plain Python numbers,
so it can key a cache and its values enter tensor arithmetic as scalars.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    depth_scale: float = 1.0 / 5000.0  # TUM 16-bit PNG depth → meters

    @staticmethod
    def tum_fr1() -> "CameraIntrinsics":
        return CameraIntrinsics(517.3, 516.5, 318.6, 255.3, 640, 480)

    @staticmethod
    def tum_default() -> "CameraIntrinsics":
        # The "factory" Kinect calibration TUM publishes for all sequences.
        return CameraIntrinsics(525.0, 525.0, 319.5, 239.5, 640, 480)

    def scaled(self, factor: float) -> "CameraIntrinsics":
        """Intrinsics of a pyramid level downscaled by ``factor`` (e.g. 0.5)."""
        return CameraIntrinsics(
            self.fx * factor,
            self.fy * factor,
            self.cx * factor,
            self.cy * factor,
            int(self.width * factor),
            int(self.height * factor),
            self.depth_scale,
        )

    def matrix(self, dtype=torch.float32, device="cuda") -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=dtype, device=device,
        )


def project(cam: CameraIntrinsics, points: torch.Tensor):
    """``(..., 3)`` camera-frame points → ``(..., 2)`` pixels + validity mask.

    Points at or behind the camera plane (z <= eps) are flagged invalid; their
    pixel values are still finite (z is clamped) so downstream masked math
    never sees NaN/Inf.
    """
    z = points[..., 2]
    valid = z > 1e-6
    z_safe = torch.clamp(z, min=1e-6)
    u = cam.fx * points[..., 0] / z_safe + cam.cx
    v = cam.fy * points[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1), valid


def backproject(cam: CameraIntrinsics, pixels: torch.Tensor, depth: torch.Tensor):
    """``(..., 2)`` pixels + ``(...,)`` metric depth → ``(..., 3)`` points."""
    x = (pixels[..., 0] - cam.cx) / cam.fx * depth
    y = (pixels[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def pixel_grid(cam: CameraIntrinsics, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``(H, W, 2)`` grid of (u, v) pixel coordinates."""
    u = torch.arange(cam.width, dtype=dtype, device=device)
    v = torch.arange(cam.height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W) each
    return torch.stack([uu, vv], dim=-1)
