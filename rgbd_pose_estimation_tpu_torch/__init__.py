"""rgbd_pose_estimation_tpu_torch — the PyTorch/CUDA port of the RGB-D pose engine.

A second package beside ``rgbd_pose_estimation_tpu`` (the JAX reference),
with the same sub-package and module names so the counterpart of every
function is found at once. It imports ``torch``, ``numpy`` and the standard
library only: never ``jax``, and nothing of the JAX package.

Ported so far (the RANSAC frame-pair estimators — 3D-3D, 2D-3D through
P3P, point+normal — and dense projective ICP with the dense odometry
server):

- ``core``    — SO(3)/SE(3) exponentials and logarithms, composition,
                inverse, apply, adjoint, quaternions; the pinhole camera;
                masked closed-form cubic and quartic roots.
- ``solvers`` — 3D-3D absolute orientation (Kabsch/Umeyama/Horn), P3P,
                N-point PnP (DLT and Gauss-Newton refinement), the
                point+normal minimal solvers.
- ``ransac``  — PROSAC sampling, ``estimate_pose_3d3d`` and
                ``estimate_pose_2d3d`` (+ adaptive), and
                ``estimate_pose_3d3d_normals``.
- ``icp``     — ``make_icp_frame`` and ``icp_track`` (coarse-to-fine
                point-to-plane ICP, nearest or bilinear association,
                strides, re-association schedule, photometric rows).
- ``models``  — ``DenseOdometry`` (frame-to-keyframe; ``process`` and the
                pipelined ``process_stream``).
- ``ops``     — the hand-written CUDA kernels (minimal-set moments, fused
                quad-form MSAC ranking, exact 3D-3D MSAC scoring, 2D-3D
                reprojection MSAC scoring, the ICP normal equations), each
                beside its plain PyTorch version.
- ``data``    — depth-image geometry (vertex/normal maps, pyramids,
                sampling), synthetic correspondence problems and
                analytically raycast RGB-D sequences.
- ``utils``   — configs, the metrics logger and the converters that carry
                configuration, inputs, state and results between the two
                packages.

Design rules:

- plain functions on tensors; every function that creates a tensor takes an
  explicit ``device``, every function that draws random numbers takes an
  explicit ``torch.Generator``;
- a kernel wrapper launches its CUDA kernel for CUDA tensors (or raises)
  and runs its plain version for CPU tensors only; nothing is compiled or
  loaded when a module is imported;
- float32 means float32: TF32 matrix products are switched off below, so
  the refit and the plain versions are true f32 on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"
