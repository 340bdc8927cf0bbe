"""rgbd_pose_estimation_tpu_torch — the PyTorch/CUDA port of the RGB-D pose engine.

A second package beside ``rgbd_pose_estimation_tpu`` (the JAX reference),
with the same sub-package and module names so the counterpart of every
function is found at once. It imports ``torch``, ``numpy`` and the standard
library only: never ``jax``, and nothing of the JAX package.

Ported so far (the 3D-3D RANSAC frame-pair estimator):

- ``core``    — SO(3)/SE(3) exponentials, composition, inverse, apply.
- ``solvers`` — 3D-3D absolute orientation (Kabsch/Umeyama/Horn).
- ``ransac``  — PROSAC sampling and ``estimate_pose_3d3d`` (+ adaptive).
- ``ops``     — the hand-written CUDA kernels (minimal-set moments, fused
                quad-form MSAC ranking, exact MSAC scoring), each beside
                its plain PyTorch version.
- ``data``    — synthetic 3D-3D correspondence problems.
- ``utils``   — configs and the converters that carry configuration,
                inputs and results between the two packages.

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
