"""rgbd_pose_estimation_tpu_torch — the PyTorch/CUDA port of the RGB-D pose engine.

A second package beside ``rgbd_pose_estimation_tpu`` (the JAX reference),
with the same sub-package and module names so the counterpart of every
function is found at once. It imports ``torch``, ``numpy`` and the standard
library only: never ``jax``, and nothing of the JAX package.

Ported so far (the RANSAC frame-pair estimators — 3D-3D, 2D-3D through
P3P, point+normal — with the feature front-end and the frame-pair model;
dense projective ICP with the dense odometry server; loop closure, the
keyframe pose graph, bundle adjustment and the SLAM model; the TUM and
ICL-NUIM readers; trajectory evaluation):

- ``core``     — SO(3)/SE(3) exponentials and logarithms, composition,
                 inverse, apply, adjoint, quaternions; the pinhole camera;
                 masked closed-form cubic and quartic roots.
- ``solvers``  — 3D-3D absolute orientation (Kabsch/Umeyama/Horn), P3P,
                 N-point PnP (DLT and Gauss-Newton refinement), the
                 point+normal minimal solvers.
- ``ransac``   — PROSAC sampling, ``estimate_pose_3d3d`` and
                 ``estimate_pose_2d3d`` (+ adaptive), and
                 ``estimate_pose_3d3d_normals``.
- ``features`` — FAST-9 + rotated-BRIEF detection on the device
                 (``tpu_detect``), host OpenCV ORB (``cv2`` imported only
                 when called), Hamming matching on the device, and the host
                 steps from matches to correspondences (``frontend``).
- ``icp``      — ``make_icp_frame``, ``icp_track`` (coarse-to-fine
                 point-to-plane ICP, nearest or bilinear association,
                 strides, re-association schedule, photometric rows) and
                 ``icp_track_batch``.
- ``graph``    — SE(3) pose-graph Gauss-Newton (dense Cholesky or
                 block-Jacobi PCG), loop candidates and their ICP
                 verification, the corrected trajectory.
- ``ba``       — the BA problem from keyframes (features, batched matching,
                 union-find tracks), the matrix-free Schur-complement
                 Gauss-Newton step with CG, its sums in a fixed order, and
                 the landmark clustering of the blocked layout.
- ``models``   — ``FramePairEstimator`` (configurations 1-2),
                 ``DenseOdometry`` (frame-to-keyframe; ``process`` and the
                 pipelined ``process_stream``) and ``Slam`` (odometry → loop
                 closure → pose graph → bundle adjustment).
- ``eval``     — ATE after Umeyama alignment, RPE, TUM trajectory files and
                 timestamp association, the metrics summary.
- ``ops``      — the hand-written CUDA kernels (minimal-set moments, fused
                 quad-form MSAC ranking, exact 3D-3D MSAC scoring, 2D-3D
                 reprojection MSAC scoring, the ICP normal equations), each
                 beside its plain PyTorch version.
- ``data``     — depth-image geometry (vertex/normal maps, pyramids,
                 sampling), synthetic correspondence problems and
                 analytically raycast RGB-D sequences; TUM and ICL-NUIM
                 directories (read and written), PNG decode (the native
                 library or a standard-library codec), the prefetcher.
- ``parallel`` — the distributed layer on ``torch.distributed``: meshes as
                 process groups (one rank a device), layouts, the sharded
                 RANSAC/ICP/BA steps, the all-to-all observation relayout,
                 the ring similarity, the multi-rank dry run.
- ``utils``    — configs, the metrics logger, phase timers, checkpoints and
                 the converters that carry configuration, inputs, state and
                 results between the two packages.

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
