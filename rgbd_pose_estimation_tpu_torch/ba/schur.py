"""Schur-complement bundle adjustment, matrix-free (configuration 5).

Counterpart of the JAX package's ``ba/schur.py``:

- the reduced camera system  S = U − W V⁻¹ Wᵀ  is never materialised: each
  CG matvec is a camera-side and a landmark-side reduction over the
  observations plus a batched 3×3 product;
- the per-landmark 3×3 blocks V are inverted in closed form (the adjugate
  over the determinant, which checks nothing on the host);
- CG on the reduced system runs ``cfg.cg_iters`` iterations as a Python
  loop whose step sizes stay on the device (the reference's ``lax.scan``),
  with the reference's ``max(…, 1e-20)`` guards;
- gauge: camera 0 is frozen (its update masked to zero).

Nothing in :func:`ba_step` reads a value back to the host, and no sum in it
depends on the order in which threads finish: the reference's
``segment_sum``s and ``.at[].add``s would be float atomics on the card
(``index_add_``/``scatter_add_``), whose order, and so whose last bits,
change from run to run. Instead

- the camera- and landmark-side reductions go through slot tables
  (:func:`make_reduction_slots`, built on the host once before the loop by
  :func:`reduction_slots`): a gather of each segment's padded rows, then a
  sum over a fixed axis;
- a side without a table, and the odometry priors' few edges, are summed as
  products with the one-hot incidence matrix (built on the device by a
  comparison, as the port's pose graph does; O(segments × rows) memory, so
  meant for small problems).

This deviates from the reference only in the order of f32 summation. The
small contractions (2×6, 3×3, 6×6 against a vector) are written as
elementwise products and sums: no TF32 can enter them.

The same ``ba_step`` body runs on every rank of a mesh with its block of
the observations (``parallel/sharded.py``): the ``psum=`` and ``psum_lm=``
hooks complete each camera- and landmark-indexed sum (and the cost) across
the ranks, and under the landmark-blocked layout of ``ba/cluster.py``
``psum_lm`` is the identity. Both default to the identity, which leaves the
single-device step as it is.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.lie import (
    se3_adjoint,
    se3_exp,
    se3_inverse,
    se3_log,
)
from rgbd_pose_estimation_tpu_torch.utils.config import BAConfig


class BAProblem(typing.NamedTuple):
    poses: torch.Tensor  # (C, 4, 4) world→camera
    points: torch.Tensor  # (L, 3) world landmarks
    cam_idx: torch.Tensor  # (O,) int camera of each observation
    lm_idx: torch.Tensor  # (O,) int landmark of each observation
    obs: torch.Tensor  # (O, 2) normalized-plane observations
    w: torch.Tensor  # (O,) observation weights (0 = padding)
    # (O,) measured depth (m); 0 or negative = RGB-only. The depth residual
    # removes the scale gauge that a pure reprojection BA leaves free.
    obs_z: torch.Tensor = None
    # Relative-pose priors (odometry fusion): w·‖log(T_meas⁻¹ T_i T_j⁻¹)‖²
    # terms coupling camera pairs, so that a weak feature problem refines
    # the odometry's poses instead of replacing them.
    prior_i: torch.Tensor = None  # (E,) int camera index i
    prior_j: torch.Tensor = None  # (E,) int camera index j
    prior_T_inv: torch.Tensor = None  # (E, 4, 4) measured (cam j → cam i)⁻¹
    prior_w: torch.Tensor = None  # (E,) information weights


def _residual_jacobians(T, X, cam_idx, lm_idx, obs, obs_z=None, depth_weight=1.0):
    """Per-observation residual + camera/landmark Jacobians.

    Returns r (O,3), Jc (O,3,6), Jl (O,3,3): two reprojection rows plus one
    depth row  dw*(z - obs_z)  that is zeroed for RGB-only observations.
    Camera perturbation is a left twist on T_c; landmark Jacobians chain
    through R_c.
    """
    Tc = T[cam_idx]  # (O, 4, 4)
    Xl = X[lm_idx]  # (O, 3)
    R = Tc[:, :3, :3]
    Xc = (R * Xl[:, None, :]).sum(-1) + Tc[:, :3, 3]
    x, y, z = Xc[:, 0], Xc[:, 1], torch.clamp(Xc[:, 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    if obs_z is None:
        obs_z = torch.zeros_like(z)
    has_z = (obs_z > 0).to(z.dtype) * depth_weight
    rz = has_z * (z - obs_z)
    r = torch.stack([x * iz - obs[:, 0], y * iz - obs[:, 1], rz], dim=-1)

    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    Ju = torch.stack([iz, zero, -x * iz2, -x * y * iz2, 1.0 + x * x * iz2, -y * iz], dim=-1)
    Jv = torch.stack([zero, iz, -y * iz2, -(1.0 + y * y * iz2), x * y * iz2, x * iz], dim=-1)
    # d z / d xi = row 3 of [I | -[Xc]x] = [0, 0, 1, y, -x, 0].
    Jz = has_z[:, None] * torch.stack([zero, zero, one, y, -x, zero], dim=-1)
    Jc = torch.stack([Ju, Jv, Jz], dim=-2)  # (O, 3, 6)

    # d r / d X_world = (d [proj; z] / d Xc) @ R.
    P = torch.stack(
        [
            torch.stack([iz, zero, -x * iz2], dim=-1),
            torch.stack([zero, iz, -y * iz2], dim=-1),
            has_z[:, None] * torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )  # (O, 3, 3)
    Jl = (P[:, :, :, None] * R[:, None, :, :]).sum(2)
    return r, Jc, Jl


def _huber_w(r, delta):
    nrm = torch.linalg.norm(r, dim=-1)
    return torch.where(nrm <= delta, 1.0, delta / torch.clamp(nrm, min=1e-12))


def make_reduction_slots(idx, n: int, max_inflation: float | None = 1.6):
    """Host-side slot table turning a segment sum into a gather + a sum.

    ``slots[i]`` lists the rows of segment ``i`` in ascending order, padded
    with the sentinel ``len(idx)``; the reduction is then
    ``x_padded[slots].sum(1)``. Returns ``None`` when the padded table would
    exceed ``max_inflation`` × O entries, as the reference does (there the
    limit is a TPU trade of scatter against gather); ``max_inflation=None``
    builds the table at any inflation. ``idx`` must be concrete (host).

    The reference fills the table one segment at a time in a Python loop;
    here one sort and one scatter of the row numbers fill it (equal tables).
    """
    idx = np.asarray(idx)
    O = len(idx)
    cnt = np.bincount(idx, minlength=n)
    cap = int(cnt.max()) if O else 1
    if max_inflation is not None and n * cap > max_inflation * max(O, 1):
        return None
    order = np.argsort(idx, kind="stable")
    seg = idx[order]
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    keep = seg < n
    slot = np.full((n, cap), O, np.int32)
    slot[seg[keep], (np.arange(O) - start[seg])[keep]] = order[keep]
    return slot


def reduction_slots(prob: BAProblem):
    """``(cam_slots, lm_slots)`` of ``prob`` on its device: one read of the
    index arrays, before the solve. The tables are built at any inflation:
    where the reference's limit refuses one (and scatters), a gather still
    sums in a fixed order, a scatter-add on the card would not."""
    return tuple(
        torch.from_numpy(
            make_reduction_slots(idx.cpu().numpy(), int(n), max_inflation=None).astype(np.int64)
        ).to(prob.poses.device)
        for idx, n in ((prob.cam_idx, prob.poses.shape[0]), (prob.lm_idx, prob.points.shape[0]))
    )


def _seg_by_slots(x, slots):
    """Segment sum of ``x`` (O, ...) given the slot table of its index."""
    pad = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])[slots].sum(dim=1)


def _incidence(n: int, idx: torch.Tensor, dtype) -> torch.Tensor:
    """(n, O) one-hot: entry [k, o] is 1 where row o belongs to segment k."""
    return (torch.arange(n, device=idx.device)[:, None] == idx[None, :]).to(dtype)


def _seg_by_incidence(x, S):
    """Segment sum of ``x`` (O, ...) as a product with the incidence ``S``."""
    return (S @ x.flatten(1)).reshape((S.shape[0],) + tuple(x.shape[1:]))


def _reducer(idx, n: int, slots, dtype):
    """The segment sum over ``idx`` into ``n`` segments: through the slot
    table where there is one, else through the incidence matrix."""
    if slots is not None:
        return lambda x: _seg_by_slots(x, slots)
    S = _incidence(n, idx, dtype)
    return lambda x: _seg_by_incidence(x, S)


def _identity(x):
    return x


def _outer_sum(a, b):
    """Σ_k a[o, k, i] b[o, k, j] → (O, I, J)."""
    return (a[:, :, :, None] * b[:, :, None, :]).sum(1)


def _matvec(M, v):
    """Σ_j M[o, i, j] v[o, j] → (O, I)."""
    return (M * v[:, None, :]).sum(-1)


def _tmatvec(M, v):
    """Σ_k M[o, k, i] v[o, k] → (O, I)."""
    return (M * v[:, :, None]).sum(1)


def _inv3(V):
    """Batched 3×3 inverse in closed form: the columns of the inverse are
    the rows' cross products over the determinant."""
    a, b, c = V[:, 0], V[:, 1], V[:, 2]
    bc, ca, ab = torch.linalg.cross(b, c), torch.linalg.cross(c, a), torch.linalg.cross(a, b)
    det = (a * bc).sum(-1)
    return torch.stack([bc, ca, ab], dim=-1) / det[:, None, None]


def ba_step(prob: BAProblem, cfg: BAConfig, cam_slots=None, lm_slots=None,
            psum=None, psum_lm=None):
    """One damped GN step with Schur elimination + matrix-free CG.

    ``cam_slots``/``lm_slots``: :func:`make_reduction_slots` tables of the
    camera and landmark indices (:func:`reduction_slots` builds both); a side
    without one reduces through its incidence matrix. Returns
    ``(problem with updated poses and points, cost before the step)``.

    ``psum``: applied after every camera-indexed sum and the cost — the
    identity on one device, a sum over the ranks of a mesh when the
    observations are split over them. ``psum_lm``: the same for the
    landmark-indexed sums; defaults to ``psum`` (landmarks replicated), the
    identity under the landmark-blocked layout, where every landmark's
    observations live on its own rank. The odometry priors are added after
    these sums: their inputs are replicated, so every rank adds the same.
    """
    if psum is None:
        psum = _identity
    if psum_lm is None:
        psum_lm = psum
    T, X = prob.poses, prob.points
    C, L = T.shape[0], X.shape[0]
    dt, dev = T.dtype, T.device
    lam = cfg.damping

    r, Jc, Jl = _residual_jacobians(
        T, X, prob.cam_idx, prob.lm_idx, prob.obs, prob.obs_z, cfg.depth_weight
    )
    w = prob.w * _huber_w(r, cfg.huber_delta)
    cost = psum(torch.sum(w * torch.sum(r * r, dim=-1)))

    wJc = Jc * w[:, None, None]
    wJl = Jl * w[:, None, None]

    red_cam = _reducer(prob.cam_idx, C, cam_slots, dt)  # (O, ...) → (C, ...)
    red_lm = _reducer(prob.lm_idx, L, lm_slots, dt)  # (O, ...) → (L, ...)

    def seg_cam(x):
        return psum(red_cam(x))

    def seg_lm(x):
        return psum_lm(red_lm(x))

    U = seg_cam(_outer_sum(wJc, Jc))  # (C, 6, 6)
    V = seg_lm(_outer_sum(wJl, Jl))  # (L, 3, 3)
    bc = -seg_cam(_tmatvec(wJc, r))  # (C, 6)
    bl = -seg_lm(_tmatvec(wJl, r))  # (L, 3)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    U = U + lam * eye6
    V = V + lam * torch.eye(3, dtype=dt, device=dev)
    Vinv = _inv3(V)

    # Relative-pose odometry priors (see BAProblem). Left-perturbation
    # Jacobians of r = log(Tm⁻¹ T_i T_j⁻¹): J_i = Ad(Tm⁻¹), J_j = −I
    # (small-residual approximation). Summed into the cameras through the
    # edges' incidence matrices, after the sums over the ranks: the prior
    # inputs are replicated, so every rank adds the same terms.
    prior_cross = None
    if prob.prior_i is not None:
        pi, pj, wp = prob.prior_i, prob.prior_j, prob.prior_w
        E = pi.shape[0]
        Si, Sj = _incidence(C, pi, dt), _incidence(C, pj, dt)
        Ai = se3_adjoint(prob.prior_T_inv)  # (E, 6, 6)
        r_p = se3_log(prob.prior_T_inv @ T[pi] @ se3_inverse(T[pj]))
        cost = cost + torch.sum(wp * torch.sum(r_p * r_p, dim=-1))
        U = U + (Si @ (_outer_sum(Ai, Ai) * wp[:, None, None]).reshape(E, 36)).reshape(C, 6, 6)
        U = U + (Sj @ wp)[:, None, None] * eye6
        bc = bc + Si @ (-_tmatvec(Ai, r_p) * wp[:, None])
        bc = bc + Sj @ (wp[:, None] * r_p)

        def prior_cross(x):  # off-diagonal camera-camera blocks of H
            yi = -_tmatvec(Ai, x[pj]) * wp[:, None]
            yj = -_matvec(Ai, x[pi]) * wp[:, None]
            return Si @ yi + Sj @ yj

    def cam_from_lm(u_l):
        """y_c = Σ_obs Jcᵀ w Jl u_{l(o)}: camera side of a landmark vector."""
        t = _matvec(Jl, u_l[prob.lm_idx])  # (O, 3)
        return seg_cam(_tmatvec(wJc, t))

    def lm_from_cam(x_c):
        """t_l = Σ_obs Jlᵀ w Jc x_{c(o)}: landmark side of a camera vector."""
        t = _matvec(Jc, x_c[prob.cam_idx])  # (O, 3)
        return seg_lm(_tmatvec(wJl, t))

    gauge_mask = (torch.arange(C, device=dev) > 0).to(dt)[:, None]

    def S_matvec(x_c):
        x_c = x_c * gauge_mask
        ux = _matvec(U, x_c)
        u_l = _matvec(Vinv, lm_from_cam(x_c))
        y = ux - cam_from_lm(u_l)
        if prior_cross is not None:
            y = y + prior_cross(x_c)
        return y * gauge_mask

    rhs = (bc - cam_from_lm(_matvec(Vinv, bl))) * gauge_mask

    # Fixed-iteration CG on the reduced camera system; alpha and beta stay
    # on the device.
    x, rr, p = torch.zeros_like(rhs), rhs, rhs
    for _ in range(cfg.cg_iters):
        Ap = S_matvec(p)
        rr_dot = torch.sum(rr * rr)
        alpha = rr_dot / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        rr_new = rr - alpha * Ap
        beta = torch.sum(rr_new * rr_new) / torch.clamp(rr_dot, min=1e-20)
        p = rr_new + beta * p
        rr = rr_new
    dx_c = x * gauge_mask

    # Back-substitute the landmark updates.
    dl = _matvec(Vinv, bl - lm_from_cam(dx_c))

    T_new = se3_exp(dx_c) @ T
    X_new = X + dl
    return prob._replace(poses=T_new, points=X_new), cost


def ba_solve(prob: BAProblem, cfg: BAConfig = BAConfig(), slots: bool = True):
    """Run ``cfg.outer_iters`` damped GN steps; returns ``(problem, costs)``
    with ``costs`` the (outer_iters,) cost before each step, on the device.

    ``slots=True`` (default) builds the reduction tables once, on the host,
    before the first step (:func:`reduction_slots`); ``slots=False`` reduces
    through incidence matrices, for small problems.
    """
    cam_slots = lm_slots = None
    if slots:
        cam_slots, lm_slots = reduction_slots(prob)
    costs = []
    for _ in range(cfg.outer_iters):
        prob, cost = ba_step(prob, cfg, cam_slots=cam_slots, lm_slots=lm_slots)
        costs.append(cost)
    if not costs:
        return prob, torch.zeros(0, dtype=prob.poses.dtype, device=prob.poses.device)
    return prob, torch.stack(costs)


def with_odometry_priors(prob: BAProblem, weight: float, edges=None) -> BAProblem:
    """Attach relative-pose priors measured from the problem's CURRENT poses
    (call before stepping: the initialisation is the odometry/pose-graph
    estimate being trusted). ``edges`` defaults to consecutive camera pairs;
    pass extras (e.g. verified loop pairs) to trust those relative
    transforms too."""
    C = int(prob.poses.shape[0])
    dev = prob.poses.device
    if edges is None:
        pi = torch.arange(C - 1, dtype=torch.int32, device=dev)
        pj = torch.arange(1, C, dtype=torch.int32, device=dev)
    else:
        edges = list(edges)
        if not edges:
            return prob
        pi = torch.tensor([a for a, _ in edges], dtype=torch.int32).to(dev)
        pj = torch.tensor([b for _, b in edges], dtype=torch.int32).to(dev)
    if pi.numel() == 0:
        return prob
    Tm = prob.poses[pi] @ se3_inverse(prob.poses[pj])
    return prob._replace(
        prior_i=pi,
        prior_j=pj,
        prior_T_inv=se3_inverse(Tm),
        prior_w=torch.full((pi.shape[0],), weight, dtype=prob.poses.dtype, device=dev),
    )


def prune_observations(prob: BAProblem, max_residual: float, depth_weight=1.0) -> BAProblem:
    """Zero the weight of observations with residual norm beyond a bound.

    Wrong feature matches survive track building as high-residual
    observations; left in, they drag BA away from a good initialisation.
    Callers run a few damped steps, prune, then continue (models/slam.py).
    """
    r, _, _ = _residual_jacobians(
        prob.poses, prob.points, prob.cam_idx, prob.lm_idx, prob.obs,
        prob.obs_z, depth_weight,
    )
    keep = torch.linalg.norm(r, dim=-1) <= max_residual
    return prob._replace(w=torch.where(keep, prob.w, 0.0))


def reprojection_rmse(prob: BAProblem) -> torch.Tensor:
    """Reprojection-only RMSE (depth rows excluded) over weighted obs; a
    0-dim tensor on the problem's device."""
    r, _, _ = _residual_jacobians(
        prob.poses, prob.points, prob.cam_idx, prob.lm_idx, prob.obs
    )
    r = r[:, :2]
    m = prob.w > 0
    return torch.sqrt(
        torch.sum(torch.where(m, torch.sum(r * r, dim=-1), 0.0)) / torch.clamp(m.sum(), min=1)
    )


def make_synthetic_ba_problem(
    generator: torch.Generator | None,
    num_cameras: int = 8,
    num_points: int = 200,
    obs_per_point: int = 4,
    pixel_noise: float = 0.001,
    pose_noise: float = 0.01,
    point_noise: float = 0.02,
    draws: dict | None = None,
    device="cuda",
):
    """Random BA problem with known ground truth + perturbed initialisation.

    Returns ``(problem_with_noisy_init, gt_poses, gt_points)``. Observations
    are exact projections of the ground truth plus ``pixel_noise``. The
    random numbers come from ``generator`` (on ``device``), or from
    ``draws``, a dict of the reference's draws: ``xi`` (C, 6) and ``dxi``
    (C, 6) standard normals, ``X`` (L, 3) uniform in [-1.5, 1.5),
    ``cam_idx`` (L·obs_per_point,) ints in [0, C), ``obs_noise`` (O, 2),
    ``z_noise`` (O,) and ``X_noise`` (L, 3) standard normals.
    """
    C, L = num_cameras, num_points
    O = L * obs_per_point
    f32 = dict(dtype=torch.float32, device=device)
    if draws is None:
        g = generator
        draws = {
            "xi": torch.randn((C, 6), generator=g, **f32),
            "X": torch.rand((L, 3), generator=g, **f32) * 3.0 - 1.5,
            "cam_idx": torch.randint(0, C, (O,), generator=g, device=device),
            "obs_noise": torch.randn((O, 2), generator=g, **f32),
            "z_noise": torch.randn((O,), generator=g, **f32),
            "dxi": torch.randn((C, 6), generator=g, **f32),
            "X_noise": torch.randn((L, 3), generator=g, **f32),
        }
    else:
        draws = {k: torch.from_numpy(np.array(v)).to(device) for k, v in draws.items()}
    # Cameras along a gentle arc looking at the landmark cloud.
    xi = draws["xi"] * 0.1
    xi[:, 0] += torch.linspace(-0.5, 0.5, C, **f32)
    T_gt = se3_exp(xi)
    T_gt[:, 2, 3] += 3.0
    X_gt = draws["X"]

    cam_idx = draws["cam_idx"].reshape(-1).to(torch.int32)
    lm_idx = torch.arange(L, dtype=torch.int32, device=device).repeat_interleave(obs_per_point)
    Tc = T_gt[cam_idx]
    Xc = (Tc[:, :3, :3] * X_gt[lm_idx][:, None, :]).sum(-1) + Tc[:, :3, 3]
    z = torch.clamp(Xc[:, 2], min=1e-3)
    obs = Xc[:, :2] / z[:, None] + pixel_noise * draws["obs_noise"]
    obs_z = Xc[:, 2] + pixel_noise * 2.0 * draws["z_noise"]
    w = (Xc[:, 2] > 0.2).to(torch.float32)

    # Perturbed initialisation (what odometry would hand BA).
    dxi = draws["dxi"] * pose_noise
    dxi[0] = 0.0  # gauge camera stays
    T0 = se3_exp(dxi) @ T_gt
    X0 = X_gt + draws["X_noise"] * point_noise
    prob = BAProblem(
        poses=T0, points=X0, cam_idx=cam_idx, lm_idx=lm_idx, obs=obs, w=w,
        obs_z=obs_z,
    )
    return prob, T_gt, X_gt
