"""PROSAC progressive sampling (Chum & Matas 2005), batch-first.

Counterpart of the JAX package's ``ransac/prosac.py``. All K hypotheses are
drawn at once, so the PROSAC growth schedule becomes a *per-hypothesis
window size* n_k (computed once on the host from the standard growth
function and cached, with the device tensor cached beside it), and the draw
itself is sequential-shift sampling without replacement over each window,
fully vectorized over K.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def prosac_windows(n: int, k: int, m: int) -> tuple:
    """Window size n_t for each of k hypotheses over n sorted matches.

    Standard PROSAC growth function: T_n' ≈ expected number of samples drawn
    entirely from the top n, via the recurrence T_{n+1} = T_n (n+1)/(n+1-m).
    Hypothesis t uses the smallest window whose T'_n exceeds t. Cached per
    (n, k, m); a Python loop over k on the host, so call it (or
    :func:`sample_minimal_sets` once) before any timed region.
    """
    if n <= m:
        return tuple([n] * k)
    t_n = float(k)
    for i in range(m):
        t_n *= (m - i) / (n - i)  # T_m = k * C(m,m)/C(n,m) ... iteratively
    windows = np.empty(k, np.int32)
    n_cur = m
    t_cur = t_n  # T'_{n_cur}
    t_next = t_cur
    for t in range(k):
        while t + 1 > t_next and n_cur < n:
            # growth: T_{n+1} = T_n * (n+1)/(n+1-m)
            t_next = t_next * (n_cur + 1) / (n_cur + 1 - m)
            n_cur += 1
        windows[t] = n_cur
    return tuple(int(x) for x in windows)


@functools.lru_cache(maxsize=16)
def _windows_tensor(n: int, k: int, m: int, prosac: bool, device: str) -> torch.Tensor:
    """The (k,) int32 window sizes as a tensor that stays on ``device``:
    turning the 32768-entry tuple into a tensor costs more than the whole
    draw, so it is done once per (n, k, m, device). Read-only by contract."""
    if prosac:
        win = np.asarray(prosac_windows(n, k, m), np.int32)
    else:
        win = np.full((k,), n, np.int32)
    return torch.from_numpy(win).to(device)


def shifted_draw(u: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Sequential-shift sampling without replacement from given uniforms.

    ``u`` is ``(K, m)`` f32 uniforms in [0, 1), ``win`` the ``(K,)`` int32
    window sizes. Draw r_j uniform in [0, w-j) and shift it past each
    previously-drawn index: exactly uniform over distinct m-subsets of each
    window. A pure function of its arguments, so that the same uniforms
    give the same ``(K, m)`` int32 indices as the JAX package's sampler.
    """
    w = win.to(u.dtype)
    cols = []
    for j in range(u.shape[1]):
        r = torch.floor(u[:, j] * torch.clamp(w - j, min=1.0)).to(torch.int32)
        r = torch.minimum(r, torch.clamp(win - j - 1, min=0))
        # Shift past previously drawn indices, in ascending order: each
        # previous index ≤ the running value bumps it by one.
        if cols:
            prev = torch.sort(torch.stack(cols, dim=-1), dim=-1).values
            for jj in range(j):
                r = r + (prev[:, jj] <= r).to(torch.int32)
        cols.append(r)
    return torch.stack(cols, dim=-1)


def sample_minimal_sets(
    generator: torch.Generator,
    num_corr: int,
    num_hypotheses: int,
    sample_size: int,
    prosac: bool = True,
    method: str = "shifted",
    device="cuda",
) -> torch.Tensor:
    """Draw ``(K, m)`` distinct correspondence indices (int32) for K hypotheses.

    ``generator`` must live on ``device``. ``method="shifted"`` (default,
    O(K·m²)): see :func:`shifted_draw`. ``method="gumbel"`` (O(K·N log N)):
    i.i.d. Gumbel noise per (hypothesis, correspondence), windows masked to
    -inf, ``topk`` picks m winners — kept as the oracle for the sampler's
    distribution test.
    """
    device = torch.device(device)
    win = _windows_tensor(
        num_corr, num_hypotheses, sample_size, bool(prosac), str(device)
    )
    if method == "gumbel":
        u = torch.rand(
            (num_hypotheses, num_corr), generator=generator, device=device
        )
        g = -torch.log(-torch.log(u * (1.0 - 2e-7) + 1e-7))
        col = torch.arange(num_corr, device=device)[None, :]
        g = torch.where(col < win[:, None], g, float("-inf"))
        return torch.topk(g, sample_size, dim=-1).indices.to(torch.int32)
    if method != "shifted":
        raise ValueError(f"unknown sampling method {method!r}")
    u = torch.rand(
        (num_hypotheses, sample_size), generator=generator, device=device
    )
    return shifted_draw(u, win)
