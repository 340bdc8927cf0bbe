"""Counterpart of the JAX package's ``parallel/mesh.py``: so far only
``partition_bounds``, the one helper ``ba/build.py`` takes from it. The
mesh, the host-axis gathers and the sharded placement come with the
distributed layer."""

from __future__ import annotations

import numpy as np


def partition_bounds(n: int, procs: int) -> np.ndarray:
    """Contiguous n-item → procs-process partition boundaries (len procs+1).

    The span-partition policy for process-sharded pipeline stages:
    contiguous (not round-robin), so each process's I/O window is one span.
    """
    return np.linspace(0, n, procs + 1).round().astype(int)
