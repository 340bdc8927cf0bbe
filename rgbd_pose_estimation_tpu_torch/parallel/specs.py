"""The layout of every distributed value (counterpart of the JAX package's
``parallel/specs.py``).

One module owns the layouts, so that they stay greppable and consistent:
``parallel/sharded.py`` and ``ba/cluster.py`` build every input and output
layout from here. In the port a mesh is a process group with one rank a
device, and every collective runs over the whole group, as the reference's
collectives run over every mesh axis. So a layout says only which tensor
axis is split into equal contiguous blocks over the group's ranks (rank r
holds block r), or that every rank holds the whole tensor.

The geometry-native mapping of the reference:

- DP      → RANSAC hypotheses / loop-closure candidate pairs
- TP      → pixel rows of the dense-ICP reduction
- CP ring → keyframe blocks rotated rank to rank for all-pairs similarity
- the all-to-all relayout between the frame-ordered and the
  landmark-blocked observation layouts
  (``parallel/sharded.py::reshard_obs_to_blocks``)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from rgbd_pose_estimation_tpu_torch.ba.schur import BAProblem


@dataclasses.dataclass(frozen=True)
class Spec:
    """``split``: the tensor axis split over the mesh's ranks; ``None``
    means replicated (every rank holds the whole tensor)."""

    split: Optional[int] = None

    @property
    def replicated(self) -> bool:
        return self.split is None


REPLICATED = Spec()
ROWS = Spec(0)


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Layouts over a mesh with these axis names (any shape or naming; the
    names label the mesh, every split runs over all of its ranks)."""

    axes: tuple = ("host", "chip")

    @classmethod
    def for_mesh(cls, mesh) -> "SpecLayout":
        return cls(axes=tuple(mesh.axis_names))

    @property
    def all_axes(self):
        return self.axes

    # --- RANSAC (DP over hypotheses) ---
    def hypotheses(self) -> Spec:
        """K poses split over every rank; correspondences replicated."""
        return ROWS

    def correspondences(self) -> Spec:
        return REPLICATED

    # --- dense ICP (TP over pixel rows) ---
    def pixel_rows(self) -> Spec:
        """``(M, 3)``/``(M,)`` pixel rows split into contiguous blocks (the
        reference splits its ``(10, S, 128)`` TPU packing by 128-row block;
        the port's K4 takes rows)."""
        return ROWS

    # --- BA: observation-split layouts ---
    def observations(self) -> Spec:
        return ROWS

    def cameras(self) -> Spec:  # replicated; the reduced system is summed (C·6 payload)
        return REPLICATED

    def landmarks_replicated(self) -> Spec:
        """The replicated layout: landmarks on every rank, an O(L) sum per
        CG matvec."""
        return REPLICATED

    def landmarks_blocked(self) -> Spec:
        """The blocked layout: landmark blocks rank-local (ba/cluster.py);
        the collective payload per CG matvec does not depend on L."""
        return ROWS

    def ba_problem(self, blocked: bool, has_obs_z: bool, has_prior: bool = False) -> BAProblem:
        """Layouts of a whole ``BAProblem`` under either landmark layout.

        Relative-pose prior edges are camera-sized: replicated, like the
        cameras they couple."""
        obs = self.observations()
        rep = self.cameras()
        return BAProblem(
            poses=rep,
            points=self.landmarks_blocked() if blocked else self.landmarks_replicated(),
            cam_idx=obs,
            lm_idx=obs,
            obs=obs,
            w=obs,
            obs_z=obs if has_obs_z else None,
            prior_i=rep if has_prior else None,
            prior_j=rep if has_prior else None,
            prior_T_inv=rep if has_prior else None,
            prior_w=rep if has_prior else None,
        )

    # --- ring association (CP over keyframe blocks) ---
    def keyframe_blocks(self) -> Spec:
        return ROWS


DEFAULT = SpecLayout()
