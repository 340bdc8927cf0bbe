"""Device meshes and multi-process initialisation on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``, the one place that
builds meshes. In JAX one process drives many devices through
``shard_map``; PyTorch's idiom is one rank a device. So here a mesh of n
devices is a process group of n ranks, NCCL for CUDA devices and gloo for
the CPU, and its ``(host, chip)`` shape is ``(hosts, ranks a host)``.

- A 1×1 mesh is a real group of world size 1 (``init_process_group`` with a
  ``HashStore``), so it runs the same collectives as a larger one.
- A mesh of more than one device inside one process (the reference's
  virtual meshes) has no counterpart: here it raises
  ``NotImplementedError``. A command that asks for one (``--mesh-devices``,
  a config mesh, the scaling harness's sizes) starts its own ranks instead
  (``parallel/spawn.py``); their mesh takes the shape the command asked for
  (:func:`set_launch_shape`).
- A backend that cannot start raises; nothing falls back to another.

The collectives map one to one: ``psum`` → ``all_reduce(SUM)``, ``pmax`` /
``pmin`` → ``all_reduce(MAX / MIN)``, a tiled ``all_gather`` →
``all_gather_into_tensor``, ``all_to_all`` → ``all_to_all_single``, a
``ppermute`` ring step → ``batch_isend_irecv``. The reference reduces over
every mesh axis, so every collective here runs over the mesh's whole group.
Each mesh counts its collectives' calls and payload bytes (``Mesh.comm``).

A sharded JAX array has no PyTorch counterpart. A :class:`Shard` keeps the
rank's block of a global tensor, its layout (``parallel/specs.py``) and the
mesh: :func:`put_global` slices the rank's block from a copy identical on
every rank, :func:`put_process_rows` takes each rank's own rows, and
:func:`fetch_global` all-gathers the blocks. Between steps each rank holds
only its share, as in the reference.

Multi-process: :func:`distributed_init` starts the group (one process a
device); :func:`check_config_consistency` compares a config hash across the
ranks at start-up so that divergent configs fail at once instead of
deadlocking a collective later.
"""

from __future__ import annotations

import dataclasses
import hashlib
import socket
import typing
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from rgbd_pose_estimation_tpu_torch.parallel.specs import REPLICATED, Spec
from rgbd_pose_estimation_tpu_torch.utils.config import MeshConfig

_VIRTUAL = (
    "a mesh of more than one device inside one process has no PyTorch "
    "counterpart: run one rank a device (the ba and slam commands and "
    "eval/scaling.py start their own, parallel/spawn.py; or launch them "
    "with distributed_init)"
)

# The (hosts, chips) shape of a group that a command started for itself
# (parallel/spawn.py), set in each of its ranks; None elsewhere.
_launch_shape: Optional[tuple] = None


def set_launch_shape(shape) -> None:
    """Give the meshes of this rank's group the shape its command asked
    for (``parallel/spawn.py`` calls this in each rank it starts)."""
    global _launch_shape
    _launch_shape = None if shape is None else tuple(int(s) for s in shape)


def launch_shape() -> Optional[tuple]:
    """The shape :func:`set_launch_shape` gave, or None."""
    return _launch_shape


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ``(host, chip)`` mesh: the process group of its ranks, this rank's
    device, and counters of the collectives run over it
    (``comm[op] = [calls, bytes]``, the bytes one rank contributes)."""

    group: object
    shape: tuple
    axis_names: tuple
    device: torch.device
    comm: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def reset_comm(self) -> None:
        self.comm.clear()


class Shard(typing.NamedTuple):
    """This rank's block ``local`` of a global tensor of ``shape``, laid
    out by ``spec`` over ``mesh``."""

    local: torch.Tensor
    spec: Spec
    mesh: Mesh
    shape: tuple


# ---------------------------------------------------------------------------
# Collectives over the whole group of a mesh
# ---------------------------------------------------------------------------


# all_gather_into_tensor, under the name newer releases give it.
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _count(mesh: Mesh, op: str, t: torch.Tensor) -> None:
    entry = mesh.comm.setdefault(op, [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


def _all_reduce(mesh: Mesh, x: torch.Tensor, op) -> torch.Tensor:
    y = x.contiguous().clone()  # all_reduce works in place
    _count(mesh, "all_reduce", y)
    dist.all_reduce(y, op=op, group=mesh.group)
    return y


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank, on every rank."""
    return _all_reduce(mesh, x, dist.ReduceOp.SUM)


def pmax(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, x, dist.ReduceOp.MAX)


def pmin(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, x, dist.ReduceOp.MIN)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (same shape everywhere) concatenated along axis 0
    in rank order (the reference's tiled ``all_gather``)."""
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _count(mesh, "all_gather", x)
    _gather_into(out, x, group=mesh.group)
    return out


def all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Block d of ``x`` along axis 0 goes to rank d; block s of the result
    came from rank s (``all_to_all`` with split and concat axis 0)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    _count(mesh, "all_to_all", x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


def _global_rank(mesh: Mesh, r: int) -> int:
    if mesh.group is dist.group.WORLD:
        return r
    return dist.get_global_rank(mesh.group, r)


def ring_shift(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """One ring step: send ``x`` to rank + 1, receive rank − 1's."""
    n, r = mesh.size, mesh.rank
    x = x.contiguous()
    out = torch.empty_like(x)
    _count(mesh, "ring", x)
    ops = [
        dist.P2POp(dist.isend, x, _global_rank(mesh, (r + 1) % n), mesh.group),
        dist.P2POp(dist.irecv, out, _global_rank(mesh, (r - 1) % n), mesh.group),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


# ---------------------------------------------------------------------------
# Groups and meshes
# ---------------------------------------------------------------------------


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _world_group(dev: torch.device, world: int):
    """The default group, started here with world size 1 where no group
    runs yet; its backend must be the device's."""
    if not dist.is_initialized():
        if world != 1:
            raise NotImplementedError(f"a {world}-device mesh without a launched group: {_VIRTUAL}")
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)
    backend = str(dist.get_backend()).lower()
    if _backend(dev) not in backend:
        raise ValueError(
            f"the process group runs {backend}, a mesh on {dev} needs {_backend(dev)}"
        )
    return dist.group.WORLD


def make_mesh(cfg: MeshConfig = MeshConfig(), device="cuda") -> Mesh:
    """A ``(hosts, chips_per_host)`` mesh over the ranks of the launched
    group (each rank holds one device, ``device``). A 1×1 mesh in a process
    without a group starts a group of world size 1 on ``device``."""
    need = cfg.hosts * cfg.chips_per_host
    dev = _device(device)
    group = _world_group(dev, need)
    world = dist.get_world_size(group)
    if world != need:
        raise ValueError(f"a {cfg.hosts} x {cfg.chips_per_host} mesh needs {need} ranks, "
                         f"the group has {world}")
    return Mesh(group, (cfg.hosts, cfg.chips_per_host), (cfg.host_axis, cfg.chip_axis), dev)


def _ranks_by_host(group) -> list:
    """The group's ranks, one list a host, hosts in the order of their
    first rank."""
    names = [None] * dist.get_world_size(group)
    dist.all_gather_object(names, socket.gethostname(), group=group)
    rows: dict = {}
    for rank, name in enumerate(names):
        rows.setdefault(name, []).append(rank)
    return list(rows.values())


def runtime_mesh(cfg: Optional[MeshConfig] = None, mesh_devices: int = 0, device="cuda") -> Mesh:
    """The ``(host, chip)`` mesh of the ACTUAL launch.

    The host axis must match the real communication boundary, so under a
    launched group of more than one rank the mesh is ``(world /
    ranks_a_host, ranks_a_host)``, and a ``cfg`` that describes another
    multi-host shape is a launch error that raises ``ValueError``, as in the
    reference. In the ranks a command started for itself
    (``parallel/spawn.py``) the mesh has the shape the command asked for,
    as the reference's single-process mesh has. A single process gets a 1×1
    mesh; ``mesh_devices > 1`` or a ``cfg`` larger than one device there
    (the reference's virtual meshes) raise ``NotImplementedError``.
    """
    cfg = cfg if cfg is not None else MeshConfig()
    dev = _device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1 and _launch_shape is not None:
        group = _world_group(dev, world)
        if int(np.prod(_launch_shape)) != world:
            raise ValueError(f"a {_launch_shape} mesh on a group of {world} ranks")
        return Mesh(group, _launch_shape, (cfg.host_axis, cfg.chip_axis), dev)
    if world > 1:
        group = _world_group(dev, world)
        rows = _ranks_by_host(group)
        widths = {len(r) for r in rows}
        if len(widths) != 1:
            raise ValueError(f"uneven ranks a host across hosts: {sorted(widths)}")
        width = widths.pop()
        if any(r != list(range(i * width, (i + 1) * width)) for i, r in enumerate(rows)):
            raise ValueError(f"the ranks of a host must be contiguous: {rows}")
        hosts = len(rows)
        if cfg.hosts > 1 and cfg.hosts != hosts:
            raise ValueError(
                f"config mesh.hosts={cfg.hosts} but launched on {hosts} hosts "
                "— the host axis must match the process topology"
            )
        if cfg.hosts > 1 and cfg.chips_per_host != width:
            raise ValueError(
                f"config mesh.chips_per_host={cfg.chips_per_host} but each host runs {width} ranks"
            )
        return Mesh(group, (hosts, width), (cfg.host_axis, cfg.chip_axis), dev)
    if mesh_devices and mesh_devices > 1:
        raise NotImplementedError(f"mesh_devices={mesh_devices}: {_VIRTUAL}")
    if cfg.hosts * cfg.chips_per_host > 1:
        raise NotImplementedError(
            f"the config's mesh ({cfg.hosts} x {cfg.chips_per_host} devices) in one process: {_VIRTUAL}"
        )
    return make_mesh(MeshConfig(host_axis=cfg.host_axis, chip_axis=cfg.chip_axis), dev)


# ---------------------------------------------------------------------------
# Global tensors
# ---------------------------------------------------------------------------


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def block_of(t: torch.Tensor, spec: Spec, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` under ``spec`` over ``n`` ranks."""
    if spec.replicated:
        return t
    ax = spec.split
    if t.shape[ax] % n:
        raise ValueError(f"axis {ax} of length {t.shape[ax]} does not split over {n} ranks")
    k = t.shape[ax] // n
    return t.narrow(ax, rank * k, k).contiguous()


def put_global(mesh: Mesh, spec: Spec, x) -> Shard:
    """A global tensor from ``x``, a full copy identical on every rank: this
    rank keeps its block under ``spec``, on the mesh's device."""
    t = _as_tensor(x)
    local = block_of(t, spec, mesh.rank, mesh.size).to(mesh.device)
    return Shard(local, spec, mesh, tuple(t.shape))


def _tree_map(fn, specs, tree):
    """``fn(spec, leaf)`` over a tuple, NamedTuple or dict; ``None`` leaves
    (absent optional fields) pass through."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, specs[k] if isinstance(specs, dict) else specs, v)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, Shard):
        parts = [_tree_map(fn, s, v) for s, v in
                 zip(specs if isinstance(specs, tuple) else [specs] * len(tree), tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)
    return fn(specs, tree)


def put_global_tree(mesh: Mesh, specs, tree):
    """:func:`put_global` over a tuple/NamedTuple/dict and matching specs."""
    return _tree_map(lambda s, x: put_global(mesh, s, x), specs, tree)


def partition_bounds(n: int, procs: int) -> np.ndarray:
    """Contiguous n-item → procs-process partition boundaries (len procs+1).

    The span-partition policy for process-sharded pipeline stages:
    contiguous (not round-robin), so each process's I/O window is one span.
    Used by the BA detect/match spans (ba/build.py) and anything feeding
    :func:`put_process_rows`.
    """
    return np.linspace(0, n, procs + 1).round().astype(int)


def put_process_rows(mesh: Mesh, spec: Spec, local_rows):
    """A global tensor split along axis 0 where each rank supplies ONLY its
    own contiguous rows (the same count on every rank): the complement of
    :func:`put_global` for stages whose construction is itself split over
    the processes. Accepts a tuple/NamedTuple/dict of tensors."""
    if spec.split != 0:
        raise ValueError(f"put_process_rows splits axis 0, not {spec}")

    def one(_, x):
        t = _as_tensor(x).to(mesh.device)
        return Shard(t, spec, mesh, (mesh.size * t.shape[0],) + tuple(t.shape[1:]))

    return _tree_map(one, spec, local_rows)


def gather_global(x) -> torch.Tensor:
    """The whole of a global tensor on every rank, on the device: a
    replicated shard's own copy, an axis-0-split one all-gathered."""
    if not isinstance(x, Shard):
        return x
    if x.spec.replicated:
        return x.local
    if x.spec.split != 0:
        raise NotImplementedError(
            f"gather_global only gathers axis-0-split tensors (spec={x.spec}): move the "
            "split axis to position 0 first"
        )
    return all_gather(x.mesh, x.local)


def fetch_global(mesh: Mesh, spec: Spec, x) -> np.ndarray:
    """Host numpy copy, on every rank, of a global tensor (a collective for
    a split one: call it on every rank). ``spec`` must be the tensor's."""
    if isinstance(x, Shard):
        if x.spec != spec:
            raise ValueError(f"fetch_global: the tensor is laid out {x.spec}, not {spec}")
        x = gather_global(x)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def allgather_hosts(mesh: Mesh, x) -> np.ndarray:
    """Exchange PER-PROCESS host data: every rank contributes its own ``x``
    (same shape and dtype everywhere) and receives ``(ranks, *x.shape)``
    in rank order. The host-data exchange of process-sharded stages (the
    BA build's detect and match spans)."""
    arr = np.ascontiguousarray(x)
    t = torch.from_numpy(arr.view(np.uint8) if arr.dtype == bool else arr).to(mesh.device)
    out = all_gather(mesh, t.reshape((1,) + tuple(t.shape))).cpu().numpy()
    return out.view(bool) if arr.dtype == bool else out


# ---------------------------------------------------------------------------
# Launch and start-up checks
# ---------------------------------------------------------------------------


def distributed_init(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Start the process group of a multi-process launch (no-op when single
    process). ``coordinator`` is process 0's ``host:port``
    (``tcp://host:port``; a URL with a scheme, e.g. ``file://``, is passed
    as it is; ``None`` reads the ``MASTER_ADDR``/``MASTER_PORT``
    environment). NCCL for a CUDA ``device`` (this process's card is
    ``process_id`` modulo the cards it sees), gloo for the CPU. A group
    already running with this size and rank is kept."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        if dist.get_world_size() != num_processes or dist.get_rank() != process_id:
            raise ValueError(
                f"a group of {dist.get_world_size()} ranks (this one {dist.get_rank()}) runs "
                f"already; asked for {num_processes} (this one {process_id})"
            )
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if coordinator is None:
        init_method = "env://"
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(_backend(dev), init_method=init_method,
                            world_size=num_processes, rank=process_id)


def config_hash(cfg) -> int:
    """Stable 31-bit hash of a (frozen dataclass) config."""
    return int.from_bytes(hashlib.sha256(repr(cfg).encode()).digest()[:4], "big") & 0x7FFFFFFF


def check_config_consistency(mesh: Mesh, cfg) -> bool:
    """True iff every rank holds this config: a MAX and a MIN ``all_reduce``
    of its hash (max == min ⇔ every rank fed the same hash, with no
    overflow a sum of hashes would risk)."""
    h = config_hash(cfg)
    x = torch.tensor([h], dtype=torch.int32).to(mesh.device)
    mx, mn = int(pmax(mesh, x)[0]), int(pmin(mesh, x)[0])
    return mx == mn == h


__all__ = [
    "Mesh", "Shard", "REPLICATED", "psum", "pmax", "pmin", "all_gather", "all_to_all",
    "ring_shift", "make_mesh", "runtime_mesh", "put_global", "put_global_tree",
    "partition_bounds", "put_process_rows", "gather_global", "fetch_global",
    "allgather_hosts", "distributed_init", "config_hash", "check_config_consistency",
    "block_of", "set_launch_shape", "launch_shape",
]
