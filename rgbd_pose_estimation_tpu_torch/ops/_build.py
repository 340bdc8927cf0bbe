"""Builds, loads and launches the package's CUDA kernels.

The sources under ``ops/csrc/`` have a plain C interface (no PyTorch
headers), so ``nvcc`` compiles each in seconds. They are compiled at first
use — never at import — for ``sm_90a``, one ``nvcc`` process per source, all
started together, and linked into one shared library under ``ops/_build/``
(a directory git ignores), which is loaded with ``ctypes``. The library is
rebuilt when any source is newer than it.

:func:`launch` is the only place a kernel is launched: it passes the current
PyTorch stream, raises when the launch is refused, and counts the launch
under the kernel's name, so a run can show which kernels it went through.
A launch recorded into a CUDA graph is counted once, at capture; the graph's
replays are not counted.
There is no fallback: without ``nvcc`` or a card, :func:`launch` raises.

Host threads may launch at once (``models/sequence_parallel.py`` runs its
chunks in threads): the library is built and loaded once, under a lock, by
the first thread that needs it, and every count is taken under a lock, so
that no launch is lost.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_CSRC = pathlib.Path(__file__).parent / "csrc"
_BUILD = pathlib.Path(__file__).parent / "_build"
_LIB_NAME = "librgbd_kernels.so"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point of each kernel -> argument types (the stream comes last).
_SIGNATURES = {
    # idx, p, q, out, K, m, N
    "minimal_moments": [_P, _P, _P, _P, _I, _I, _I, _P],
    # feat, pn, out, K, N, tau2
    "score_poses_3d3d_quad_fused": [_P, _P, _P, _I, _I, _F, _P],
    # poses, p, q, msac, count, K, N, tau2
    "score_poses_3d3d": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    # poses, points, obs, msac, count, K, N, tau2
    "score_poses_2d3d": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    # p, q, n, w, partials, out, ticket, M, blocks
    "icp_jtj_jtr": [_P] * 7 + [_I, _I, _P],
    # src_v, src_n, tgt_v, tgt_n, assoc, partials, out, ticket, H, W, stride,
    # th, tw, blocks, fx, fy, cx, cy, dist2, normal_thr, huber, T, fresh
    "icp_assoc_jtj_jtr": [_P] * 8 + [_I] * 6 + [_F] * 7 + [_P, _I, _P],
    # The measurement harness's kernels (tools/msac_opt.py, tools/roofline.py).
    # K2's first design, on the CUDA cores: feat, pn, out, K, N, tau2
    "quad_fused_cuda_cores": [_P, _P, _P, _I, _I, _F, _P],
    # poses, p, q, msac, count, K, N, tau2, poses_per_thread
    "msac_variant_a": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    # feat, pn, msac, count, K, N, tau2
    "msac_variant_c": [_P, _P, _P, _P, _I, _I, _F, _P],
    # feat, pn, msac, count, K, N, tau2
    "msac_variant_m": [_P, _P, _P, _P, _I, _I, _F, _P],
    # poses, p, q, msac, K, N, tau2, poses_per_thread
    "msac_variant_d": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    # first, count (bits of floats), per_block, blocks: K5's reciprocal vs 1.f / x
    "msac_reciprocal_check": [ctypes.c_uint, ctypes.c_uint, _P, _I, _P],
    # x, cs, out, R, N, reps, tau2
    "msac_op_mix_ceiling": [_P, _P, _P, _I, _I, _I, _F, _P],
    # x, out, n, s, b
    "fma_chain_ceiling": [_P, _P, _I, _F, _F, _P],
    # blocks: a kernel that does nothing, the floor of a launch
    "empty_kernel": [_I, _P],
    # x, out, n: T3's TF32 split by cvt.rna against the bit-level one
    "tf32_split_check": [_P, _P, _I, _P],
}

_lib = None
_lib_lock = threading.Lock()
_launches = {name: 0 for name in _SIGNATURES}
_count_lock = threading.Lock()


def launch_counts() -> dict:
    """Kernel name → launches since the last :func:`reset_launch_counts`."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built, and there is no fallback for CUDA tensors"
    )


def _stale(lib_path: pathlib.Path) -> bool:
    if not lib_path.exists():
        return True
    built = lib_path.stat().st_mtime
    deps = list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh"))
    return any(d.stat().st_mtime > built for d in deps)


def build(verbose: bool = False) -> pathlib.Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library.
    Returns its path. ``verbose`` adds ``-Xptxas -v`` and prints what the
    compiler says (registers, shared memory, spills per kernel)."""
    nvcc = _find_nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    flags = _NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    procs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = _BUILD / (src.stem + ".o")
        cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    objs, failed = [], []
    for cmd, obj, proc in procs:  # wait for every process, even after a failure
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
        elif verbose and out.strip():
            print(out.strip(), flush=True)
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    # Link under a temporary name and rename, so that a reader never sees
    # a half-written library.
    tmp = _BUILD / (_LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    lib_path = _BUILD / _LIB_NAME
    os.replace(tmp, lib_path)
    return lib_path


def library(verbose: bool = False):
    """The loaded kernel library; built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:  # one build and one load, whichever thread comes first
        if _lib is None:
            lib_path = _BUILD / _LIB_NAME
            if _stale(lib_path):
                lib_path = build(verbose)
            lib = ctypes.CDLL(str(lib_path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, "rgbd_" + name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rgbd_error_string.argtypes = [ctypes.c_int]
            lib.rgbd_error_string.restype = ctypes.c_char_p
            lib.rgbd_capture_id.argtypes = [_P]
            lib.rgbd_capture_id.restype = ctypes.c_ulonglong
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on PyTorch's current stream with ``args``
    (tensors' ``data_ptr()``s, ints and floats, in the C function's order).
    Does not synchronise. Raises if the launch is refused."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, "rgbd_" + name)(*args, stream)
    if err != 0:
        msg = lib.rgbd_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    with _count_lock:
        _launches[name] += 1


def capture_id(stream: int) -> int:
    """A number that tells apart the CUDA-graph captures ``stream`` (a
    handle) records into; 0 while it records none."""
    return library().rgbd_capture_id(stream)


def check_cuda_input(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise on a tensor the kernels do not take: they read raw pointers,
    so device, element type, shape and contiguity are checked here.
    ``None`` in ``shape`` matches any extent."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
