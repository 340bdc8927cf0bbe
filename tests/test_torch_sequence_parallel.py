"""models/sequence_parallel.py of the PyTorch port against the JAX package's,
on the CPU, and the kernel loader's lock and counters under host threads.

The stitch is held against the reference with one injected chunk runner
that hands both packages the same chunk poses (a known trajectory, each
chunk in its own frame and perturbed); the default runner (dense ICP on
80x60 frames) runs the chunks in threads and one after another, with the
same result; a mesh of one rank gives the result of no mesh.
``ops/_build.py`` is driven with a stub library from 8 threads: one build,
every launch counted.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import pathlib
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.models import sequence_parallel as jsp
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence
from rgbd_pose_estimation_tpu_torch.models import sequence_parallel as sp
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig, KeyframeConfig


@pytest.mark.parametrize("n,chunks,overlap", [(10, 2, 3), (64, 4, 3), (7, 3, 0), (5, 8, 2), (100, 7, 5)])
def test_chunk_ranges_and_local_chunks_equal_reference(n, chunks, overlap):
    assert sp.chunk_ranges(n, chunks, overlap) == jsp.chunk_ranges(n, chunks, overlap)
    for procs in (1, 2, 3, 5):
        for pid in range(procs):
            assert sp.local_chunk_indices(chunks, procs, pid) == jsp.local_chunk_indices(chunks, procs, pid)


F, CHUNKS, OVERLAP = 20, 3, 3


def _chunk_runner():
    """A runner over frame indices: chunk poses of a known trajectory, each
    relative to the chunk's first camera and perturbed by its own small
    motions, with every fourth frame a keyframe."""
    rng = np.random.default_rng(5)
    xi = torch.from_numpy(rng.normal(0, 0.02, (F, 6)).astype(np.float32))
    steps = se3_exp(xi).numpy()
    truth = [np.eye(4, dtype=np.float32)]
    for T in steps[1:]:
        truth.append(T @ truth[-1])
    truth = np.stack(truth)
    noise = se3_exp(torch.from_numpy(rng.normal(0, 1e-3, (F, 6)).astype(np.float32))).numpy()

    def runner(frames):
        s = frames[0]
        inv_s = np.linalg.inv(truth[s]).astype(np.float32)
        local = np.stack([noise[(f * 7 + s) % F] @ truth[f] @ inv_s for f in frames])
        local[0] = np.eye(4, dtype=np.float32)
        return local, [k for k in range(len(frames)) if (s + k) % 4 == 0]

    return runner


@pytest.mark.parametrize("parallel", [False, True])
def test_stitch_matches_reference_on_the_same_chunk_poses(parallel):
    runner = _chunk_runner()
    kw = dict(n_chunks=CHUNKS, overlap=OVERLAP, chunk_runner=runner, return_keyframes=True)
    out, kfs = sp.sequence_parallel_odometry(None, list(range(F)), parallel=parallel, device="cpu", **kw)
    stats = {}
    ref, ref_kfs = jsp.sequence_parallel_odometry(None, list(range(F)), parallel=False, stats=stats, **kw)
    assert out.dtype == np.float32 and out.shape == (F, 4, 4)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    assert kfs == ref_kfs == list(range(0, F, 4))
    own_stats = {}
    sp.sequence_parallel_odometry(None, list(range(F)), chunk_runner=runner, n_chunks=CHUNKS,
                                  overlap=OVERLAP, stats=own_stats, device="cpu")
    assert own_stats == stats == {"local_chunks": CHUNKS, "frames_tracked": 20 + 2 * OVERLAP}


def test_default_runner_in_threads_equals_one_after_another():
    """Dense ICP chunks (10 frames at 80x60, 3 chunks) in three host threads
    and one after another: the same trajectory and keyframes, bit for bit."""
    cam = CameraIntrinsics(80.0, 80.0, 39.5, 29.5, 80, 60)
    _, depths, _ = synthetic_sequence(cam, torch.Generator().manual_seed(3), 10, 0.01, device="cpu")
    depths = [d.numpy() for d in depths]
    icp = IcpConfig(levels=2, iters_per_level=(4, 4))
    kw = dict(n_chunks=3, overlap=2, icp_cfg=icp, kf_cfg=KeyframeConfig(max_interval=3),
              return_keyframes=True, device="cpu")
    (par, kf_par), (ser, kf_ser) = (sp.sequence_parallel_odometry(cam, depths, parallel=p, **kw)
                                    for p in (True, False))
    assert np.array_equal(par, ser) and kf_par == kf_ser
    # The first frame is the identity up to the anchor graph's rounding.
    assert np.isfinite(par).all() and np.abs(par[0] - np.eye(4)).max() < 1e-6


@pytest.mark.parametrize("parallel", [False, True])
def test_a_mesh_of_one_rank_equals_no_mesh_bit_for_bit(parallel):
    """``mesh=`` a mesh of one rank (a gloo group of world size 1) tracks
    every chunk in this process with no exchange: the trajectory, keyframes
    and stats of ``mesh=None``, bit for bit; the stitch runs on the mesh's
    device. Two ranks are held in ``test_torch_distributed_slam.py``."""
    import torch.distributed as dist

    from rgbd_pose_estimation_tpu_torch.parallel.mesh import make_mesh

    kw = dict(n_chunks=CHUNKS, overlap=OVERLAP, chunk_runner=_chunk_runner(), return_keyframes=True,
              parallel=parallel)
    stats, stats_mesh = {}, {}
    out, kfs = sp.sequence_parallel_odometry(None, list(range(F)), stats=stats, device="cpu", **kw)
    mesh = make_mesh(device="cpu")
    try:
        got, kfs_mesh = sp.sequence_parallel_odometry(None, list(range(F)), mesh=mesh, stats=stats_mesh,
                                                      **kw)
        assert mesh.comm == {}  # no collective on one rank
    finally:
        dist.destroy_process_group()
    assert np.array_equal(got, out) and kfs_mesh == kfs and stats_mesh == stats


class _StubFunction:
    """A C entry point of the stub library: accepts anything, returns 0."""

    def __call__(self, *args):
        return 0


class _StubLibrary:
    def __getattr__(self, name):
        fn = _StubFunction()
        setattr(self, name, fn)
        return fn


def test_kernel_library_builds_once_and_counts_every_launch_under_threads(monkeypatch):
    """8 threads reach an unbuilt library at once and launch 2,000 times
    each: one build, one load, and every launch counted."""
    builds = []

    def slow_build(verbose=False):
        builds.append(threading.get_ident())
        time.sleep(0.2)  # long enough for every thread to arrive meanwhile
        return pathlib.Path("librgbd_kernels.so")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_stale", lambda path: True)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _StubLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: types.SimpleNamespace(cuda_stream=0))
    _build.reset_launch_counts()
    threads, per_thread = 8, 2000
    start = threading.Barrier(threads)

    def worker():
        start.wait()
        for _ in range(per_thread):
            _build.launch("empty_kernel", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        pool = [threading.Thread(target=worker) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    counts = _build.launch_counts()
    _build.reset_launch_counts()
    assert len(builds) == 1
    assert counts["empty_kernel"] == threads * per_thread
    assert sum(counts.values()) == threads * per_thread
