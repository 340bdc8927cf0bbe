"""The PyTorch port as a package: it imports without JAX, its configs equal
the JAX package's, and its converters round-trip."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import typing

import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.utils import config as jax_config
from rgbd_pose_estimation_tpu_torch.utils import config as torch_config
from rgbd_pose_estimation_tpu_torch.utils.convert import (
    config_from_reference,
    result_to_numpy,
    to_torch,
)

_REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_PROBE = """
import importlib, pkgutil, sys
import rgbd_pose_estimation_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 67, names
for new in ("core.poly", "solvers.p3p", "solvers.pnp", "solvers.normals",
            "ops.msac_variants", "ops.ceilings", "tools.roofline", "tools.msac_opt",
            "features.tpu_detect", "features.frontend", "models.frame_pair", "models.slam",
            "graph.pose_graph", "eval.ate", "eval.traj_io", "eval.report",
            "ba.schur", "ba.build", "data.png", "data.native_loader", "data.tum",
            "data.icl_nuim", "data.prefetch", "utils.checkpoint", "utils.timing",
            "parallel.mesh", "cli.main", "models.sequence_parallel", "parallel.specs",
            "parallel.sharded", "parallel.dryrun", "ba.cluster", "models.distributed_slam",
            "eval.scaling", "parallel.spawn", "entry", "tools.reassoc_exp",
            "tools.photometric_exp", "tools.verify_dataset"):
    assert pkg.__name__ + "." + new in names, new
# "tools" is the JAX repository's harness directory: the port's own tools
# live in its package and import nothing of it. cv2 is imported by host ORB
# detection alone, when it is called.
for banned in ("jax", "jaxlib", "rgbd_pose_estimation_tpu", "triton", "tools", "cv2"):
    assert banned not in sys.modules, banned
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
print("ok", len(names))
"""


def test_imports_without_jax_or_triton():
    """A fresh interpreter imports the port and every sub-module, its
    measurement tools included; neither JAX, nor the JAX package, nor the
    JAX repository's tools, nor triton, nor cv2 is loaded by that, and no
    kernel is built (there is no compiler here to build one)."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE],
        cwd=_REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# Modules of the port with no counterpart in the JAX repository: the
# kernels' build and bindings (ops/horn.py launches the Horn kernels, whose
# work the JAX package leaves to XLA), the stdlib PNG codec, the conversions from the
# reference's types, the port's own measurement tools, the dry run (the
# reference's is in __graft_entry__.py, whose counterpart entry.py re-exports
# it) and the ranks a command starts for itself.
_PORT_ONLY = {
    "data/png.py", "ops/_build.py", "ops/ceilings.py", "ops/horn.py", "ops/msac_variants.py",
    "parallel/dryrun.py",
    "parallel/spawn.py", "tools/__init__.py", "tools/collective_cost.py", "tools/k4_tracks.py",
    "utils/convert.py",
}
# The JAX repository's files outside its package, each with its counterpart
# in the port: __graft_entry__.py (the flagship step and the multi-device dry
# run) and every root tools/*.py.
_ROOT_COUNTERPARTS = {"__graft_entry__.py": "entry.py"} | {
    f"tools/{p.name}": f"tools/{p.name}" for p in (_REPO / "tools").glob("*.py")
}
# Root Python files with no counterpart: the benchmark's one-line JSON waits
# for the benchmark (with BENCHMARK.json); chip_smoke.py is the port's own,
# conftest.py the test suite's.
_NOT_PORTED = {"bench.py"}
_NOT_THE_REFERENCE = {"chip_smoke.py", "conftest.py"}


def _modules(name):
    root = _REPO / name
    return {str(p.relative_to(root)) for p in root.rglob("*.py")}


def test_every_module_of_the_reference_has_its_counterpart():
    """The port has a module of the same path for every module of the JAX
    package, one for every file of the JAX repository outside its package
    (``_ROOT_COUNTERPARTS``), and no other but its own (``_PORT_ONLY``)."""
    reference, port = _modules("rgbd_pose_estimation_tpu"), _modules("rgbd_pose_estimation_tpu_torch")
    outside = set(_ROOT_COUNTERPARTS.values())
    assert reference - port == set()
    assert outside - port == set()
    assert port - reference - outside == _PORT_ONLY


def test_nothing_of_the_jax_repository_is_left_to_port_but_the_benchmark():
    """Every root Python file of the JAX repository and every root
    ``tools/*.py`` is mapped to a counterpart; ``bench.py`` is the one
    exception."""
    root = {p.name for p in _REPO.glob("*.py")} - _NOT_THE_REFERENCE
    assert root - set(_ROOT_COUNTERPARTS) == _NOT_PORTED == {"bench.py"}
    assert {k for k in _ROOT_COUNTERPARTS if k.startswith("tools/")} == {
        "tools/msac_opt.py", "tools/photometric_exp.py", "tools/reassoc_exp.py",
        "tools/roofline.py", "tools/verify_dataset.py",
    }


_CONFIG_NAMES = [
    "RansacConfig", "IcpConfig", "PoseGraphConfig", "BAConfig", "MeshConfig",
    "KeyframeConfig", "FrontendConfig", "PipelineConfig",
]


@pytest.mark.parametrize("name", _CONFIG_NAMES)
def test_config_defaults_equal_reference(name):
    ref = getattr(jax_config, name)()
    own = config_from_reference(ref)
    assert type(own) is getattr(torch_config, name)
    assert own == getattr(torch_config, name)()  # same defaults
    assert dataclasses.asdict(own) == dataclasses.asdict(ref)
    # ... and through the dict form.
    assert config_from_reference(dataclasses.asdict(ref), name) == own


def test_config_non_default_values_carry_over():
    ref = jax_config.RansacConfig(num_hypotheses=512, threshold=0.05, solver="kabsch")
    own = config_from_reference(ref)
    assert (own.num_hypotheses, own.threshold, own.solver) == (512, 0.05, "kabsch")


def test_config_unknown_field_raises():
    d = dataclasses.asdict(jax_config.RansacConfig())
    d["not_a_field"] = 1
    with pytest.raises(ValueError, match="not_a_field"):
        config_from_reference(d, "RansacConfig")
    with pytest.raises(ValueError, match="no config class"):
        config_from_reference({}, "NoSuchConfig")


class _Pair(typing.NamedTuple):
    a: object
    b: object


def test_to_torch_round_trips():
    rng = np.random.default_rng(0)
    tree = {
        "f": rng.normal(size=(5, 3)).astype(np.float32),
        "i": rng.integers(0, 9, size=(4, 3)).astype(np.int32),
        "nt": _Pair(np.array([True, False]), (np.float32(2.5), 7, None)),
    }
    out = to_torch(tree, "cpu")
    assert out["f"].dtype == torch.float32 and out["i"].dtype == torch.int32
    assert out["nt"].a.dtype == torch.bool and isinstance(out["nt"], _Pair)
    assert out["nt"].b[1] == 7 and out["nt"].b[2] is None
    np.testing.assert_array_equal(out["f"].numpy(), tree["f"])
    np.testing.assert_array_equal(out["i"].numpy(), tree["i"])
    # The tensor owns its memory: writing to it leaves the source alone.
    out["f"][0, 0] = 99.0
    assert tree["f"][0, 0] != 99.0


def test_result_to_numpy():
    from rgbd_pose_estimation_tpu_torch.ransac.engine import RansacResult

    res = RansacResult(
        pose=torch.eye(4), inlier_mask=torch.tensor([True, False]),
        num_inliers=torch.tensor(1.0), score=torch.tensor(0.5),
        valid=torch.tensor(True), num_hypotheses=64,
    )
    out = result_to_numpy(res)
    assert set(out) == set(RansacResult._fields)
    assert isinstance(out["pose"], np.ndarray) and out["pose"].shape == (4, 4)
    assert out["inlier_mask"].dtype == np.bool_ and out["num_hypotheses"] == 64


def test_no_compiler_means_raise_not_fallback():
    """Without nvcc the kernel library cannot be built: asking for it raises
    (the wrappers take this path for every CUDA tensor; the plain versions
    serve CPU tensors only)."""
    from rgbd_pose_estimation_tpu_torch.ops import _build

    try:
        _build._find_nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("this machine has nvcc; the no-compiler path cannot be shown")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    # Every kernel's launch goes through the library first, so each raises
    # here before it touches a pointer, and none is counted as launched.
    assert "score_poses_2d3d" in _build._SIGNATURES
    for name in _build._SIGNATURES:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.launch(name)
    assert all(v == 0 for v in _build.launch_counts().values())


def test_metrics_logger_equals_reference(tmp_path, monkeypatch):
    """The port's own copy of utils/metrics.py writes and summarises what
    the original does, given the same clock."""
    from rgbd_pose_estimation_tpu.utils import metrics as jmetrics
    from rgbd_pose_estimation_tpu_torch.utils import metrics as tmetrics

    assert tmetrics.HYPOTHESES_DEFINITION == jmetrics.HYPOTHESES_DEFINITION
    ticks = iter(range(100, 200))
    outs = []
    for mod in (jmetrics, tmetrics):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
        path = tmp_path / (mod.__name__ + ".jsonl")
        log = mod.MetricsLogger(str(path))
        assert log.summary() == {"num_records": 0, "num_frames": 0}
        log.log(frame=0, ms=4.0, keyframe=True)
        log.log(frame=1, ms=6.0, overlap=0.9, hypotheses=2048)
        log.log(note="no frame here")
        log.close()
        log.close()  # closing twice is harmless
        outs.append((path.read_text(), log.summary(), log.records))
    assert outs[0] == outs[1]
    assert [json.loads(x)["t"] for x in outs[1][0].splitlines()] == [1234.5] * 3
    assert outs[1][1]["frames_per_s"] == 200.0 and outs[1][1]["num_frames"] == 2
    assert tmetrics.MetricsLogger().path is None  # in memory only


@pytest.mark.parametrize("name", sorted(p.name for p in (_REPO / "configs").glob("*.yaml")))
def test_yaml_configs_load_equal(name):
    """Every checked-in configuration (config 3, the dense-ICP odometry
    server's, among them) loads to the same values in both packages."""
    ref = jax_config.load_yaml_config(_REPO / "configs" / name)
    own = torch_config.load_yaml_config(_REPO / "configs" / name)
    assert own == config_from_reference(ref)
    assert dataclasses.asdict(own) == dataclasses.asdict(ref)
    if name.startswith("config3"):
        assert own.icp.source_stride == (4, 4, 2) and own.icp.iters_per_level == (3, 4, 6)
        assert own.icp.reassoc_every == 2 and own.icp.downscale == 1
        assert own.keyframe.min_inlier_ratio == 0.65 and own.keyframe.max_interval == 20


def test_every_signature_names_an_entry_point_of_a_source():
    """Nothing compiles here, so this is a check of the text: each kernel in
    ``_SIGNATURES`` is defined once as ``extern "C" int rgbd_<name>(`` in a
    source under ops/csrc/, with as many parameters as the signature says."""
    from rgbd_pose_estimation_tpu_torch.ops import _build

    sources = {p.name: p.read_text() for p in _build._CSRC.glob("*.cu")}
    assert "icp_jtj.cu" in sources and "icp_jtj_jtr" in _build._SIGNATURES
    assert "score2d.cu" in sources and "score_poses_2d3d" in _build._SIGNATURES
    for name, argtypes in _build._SIGNATURES.items():
        found = [
            m for text in sources.values()
            for m in re.finditer(r'extern "C" int rgbd_' + name + r"\(([^)]*)\)", text)
        ]
        assert len(found) == 1, name
        assert len(found[0].group(1).split(",")) == len(argtypes), name
    # The result is summed in a fixed order: no floating-point atomics.
    for name in ("icp_jtj.cu", "score2d.cu"):
        assert "atomicAdd" not in sources[name].split("#include", 1)[1]
    # The 2D-3D scorer keeps NaN (no fminf) and divides in IEEE arithmetic.
    code = sources["score2d.cu"].split("#include", 1)[1]
    assert "fminf" not in code and "__fdividef" not in code
    assert "use_fast_math" not in " ".join(_build._NVCC_FLAGS)


def test_the_track_reads_nothing_back():
    """icp/dense.py has no call that would wait for the device: the one
    read-back of a frame is in the odometry server's ``_resolve``."""
    import inspect

    from rgbd_pose_estimation_tpu_torch.icp import dense

    code = inspect.getsource(dense)
    for banned in (".item(", "float(", ".cpu(", ".numpy(", ".tolist(", "synchronize", "bool("):
        assert banned not in code, banned
    assert "torch.linalg.solve_ex" in code and "torch.linalg.solve(" not in code


def test_icp_converters():
    from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
    from rgbd_pose_estimation_tpu.icp.dense import IcpFrame as JIcpFrame
    from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
    from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame
    from rgbd_pose_estimation_tpu_torch.utils.convert import (
        camera_from_reference,
        icp_frame_from_reference,
        to_numpy,
    )

    cam = camera_from_reference(JCamera(500.0, 501.0, 320.5, 240.5, 640, 480, 0.001))
    assert cam == CameraIntrinsics(500.0, 501.0, 320.5, 240.5, 640, 480, 0.001)
    rng = np.random.default_rng(1)
    levels = tuple(rng.normal(size=(h, w, 3)).astype(np.float32) for h, w in ((6, 8), (3, 4)))
    frame = icp_frame_from_reference(JIcpFrame(vertices=levels, normals=levels[::-1]), "cpu")
    assert isinstance(frame, IcpFrame) and frame.photo == ()
    assert frame.vertices[1].dtype == torch.float32 and frame.vertices[1].shape == (3, 4, 3)
    back = to_numpy(frame)
    assert isinstance(back, IcpFrame)
    np.testing.assert_array_equal(back.normals[0], levels[1])
    assert to_numpy({"a": [torch.ones(2), 3, None]})["a"][1:] == [3, None]
