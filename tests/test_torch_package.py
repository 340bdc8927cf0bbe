"""The PyTorch port as a package: it imports without JAX, its configs equal
the JAX package's, and its converters round-trip."""

import dataclasses
import pathlib
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
assert len(names) >= 16, names
for banned in ("jax", "jaxlib", "rgbd_pose_estimation_tpu", "triton"):
    assert banned not in sys.modules, banned
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
print("ok", len(names))
"""


def test_imports_without_jax_or_triton():
    """A fresh interpreter imports the port and every sub-module; neither
    JAX, nor the JAX package, nor triton is loaded by that, and no kernel
    is built (there is no compiler here to build one)."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE],
        cwd=_REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


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
    assert all(v == 0 for v in _build.launch_counts().values())
