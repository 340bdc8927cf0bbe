"""ops/ceilings.py and the timing core of tools/roofline.py of the PyTorch
port. The two probes' plain versions (what the wrappers run for CPU
tensors) give exactly the bits of the JAX repository's Pallas kernels, run
by the interpreter; the CUDA kernels T4 and T6 are held against them on the
card by chip_smoke.py. The slope and its resolution guard are driven with a
fake clock."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rgbd_pose_estimation_tpu_torch.ops import _build, ceilings
from rgbd_pose_estimation_tpu_torch.tools import roofline
from tools import msac_opt as jmsac
from tools import roofline as jroofline


def _pallas_op_mix(x, reps):
    """tools/msac_opt.py's T4 kernel, interpreted, on a given (8, N) array."""
    shape = jax.ShapeDtypeStruct(x.shape, jnp.float32)
    spec = pl.BlockSpec(x.shape, memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(functools.partial(jmsac._kernel_E, reps=reps),
                             in_specs=[spec], out_specs=spec, out_shape=shape)(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("kind", ["ones", "normal"])
def test_op_mix_equals_pallas_kernel_exactly(kind):
    """T4 at reps = 4: the same operations, each rounded on its own, in the
    same order, with the same f32(1 + 1e-6 i) constants: the same bits. On
    ones (the tool's input) every residual is ~27, above tau^2; a normal
    input near -0.5 puts some below it, so the count is exercised too."""
    rng = np.random.default_rng(3)
    x = np.ones((8, 128), np.float32) if kind == "ones" else (
        -0.5 + 0.02 * rng.normal(size=(8, 128))).astype(np.float32)
    out = ceilings.msac_op_mix(torch.from_numpy(x), reps=4)
    ref = _pallas_op_mix(x, 4)
    assert out.shape == (8, 128) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    if kind == "normal":
        assert (ref >= 1.0).any() and (ref < 1.0).any()  # both sides of tau^2


def test_fma_chain_equals_pallas_kernel_exactly():
    """T6 on (16, 128) ones: 1 is the chain's fixed point, so the plain
    version and the Pallas kernel both return exactly 1.0."""
    x = jnp.ones((16, 128), jnp.float32)
    spec = pl.BlockSpec((16, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        ref = pl.pallas_call(jroofline._vpu_kernel, grid=(1,), in_specs=[spec], out_specs=spec,
                             out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32))(x)
    out = ceilings.fma_chain(torch.ones((16, 128)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out == 1.0).all()
    assert ceilings.FMA_REPS == jroofline._FMA_REPS


def test_probe_arguments():
    with pytest.raises(ValueError, match="R >= 3"):
        ceilings.msac_op_mix(torch.ones((2, 16)))
    with pytest.raises(ValueError, match="reps"):
        ceilings.msac_op_mix(torch.ones((8, 16)), reps=0)


def test_op_mix_source_keeps_its_contract():
    """Nothing compiles here, so this reads the source: T4 has the harness's
    iteration count compiled in beside a generic instance for any other,
    each operation of the op mix is an intrinsic rounded on its own (no
    operator the compiler could contract), and one thread runs each of the
    R x N elements: no column is computed once and copied."""
    code = (_build._CSRC / "ceilings.cu").read_text().split("#include", 1)[1]
    assert f"constexpr int kOpMixReps = {ceilings.OP_MIX_REPS};" in code
    assert "op_mix_kernel<kOpMixReps><<<" in code and "op_mix_kernel<0><<<" in code
    residual = code.split("op_mix_residual(float c, float px, float py, float pz) {", 1)[1]
    residual = residual.split("\n}", 1)[0]
    counts = {op: residual.count(op) for op in ("__fmul_rn(", "__fadd_rn(", "__fsub_rn(")}
    assert counts == {"__fmul_rn(": 6, "__fadd_rn(": 5, "__fsub_rn(": 3}
    assert not re.search(r"[*+/]|\s-\s", residual)
    assert "if (i >= R * N) return;" in code and "out[i] = __fadd_rn(acc, cnt);" in code
    assert "blocks = (R * N + kOpMixThreads - 1) / kOpMixThreads;" in code
    assert "op_mix_split" not in code and "msac_op_mix_split" not in _build._SIGNATURES


class _FakeClock:
    """run_seconds(n) = a + b·n, recording the n asked for."""

    def __init__(self, a, b):
        self.a, self.b, self.asked = a, b, []

    def __call__(self, n):
        self.asked.append(n)
        return self.a + self.b * n


def test_slope_returns_the_slope():
    clock = _FakeClock(2e-3, 1e-3)
    assert roofline._slope(clock, 4, 36) == pytest.approx(1e-3, rel=1e-12)
    assert clock.asked == [36, 4]  # wide enough at once: one pair of runs


def test_slope_widens_the_window():
    """10 us a step: 32 steps are 0.32 ms, under the 8 ms minimum, so n2
    grows (to about 4 + 8 ms / 10 us, and four times that when rounding
    leaves the difference a hair short) before the slope is taken."""
    clock = _FakeClock(5e-4, 1e-5)
    assert roofline._slope(clock, 4, 36) == pytest.approx(1e-5, rel=1e-9)
    n2 = max(clock.asked)
    assert clock.asked[:2] == [36, 4] and 800 <= n2 <= 4 * 804
    assert clock(n2) - clock(4) >= 8e-3


def test_slope_raises_rather_than_publish_a_negative_time():
    """A clock that runs backwards never clears the floor: after widening
    to max_n2 and the retries, SubResolutionError, never a number."""
    clock = _FakeClock(1.0, -1e-6)
    with pytest.raises(roofline.SubResolutionError, match="sub-resolution"):
        roofline._slope(clock, 4, 36, max_n2=64, retries=2)
    assert max(clock.asked) == 64 * 4  # max_n2 doubled on each of 2 retries
    assert issubclass(roofline.SubResolutionError, RuntimeError)


def test_measurements_need_a_card():
    """No CUDA device: the harness raises; it never times the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        roofline.timeit_chain(lambda x: x, torch.ones(4))
