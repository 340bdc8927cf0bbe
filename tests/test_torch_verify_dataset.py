"""The port's readiness kit (``tools/verify_dataset.py``) against the JAX
repository's, on the CPU: the same checks with the same statuses, evidence
and exit code on a TUM directory, a byteswapped copy of it, a raw ICL-NUIM
directory and an empty one; and the commands it prints run through the
port's CLI.

The TUM fixture is the reference's own (6 frames at 64x48, its writer's
renderer jitted once); the reference's writer and decode check use OpenCV,
so the file is skipped where ``cv2`` is missing. The decode check's evidence
differs by design: the reference holds its native decoder against OpenCV,
the port against its standard-library codec.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import contextlib
import io
import os
import re
import shlex
import shutil

import jax
import numpy as np
import pytest

from rgbd_pose_estimation_tpu.data import synthetic as jsyn
from rgbd_pose_estimation_tpu.data import tum as jtum
from rgbd_pose_estimation_tpu_torch.cli.main import build_parser, main as cli_main
from rgbd_pose_estimation_tpu_torch.data import icl_nuim, native_loader, png
from rgbd_pose_estimation_tpu_torch.tools import verify_dataset as tvd

cv2 = pytest.importorskip("cv2")
import tools.verify_dataset as jvd  # noqa: E402  (imports cv2 when it checks)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The reference's TUM fixture (root ``tests/integration/test_verify_dataset.py``),
    a copy with every depth PNG byteswapped (written by the port's codec), a
    raw ICL-NUIM directory of the port's writer and an empty directory."""
    root = tmp_path_factory.mktemp("verify")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsyn, "synthetic_sequence", jax.jit(jsyn.synthetic_sequence, static_argnums=(0, 2)))
        jtum.write_synthetic_tum(str(root / "fixture"), n_frames=6, size=(64, 48), motion_scale=0.01)
    shutil.copytree(root / "fixture", root / "byteswapped")
    depth_dir = root / "byteswapped" / "depth"
    for name in os.listdir(depth_dir):
        png.write_png(depth_dir / name, png.read_png(depth_dir / name).byteswap())
    icl_nuim.write_synthetic_icl(str(root / "raw_icl"), n_frames=4, size=(64, 48), device="cpu")
    (root / "empty").mkdir()
    return {name: str(root / name) for name in ("fixture", "byteswapped", "raw_icl", "empty")}


def _run(module, root):
    """``module.main(root)``: exit code, the checks it reported, what it printed."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = module.main(root)
    return rc, list(module._RESULTS), out.getvalue()


@pytest.mark.parametrize("name, rc", [("fixture", 0), ("byteswapped", 1), ("raw_icl", 0),
                                      ("empty", 1)])
def test_same_checks_as_reference(dirs, name, rc):
    """The same (status, check) pairs in the same order and the same exit
    code; every check's evidence equal but the decode line's, whose raw
    maximum is equal."""
    got, ref = _run(tvd, dirs[name]), _run(jvd, dirs[name])
    assert got[0] == ref[0] == rc, (got[2], ref[2])
    assert [r[:2] for r in got[1]] == [r[:2] for r in ref[1]]
    for (status, check, msg), (_, _, ref_msg) in zip(got[1], ref[1]):
        if check == "decode" and status == "PASS":
            assert "native==stdlib bit-identical" in msg and "native==cv2" in ref_msg
            assert re.findall(r"max raw \d+", msg) == re.findall(r"max raw \d+", ref_msg)
        else:
            assert msg == ref_msg
    if name == "byteswapped":
        assert ("FAIL", "depth-smooth") in [r[:2] for r in got[1]]
    if name == "fixture":
        assert [r[1] for r in got[1]] == ["layout", "association", "decode", "depth-scale",
                                          "depth-smooth", "intrinsics", "groundtruth"]


def test_decode_without_the_native_library(dirs, monkeypatch):
    """Where libpng cannot be built, decode passes on the stdlib codec alone
    and says so (the reference's "cv2 only")."""
    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    rc, results, _ = _run(tvd, dirs["fixture"])
    [decode] = [r for r in results if r[1] == "decode"]
    assert rc == 0 and decode[0] == "PASS"
    assert "stdlib codec only (native library unavailable)" in decode[2]


def _printed_commands(printed):
    """The commands after the ATE-of-record header, continuation lines joined."""
    text = printed.split("# ATE-of-record commands", 1)[1].split("\n", 1)[1]
    return [shlex.split(c) for c in text.replace("\\\n", " ").splitlines()
            if c.strip() and not c.startswith("#")]


def test_printed_commands_run(dirs, tmp_path, monkeypatch):
    """The port prints the reference's commands with its own CLI module; each
    parses with the port's parser, and ``odom --pose-graph``, ``slam`` and
    ``eval`` of the slam trajectory run in process on the CPU and exit 0."""
    _, _, printed = _run(tvd, dirs["fixture"])
    _, _, ref_printed = _run(jvd, dirs["fixture"])
    cmds, ref_cmds = _printed_commands(printed), _printed_commands(ref_printed)
    module = ["python", "-m", "rgbd_pose_estimation_tpu_torch.cli.main"]
    assert [c[:3] for c in cmds] == [module] * 3
    assert [c[3:] for c in cmds] == [c[3:] for c in ref_cmds]
    assert [c[3] for c in cmds] == ["odom", "slam", "eval"]
    assert "--pose-graph" in cmds[0]
    monkeypatch.chdir(tmp_path)
    for cmd in cmds:
        build_parser().parse_args(cmd[3:])
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli_main(cmd[3:] + ["--cpu"]) == 0, cmd
    for name in ("traj_odom.txt", "traj_slam.txt"):
        assert len(np.loadtxt(tmp_path / name)) == 6
