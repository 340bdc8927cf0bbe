"""Ranks that a command starts for itself: the port's counterpart of the
reference's meshes of several devices inside one process.

JAX drives a mesh of n devices from one process; PyTorch's idiom is one
rank a device (``parallel/mesh.py``). So when a command asks for n > 1
devices and no group of ranks is running (``ba`` or ``slam`` with
``--mesh-devices n`` or a config ``mesh`` beyond one device, the scaling
harness's sizes), it runs itself as n ranks: :func:`run_ranks` starts n
child processes of the same Python, each joins one group through
``distributed_init`` over a ``file://`` store in a temporary directory (no
port to collide on) and calls the same function with the same arguments as
rank r. Then:

- rank 0's standard output and error are the command's (written to this
  process's streams once the ranks have ended);
- a failing rank makes the call raise that rank's exception (its traceback
  as a note), and every other rank is stopped;
- no rank is left running when the call returns or raises.

The group's mesh takes the shape of the reference's single-process branch
(``(1, n)`` for ``--mesh-devices n``, the config's ``(hosts,
chips_per_host)`` otherwise): the children receive it with the call and
``parallel.mesh.runtime_mesh`` builds the mesh with it.

With ``device="cpu"`` the ranks are gloo ranks; on CUDA devices they are
NCCL ranks, one card each, and n ranks need n cards (NCCL does not put two
ranks on one card): :func:`check_devices` raises ``ValueError`` before any
child starts. Nothing falls back to another backend or device.

Library calls do not start ranks: ``make_mesh`` / ``runtime_mesh`` of more
than one device in a process without a group still raise.

    python -m rgbd_pose_estimation_tpu_torch.parallel.spawn <workdir> <rank>

is a child's command line (the call itself is read from ``workdir``).
"""

from __future__ import annotations

import importlib
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Optional

import torch

_ROOT = pathlib.Path(__file__).resolve().parents[2]  # the directory holding the package


def command_mesh_shape(mesh_devices: int, mesh_cfg) -> tuple:
    """The ``(hosts, chips)`` shape a command asks for in one process, as the
    reference's single-process branch makes it: ``(1, n)`` for
    ``--mesh-devices n > 1``, else the config mesh's shape."""
    if mesh_devices and mesh_devices > 1:
        return (1, int(mesh_devices))
    return (int(mesh_cfg.hosts), int(mesh_cfg.chips_per_host))


def group_running() -> bool:
    """Whether this process is a rank of a group of more than one rank."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def check_devices(world: int, device, cap: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless ``world`` ranks fit: one CUDA card each on
    ``cuda``, at most ``cap`` ranks on the CPU where a cap is given (the
    reference's ``--cpu-devices``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards < world:
            raise ValueError(
                f"a mesh of {world} devices needs {world} CUDA devices, one a rank "
                f"(NCCL puts no two ranks on one card); {cards} visible"
            )
    elif cap is not None and world > cap:
        raise ValueError(f"a mesh of {world} devices on {cap} CPU devices (--cpu-devices {cap})")


def run_ranks(target: str, args: tuple, world: int, shape: tuple, device) -> list:
    """Run ``target(*args)`` (``"module:function"``) on ``world`` ranks of a
    new group on ``device``; returns every rank's return value, in rank
    order. See the module docstring for output, failures and clean-up.
    Call :func:`check_devices` first."""
    if world < 2:
        raise ValueError(f"run_ranks starts 2 or more ranks, not {world}")
    if int(shape[0]) * int(shape[1]) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} has no {world} ranks")
    threads = max(1, torch.get_num_threads() // world)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(threads)
    with tempfile.TemporaryDirectory(prefix="rgbd_ranks_") as tmp:
        work = pathlib.Path(tmp)
        with open(work / "call.pkl", "wb") as f:
            pickle.dump({"target": target, "args": args, "world": world,
                         "shape": tuple(int(s) for s in shape), "device": str(device),
                         "threads": threads}, f)
        procs, failed = [], None
        try:
            for r in range(world):
                with open(work / f"rank{r}.out", "wb") as out, open(work / f"rank{r}.err", "wb") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", __name__, str(work), str(r)],
                        stdout=out, stderr=err, stdin=subprocess.DEVNULL, env=env))
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.poll()), None)
                time.sleep(0.02)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.returncode), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        sys.stdout.write((work / "rank0.out").read_text())
        sys.stdout.flush()
        sys.stderr.write((work / "rank0.err").read_text())
        if failed is not None:
            raise _rank_error(work, failed, procs[failed].returncode)
        results = []
        for r in range(world):
            with open(work / f"result{r}.pkl", "rb") as f:
                results.append(pickle.load(f)[1])
        return results


def _rank_error(work: pathlib.Path, rank: int, rc: int) -> BaseException:
    """The exception rank ``rank`` raised, its traceback as a note; or a
    ``RuntimeError`` with its error output where it left none."""
    try:
        with open(work / f"result{rank}.pkl", "rb") as f:
            _, exc, tb = pickle.load(f)
        exc.add_note(f"raised on rank {rank}:\n{tb}")
        return exc
    except Exception:
        err = (work / f"rank{rank}.err").read_text()[-6000:]
        return RuntimeError(f"rank {rank} exited with code {rc}:\n{err}")


def _child(work: pathlib.Path, rank: int) -> int:
    import torch.distributed as dist

    from rgbd_pose_estimation_tpu_torch.parallel import mesh

    with open(work / "call.pkl", "rb") as f:
        call = pickle.load(f)
    torch.set_num_threads(call["threads"])
    try:
        mesh.set_launch_shape(call["shape"])
        mesh.distributed_init(f"file://{work / 'store'}", call["world"], rank, call["device"])
        module, name = call["target"].split(":")
        value = getattr(importlib.import_module(module), name)(*call["args"])
        result, rc = ("ok", value), 0
    except Exception as exc:  # handed to the caller, which raises it
        tb = traceback.format_exc()
        sys.stderr.write(tb)
        try:
            pickle.dumps(exc)
        except Exception:
            exc = RuntimeError(f"{type(exc).__name__}: {exc}")
        result, rc = ("error", exc, tb), 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(work / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    return rc


if __name__ == "__main__":
    sys.exit(_child(pathlib.Path(sys.argv[1]), int(sys.argv[2])))
