"""What one collective costs on a mesh of one rank (a world-1 NCCL group).

    python -m rgbd_pose_estimation_tpu_torch.tools.collective_cost [--variants]

Needs one CUDA device. For the payloads of the distributed steps (a cost
scalar, K4's 44 floats, a blocked CG iteration's (64, 6) camera vector, a
replicated one's (24576, 3) landmark vector) it times ``n`` back-to-back
calls of

- ``psum``: the port's sum over the mesh (``parallel.mesh.psum``: a clone and
  ``all_reduce``),
- ``all_reduce``: ``torch.distributed.all_reduce`` in place, alone,
- ``clone``: the clone alone (the floor of an eager op of that size),

by the host clock (calls enqueued back to back, one synchronise at the end)
and by CUDA events, and prints one JSON line per (op, payload) in µs a call,
with the card's name and power limit and the ``TORCH_NCCL_*``/``NCCL_*``
environment. ``--variants`` runs the same in child processes under other
``TORCH_NCCL_*`` settings (the flight recorder off, timing on, blocking
wait), one line set each.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

PAYLOADS = {"cost": (), "icp_44": (44,), "cg_blocked_64x6": (64, 6),
            "cg_replicated_24576x3": (24576, 3)}
VARIANTS = {
    "default": {},
    "trace_buffer_0": {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0"},
    "enable_timing_1": {"TORCH_NCCL_ENABLE_TIMING": "1"},
    "blocking_wait_1": {"TORCH_NCCL_BLOCKING_WAIT": "1"},
}


def _time(fn, n):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    host_enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    return {"host_us": host * 1e6 / n, "enqueue_us": host_enqueue * 1e6 / n,
            "event_us": start.elapsed_time(stop) * 1e3 / n}


def measure(variant: str, n: int = 200) -> list:
    import torch.distributed as dist

    from rgbd_pose_estimation_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(device="cuda")
    env = {k: v for k, v in os.environ.items() if k.startswith(("TORCH_NCCL", "NCCL"))}
    rows = []
    for name, shape in PAYLOADS.items():
        x = torch.randn(shape, device="cuda")
        y = x.clone()
        for op, fn in (("psum", lambda: pm.psum(mesh, x)),
                       ("all_reduce", lambda: dist.all_reduce(y, group=mesh.group)),
                       ("clone", lambda: x.clone())):
            rows.append({"variant": variant, "op": op, "payload": name,
                         "bytes": x.numel() * x.element_size(), **_time(fn, n), "env": env})
    dist.destroy_process_group()
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("collective_cost needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "torch": torch.__version__}), flush=True)
    if "--child" in argv:
        for row in measure(argv[argv.index("--child") + 1]):
            print(json.dumps(row), flush=True)
        return 0
    variants = VARIANTS if "--variants" in argv else {"default": {}}
    for name, extra in variants.items():
        env = {**os.environ, **extra}
        out = subprocess.run([sys.executable, "-m", __spec__.name, "--child", name],
                             env=env, capture_output=True, text=True, timeout=300)
        if out.returncode:
            raise SystemExit(f"variant {name} failed:\n{out.stderr[-3000:]}")
        print("\n".join(out.stdout.strip().splitlines()[1:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
