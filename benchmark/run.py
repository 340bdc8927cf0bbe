"""The benchmark of ``rgbd_pose_estimation_tpu_torch`` on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it takes the card, loads the kernels from the
port's build cache in the checkout (``rgbd_pose_estimation_tpu_torch/ops/_build/``;
the first run in a checkout compiles them), makes the cell's data on the
device from ``--seed``, warms up the cell's own shapes, drives the entry for
``--seconds``, checks what the window produced against the plain reference,
and prints one JSON object as the last line of its standard output. With
``--trace 1`` it also profiles a sub-window of a fixed number of requests
after the window, reports the per-layer metrics instead of the end-to-end
ones, and writes a compact summary of the trace under ``bench_out/``.

Everything of a cell is found by name (``benchmark/harness/spec.py``). It
exits with a code other than 0, and prints no result, without a card, with
fewer cards than the cell asks for, without the port beside it, or when JAX
or the JAX package was loaded.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "rgbd_pose_estimation_tpu")
_NAME_CHARS = 120  # a breakdown entry's name is cut to this many characters


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _top(rows, n=10):
    return [[str(r[0])[:_NAME_CHARS], r[-1]] for r in rows[:n]]


def main(argv=None, root=ROOT, device=None, out=None):
    """Run one cell; returns the exit code. ``device`` set (tests) skips the
    look for a card and runs there."""
    from benchmark.harness.spec import Spec
    from benchmark.harness.tracing import TracedWindow

    out = out or sys.stdout
    root = pathlib.Path(root)
    args = parse(argv)
    spec = Spec(root)
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])

    import torch

    # One host thread for PyTorch's CPU operations: the intra-op pool's
    # threads compete with the thread that launches the kernels.
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = "cuda"
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_import = time.perf_counter()
    client = spec.client(mix["client"]).Client(config, mix, args.seed, device)
    client.setup()
    sync()
    t_data = time.perf_counter()
    client.warmup()
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - _T_START
    print(f"set-up {setup_s:.2f} s: torch and the harness {t_import - _T_START:.2f}, the program and the "
          f"data {t_data - t_import:.2f}, warm-up {t0 - t_data:.2f}", file=sys.stderr)
    t_end = t0 + args.seconds
    cpu0, thread0 = time.process_time(), time.thread_time()
    records = client.serve(t_end)
    # The rates are paced by the host: a main thread that got less of a core
    # than the window lasted was kept off it.
    print(f"host CPU in the window: main thread {time.thread_time() - thread0:.2f} s, process "
          f"{time.process_time() - cpu0:.2f} s, wall {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    quarters = [sum(1 for r in records if r["ok"] and r["t_done"] is not None
                    and t0 + q * args.seconds / 4 < r["t_done"] <= t0 + (q + 1) * args.seconds / 4)
                for q in range(4)]
    print(f"requests completed by quarter of the window: {quarters}", file=sys.stderr)
    traced, summary, counts = [], None, None
    if args.trace:
        window = TracedWindow(mix["trace_skip"], mix["trace_requests"])
        traced = client.serve(math.inf, on_complete=window.on_complete)
        summary = window.reduce()
        counts = client.counts()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3

    from benchmark.harness.peaks import peaks

    ctx = {"setup_s": setup_s, "seconds": args.seconds, "t0": t0, "t_end": t_end,
           "records": records, "trace": summary, "counts": counts, "peaks": peaks(),
           "config": config, "mix": mix}
    metrics = {}
    for m in spec.per_layer(cell["name"]) if args.trace else spec.end_to_end(cell["name"]):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    client.release()
    t_check = time.perf_counter()
    compared = client.check(records + traced)
    print(f"reference check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = set(compared) == set(limits) and all(compared[k] <= limits[k] for k in limits)

    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell["chips"] if on_card else 0,
        "memory_peak_bytes": memory_peak,
    }
    line = {"correct": correct, "attempted": len(records),
            "failed": sum(not r["ok"] for r in records), "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": _top(summary["device_ops"]),
                             "idle_gaps": _top(summary["idle_gaps"])}
        out_dir = root / "bench_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"{cell['name']}-{args.seed}-trace.json").write_text(
            json.dumps({"cell": cell["name"], "seed": args.seed, "counts": counts, **summary}))
    line["compared"] = {k: {"value": compared[k], "limit": limits.get(k)} for k in compared}
    for k in compared:
        print(f"compared {k} {compared[k]!r} limit {limits.get(k)!r}", file=sys.stderr)
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
