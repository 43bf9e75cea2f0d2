"""Run one cell of the benchmark once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. It runs the port
(``ssdn_tpu_torch``) on the card(s) the cell asks for, never on the CPU,
and prints the card on an early line of standard error. With ``--trace 0``
the result carries the cell's end-to-end metrics; with ``--trace 1`` one
profiler window covers the measured work and the result carries the
cell's per-layer metrics and the trace's breakdown. Every run decides
``correct`` against the plain reference and prints each number compared
beside its limit, last on standard error and last in the result line,
which is the last line of standard output.
"""

import time

START_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h100_bench import check, guard, spec  # noqa: E402


def card_line(torch, count: int) -> str:
    """The cards' names and power limits as nvidia-smi reads them."""
    try:
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().split("\n")
    except (OSError, subprocess.SubprocessError):
        cards = ["unknown"]
    return (f"card: using {count} of {torch.cuda.device_count()} device(s): "
            f"{'; '.join(cards[:count])}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")


def per_layer(cell, records):
    """{metric: {"value", "unit"}} of the readers that find something."""
    from h100_bench.metrics_base import NothingToRead

    out = {}
    for m in cell.per_layer:
        try:
            value = cell.reader(m["name"]).read(records)
        except NothingToRead as e:
            print(f"metric {m['name']}: nothing to read ({e})",
                  file=sys.stderr)
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(args, device: str = "cuda", root: str = ROOT):
    """(result line, driver's result) of one run; ``device`` serves the
    CPU tests, which drive a run without a card."""
    cell = spec.Cell(args.workload, root)
    ctx = {"seed": args.seed, "seconds": args.seconds,
           "trace": bool(args.trace), "device": device,
           "start_wall": START_WALL,
           "traffic": cell.traffic, "config": cell.config,
           "traffic_name": cell.traffic_name}
    res = cell.driver().run(cell, ctx)
    correct, checks = check.judge(res["readings"], cell.limits)
    if args.trace:
        records = res["records"]
        metrics = per_layer(cell, records)
        traces = [t for t in records["traces"] if t]
        device_block = {
            "busy_s": sum(t["busy_s"] for t in traces) / len(traces),
            "window_s": records["trace"]["window_s"]}
        breakdown = {"device_ops": records["trace"]["device_ops"],
                     "idle_gaps": records["trace"]["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in res["metrics"].items() if k in units}
        device_block, breakdown = {}, None
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": metrics,
            "device": {"platform": "gpu" if device == "cuda" else "cpu",
                       "kind": res["kind"], "count": res["count"],
                       "memory_peak_bytes": res["peak_bytes"],
                       **device_block}}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = spec.Cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    print(card_line(torch, cell.chips), file=sys.stderr, flush=True)
    line, res = run(args)
    found = guard.jax_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    print(f"reference check took {res.get('reference_s', 0):.1f} s",
          file=sys.stderr)
    check.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
