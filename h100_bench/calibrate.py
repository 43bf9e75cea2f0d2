"""The readings that a cell's limits are set from, many seeds in one process
(set-up is paid once per process, not per seed):

    python3 h100_bench/calibrate.py --workload <cell> --seeds <n>... \
        --control-seeds <n>... [--out <file.json>]

- ``program``: the numbers of ``check`` from sound runs of the cell's own
  driver, one per seed of ``--seeds``, each with a short window (training
  cells compare the first three steps, which need none);
- ``control``: the plain reference put in the program's place and computed
  one precision below the configuration's (fp8 for a bf16 trunk, TF32 for
  float32 with TF32 off), against the float32 reference, per control seed;
- training cells also read a planted fault in the reference put in the
  program's place: ``half_batch`` (the loss and gradients over the first
  half of the rows).

It runs on the card; a cell's own runs never call it.
"""

import time

START_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import check, corpus, spec  # noqa: E402


def control_precision(fields) -> str:
    return "fp8" if fields["model"]["compute_dtype"] == "bfloat16" else "tf32"


def train_controls(cell, seed: int, device) -> dict:
    from h100_bench.drivers import trainer

    t = cell.traffic
    _, fields = trainer.train_config(cell.config, seed, 10 ** 6)
    images = corpus.training_corpus(seed, t["images"], t["image_size"])
    want = trainer.reference_record(fields, images, device)

    def readings(**kw):
        got = trainer.as_program(
            trainer.reference_record(fields, images, device, **kw), want)
        return dict(check.training_readings(got, want),
                    worst=check.worst_leaves(got, want))

    b = fields["batch_size"]
    out = {"control": readings(precision=control_precision(fields)),
           "half_batch": readings(keep_rows=b // 2)}
    return out


def serve_controls(cell, seed: int, device) -> dict:
    from h100_bench.drivers import serve_closed as sc
    from h100_bench.reference import model as ref

    t = cell.traffic
    fields = dict(cell.config["train_config"], seed=seed)
    params, images = sc.inputs(t, fields, seed, device)
    plan = sc.request_plan(t, seed, t["sample_from"])
    seen, pairs = [0] * len(t["shapes"]), []
    picks = sc.sample_plan(t, seed, plan)
    for j, slot in enumerate(plan):
        k = slot * t["pool"] + seen[slot] % t["pool"]
        seen[slot] += 1
        if j in picks:
            want = ref.denoise(fields, params, *images[k], device)
            pairs.append((ref.denoise(fields, params, *images[k], device,
                                      control_precision(fields)), want))
    return {"control": check.image_readings(pairs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload)
    serving = cell.traffic["driver"] == "serve_closed"
    out = {"workload": args.workload, "program": {}, "controls": {}}
    for seed in args.seeds:
        ctx = {"seed": seed, "seconds": args.seconds, "trace": False,
               "device": "cuda", "start_wall": time.time(),
               "traffic": cell.traffic, "config": cell.config,
               "traffic_name": cell.traffic_name}
        if serving:
            res = cell.driver().run(cell, ctx)
        else:
            from h100_bench.drivers import trainer

            res = trainer.run_cell(ctx)
        out["program"][seed] = dict(res["readings"],
                                    worst=res.get("worst_leaves"))
        print("program", seed, json.dumps(out["program"][seed]), flush=True)
    for seed in args.control_seeds:
        fn = serve_controls if serving else train_controls
        out["controls"][seed] = fn(cell, seed, torch.device("cuda"))
        print("controls", seed, json.dumps(out["controls"][seed]), flush=True)
    out["seconds"] = time.time() - START_WALL
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
