"""Window driver ``trainer``: one ``Trainer.train(resume=False)`` call of the
port, host pipeline included, on a corpus made from the seed.

Set-up makes the corpus (the traffic's ``images`` of ``image_size``
pixels), builds one ``Trainer`` with the native sampler over it as an
in-memory dataset, the traffic's Prefetcher depth and threads, the guard
at the configuration's cadence and the eval and snapshot hooks off, and
drives it through two calls: the first builds and warms everything, the
second (``rate_steps`` steps) gives the step rate from which the window's
``iterations`` is sized to last about ``--seconds``. The window is one
more call of the same object, from the seed's initialisation.

Two proxies of the benchmark's own watch the window without changing it:
one around ``Trainer.sampler.sample`` (host-clock span per batch, read by
``sampler_ms.train``), one around the step function that keeps references
to the states its first three steps take and give (the step is
functional, so nothing is copied) for the check against the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, Optional

import torch

from h100_bench import check, corpus
from h100_bench import trace as tr
from h100_bench.reference import model as ref

CHECKED_STEPS = 3


class SamplerSpans:
    """``sample`` of the wrapped sampler, timed on the host clock."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.spans = []
        self._lock = threading.Lock()

    def sample(self, step):
        t0 = time.perf_counter()
        out = self.sampler.sample(step)
        with self._lock:
            self.spans.append(time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self.sampler, name)


class StepRecorder:
    """The step function, keeping references to the states and losses of
    its first ``CHECKED_STEPS`` calls; ``traced`` names each step in the
    profile."""

    def __init__(self, step_fn, traced: bool):
        self.fn = step_fn
        self.traced = traced
        self.p0 = self.mu1 = self.p_last = None
        self.losses = []

    def __call__(self, state, batch):
        k = len(self.losses)
        if self.traced:
            with torch.profiler.record_function("h100_bench.step"):
                new, metrics = self.fn(state, batch)
        else:
            new, metrics = self.fn(state, batch)
        if k == 0:
            self.p0, self.mu1 = state.params, new.opt_state["mu"]
        if k < CHECKED_STEPS:
            self.losses.append(metrics["loss"])
            if k == CHECKED_STEPS - 1:
                self.p_last = new.params
        return new, metrics

    def __getattr__(self, name):
        return getattr(self.fn, name)


class Phases:
    """Prints each set-up phase's end, in seconds from process start, on
    standard error."""

    def __init__(self, start_wall: float):
        self.start = start_wall

    def __call__(self, what: str) -> None:
        print(f"set-up: {what} done at {time.time() - self.start:.2f} s",
              file=sys.stderr, flush=True)


def train_config(config: Dict, seed: int, iterations: int):
    from ssdn_tpu_torch.config import train_config_from_json

    fields = dict(config["train_config"])
    fields.update(seed=seed, iterations=iterations, eval_interval=0,
                  snapshot_interval=0)
    return train_config_from_json(json.dumps(fields)), fields


def _arm(trainer, cfg, iterations: int, traced: bool) -> StepRecorder:
    """Point the trainer at ``iterations`` steps, with a fresh recorder
    around its step function."""
    from ssdn_tpu_torch.train.step import make_train_step

    trainer.cfg = dataclasses.replace(cfg, iterations=iterations)
    rec = StepRecorder(make_train_step(trainer.cfg, device=trainer.device),
                       traced)
    trainer.step_fn = rec
    return rec


def _norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {f"{n}.{k}": float(torch.linalg.vector_norm(t.double())) * scale
            for n, leaf in tree.items() for k, t in leaf.items()}


def _diff_norms(a, b) -> Dict[str, float]:
    return {f"{n}.{k}": float(torch.linalg.vector_norm(
        a[n][k].double() - b[n][k].double()))
        for n, leaf in a.items() for k in leaf}


def _delta(after, before):
    """Each leaf's change, as a host float64 copy."""
    return {n: {k: (after[n][k].double() - before[n][k].double()).cpu()
                for k in leaf} for n, leaf in after.items()}


def _change(delta, keep) -> Dict[str, float]:
    """Each leaf's norm of change over its elements that ``keep`` holds."""
    return {f"{n}.{k}": float(torch.linalg.vector_norm(t[keep[n][k]]))
            for n, leaf in delta.items() for k, t in leaf.items()}


def reference_record(fields: Dict, images, device, precision: str = "fp32",
                     keep_rows: Optional[int] = None,
                     block: Optional[int] = None):
    """The reference's record of the first ``CHECKED_STEPS`` steps, with
    its first gradient under "g0", its change under "delta" (host copies)
    and the elements that the change is read over under "keep"
    (``check.moving_elements``)."""
    out = ref.train_steps(fields, images, CHECKED_STEPS, device, precision,
                          block=block or min(fields["batch_size"], 96),
                          keep_rows=keep_rows)
    g0 = _host(out["grad0"])
    keep = check.moving_elements(g0)
    delta = _delta(out["params"], out["params0"])
    return {"loss": out["loss"], "init": _norms(out["params0"]),
            "grad0": _norms(out["grad0"]), "change": _change(delta, keep),
            "g0": g0, "delta": delta, "keep": keep}


def _host(tree, scale: float = 1.0):
    return {n: {k: t.detach().double().cpu() * scale for k, t in leaf.items()}
            for n, leaf in tree.items()}


def as_program(record: Dict, want: Dict) -> Dict:
    """A record read as the program's against ``want``: its gradient's
    difference from ``want``'s, leaf by leaf, under "grad0_diff", and its
    change over the elements that ``want``'s is read over."""
    return dict(record, grad0_diff=_diff_norms(record["g0"], want["g0"]),
                change=_change(record["delta"], want["keep"]))


def run_cell(ctx: Dict) -> Dict:
    """One run of a training cell on ``ctx["device"]``."""
    from ssdn_tpu_torch.data import ArrayDataset
    from ssdn_tpu_torch.native import make_sampler
    from ssdn_tpu_torch.train.loop import Trainer

    traffic, config = ctx["traffic"], ctx["config"]
    seed, traced = ctx["seed"], ctx["trace"]
    dev = torch.device(ctx["device"])
    phases = Phases(ctx["start_wall"])
    phases("start")
    images = corpus.training_corpus(seed, traffic["images"],
                                    traffic["image_size"])
    phases("corpus")
    cfg, fields = train_config(config, seed, traffic["warm_steps"])
    if cfg.batch_size != traffic["batch_size"]:
        raise ValueError(f"traffic {ctx['traffic_name']} runs batch "
                         f"{traffic['batch_size']}, the configuration "
                         f"{cfg.batch_size}")
    workdir = tempfile.mkdtemp(prefix="h100_bench_train_")
    try:
        trainer = Trainer(cfg, os.path.join(workdir, "w"),
                          train_data="synthetic:1:64", log_interval=0,
                          sampler_backend="native",
                          prefetch_depth=traffic["prefetch_depth"],
                          prefetch_threads=traffic["prefetch_threads"],
                          device=dev)
        trainer.dataset = ArrayDataset(images)
        spans = SamplerSpans(make_sampler(
            trainer.dataset, cfg.patch_size, cfg.batch_size, seed=cfg.seed,
            backend="native"))
        trainer.sampler = spans
        phases("trainer")
        _arm(trainer, cfg, traffic["warm_steps"], False)
        trainer.train(resume=False)
        phases("first call")
        _arm(trainer, cfg, traffic["rate_steps"], False)
        t0 = time.perf_counter()
        trainer.train(resume=False)
        rate_s = time.perf_counter() - t0
        phases("rate call")
        n = max(traffic["rate_steps"],
                round(ctx["seconds"] * traffic["rate_steps"] / rate_s))
        fields["iterations"] = n
        rec = _arm(trainer, cfg, n, traced)
        spans.spans.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.time() - ctx["start_wall"]
        with tr.Window(traced, dev) as win:
            state = trainer.train(resume=False)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        b1 = cfg.adam_b1
        prog = {"loss": [float(x) for x in rec.losses],
                "init": _norms(rec.p0),
                "grad0": _norms(rec.mu1, 1.0 / (1.0 - b1)),
                "delta": _delta(rec.p_last, rec.p0),
                "g0": _host(rec.mu1, 1.0 / (1.0 - b1))}
        done = int(state.step)
        summary = win.summary()
        sampler_spans = list(spans.spans)
        del trainer, state, rec, spans
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = reference_record(fields, images, dev)
    prog = as_program(prog, want)
    return {"attempted": n, "failed": n - done, "setup_s": setup_s,
            "wall_s": win.window_s, "peak_bytes": peak, "steps": n,
            "sampler_spans": sampler_spans, "trace": summary,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "readings": check.training_readings(prog, want),
            "worst_leaves": check.worst_leaves(prog, want),
            "reference_s": time.perf_counter() - t0}


def records(cell, r: Dict) -> Dict:
    """What the per-layer readers read."""
    cfg = cell.config["train_config"]
    return {"kind": "train", "steps": r["steps"],
            "batch": cfg["batch_size"], "rows_per_card": cfg["batch_size"],
            "patch": cfg["patch_size"],
            "blind": cfg["noise"]["value"] == "blind",
            "dtype": cfg["model"]["compute_dtype"], "wall_s": r["wall_s"],
            "sampler_spans": r["sampler_spans"],
            "trace": r["trace"], "traces": [r["trace"]]}


def run(cell, ctx: Dict) -> Dict:
    """The cell's end-to-end metrics and the rest of the result."""
    r = run_cell(ctx)
    cfg = cell.config["train_config"]
    return {
        "attempted": r["attempted"], "failed": r["failed"],
        "metrics": {
            "train_patches_per_s": r["steps"] * cfg["batch_size"]
            / r["wall_s"],
            "peak_device_gib": r["peak_bytes"] / 2 ** 30,
            "setup_s": r["setup_s"],
        },
        "peak_bytes": r["peak_bytes"], "readings": r["readings"],
        "reference_s": r["reference_s"], "kind": r["kind"], "count": 1,
        "records": records(cell, r),
    }
