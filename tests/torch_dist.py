"""Spawn helper for the port's ``torch.distributed`` tests (CPU, gloo).

``run(fn, world, *args)`` starts ``world`` processes with the ``spawn``
method; each forms a gloo group through ``ssdn_tpu_torch.parallel.
init_group`` (torchrun's environment variables, a ``file://`` store in a
fresh temporary directory, so parallel test workers never share a port),
calls ``fn(group, *args)`` and sends the result back. The parent drains
the results with a deadline, joins every rank with one and kills what is
left, and raises if any rank failed or did not finish: a hung collective
fails its test instead of hanging the run.

The rank functions live here, not in the test files, so that a rank
imports torch and the port but not JAX. Every rank runs one torch thread
(the test workers share the machine's cores).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np

RANK_TIMEOUT_S = 90     # a collective that waits longer fails its rank
JOIN_DEADLINE_S = 240   # the whole spawn, start-up included


def _entry(rank, world, store, fn, args, q):
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        import torch

        torch.set_num_threads(1)
        from ssdn_tpu_torch import parallel

        group = parallel.init_group(
            device="cpu", init_method=f"file://{store}",
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            q.put((rank, True, fn(group, *args)))
        finally:
            parallel.destroy_group()
    except BaseException:  # reported to the parent, which raises
        q.put((rank, False, traceback.format_exc()))


def run(fn, world, *args, deadline_s=JOIN_DEADLINE_S):
    """[fn(group, *args) of rank 0, ..., of rank world-1]."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_entry,
                             args=(r, world, store, fn, args, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        results, errors = {}, {}
        try:
            while len(results) + len(errors) < world:
                left = end - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, value = q.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    if not any(p.is_alive() for p in procs):
                        break
                    continue
                (results if ok else errors)[rank] = value
            for p in procs:
                p.join(timeout=max(end - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(
            f"rank {r} failed:\n{e}" for r, e in sorted(errors.items())))
    missing = sorted(set(range(world)) - set(results))
    if missing:
        raise AssertionError(f"ranks {missing} did not finish within "
                             f"{deadline_s} s (exit codes "
                             f"{[p.exitcode for p in procs]})")
    return [results[r] for r in range(world)]


# ------------------------------ rank functions ------------------------------


def sharded(group, cases):
    """{name: denoised image} of ``tiled_denoise_sharded`` for each case
    (cfg, numpy weights tree, noisy image, noise param, halo, strategy)."""
    from ssdn_tpu_torch.infer.tiled import tiled_denoise_sharded
    from ssdn_tpu_torch.models.blindspot_unet import params_from_jax

    out = {}
    for name, (cfg, tree, noisy, param, halo, strategy) in cases.items():
        params = params_from_jax(tree, device=group.device)
        out[name] = tiled_denoise_sharded(cfg, params, noisy, param, group,
                                          halo=halo, strategy=strategy)
    return out


def dp_steps(group, cfg, batches_u8):
    """The port's DP training from ``init_state(cfg)`` over the given global
    uint8 batches: (losses, params as numpy HWIO)."""
    from ssdn_tpu_torch.models.blindspot_unet import params_to_jax
    from ssdn_tpu_torch.train import step as tstep

    ts = tstep.make_train_step(cfg, device="cpu", group=group)
    state = tstep.init_state(cfg, device="cpu")
    losses = []
    for b in batches_u8:
        state, m = ts(state, b)
        losses.append(float(m["loss"]))
    return losses, params_to_jax(state.params)


def dp_steps_on(group, cfg, tree, batches):
    """DP steps of the port from the numpy weights ``tree`` on given global
    noisy batches (x, y, noise_params, y2), each rank stepping on its rows:
    (losses, params as numpy HWIO)."""
    import torch

    from ssdn_tpu_torch.models.blindspot_unet import (
        params_from_jax,
        params_to_jax,
    )
    from ssdn_tpu_torch.train import step as tstep

    ts = tstep.make_train_step(cfg, device="cpu", group=group)
    state = tstep.state_from_params(params_from_jax(tree, device="cpu"))
    t = torch.from_numpy
    losses = []
    for x, y, npar, y2 in batches:
        rows = ts.rows(t(x), t(y), {k: t(v) for k, v in npar.items()}, t(y2))
        state, m = ts.step_on(state, *rows)
        losses.append(float(m["loss"]))
    return losses, params_to_jax(state.params)


def trainer(group, cfg, workdir, train_data, eval_data):
    """A data-parallel ``Trainer`` run (resuming from the workdir's latest
    checkpoint): {"step", "params" as numpy HWIO, "writes": the files this
    rank opened for writing, saved, replaced or removed, "reads": the files
    of ``workdir`` it opened for reading or loaded}."""
    import builtins

    import torch

    from ssdn_tpu_torch.models.blindspot_unet import params_to_jax
    from ssdn_tpu_torch.train.loop import Trainer

    writes, reads = [], []
    real_open, real_save, real_load = builtins.open, torch.save, torch.load
    real_replace, real_remove = os.replace, os.remove
    root = os.path.abspath(workdir)

    def rec_open(path, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            writes.append(str(path))
        elif os.path.abspath(str(path)).startswith(root):
            reads.append(str(path))
        return real_open(path, mode, *a, **k)

    def rec_load(path, *a, **k):
        reads.append(str(path))
        return real_load(path, *a, **k)

    def rec(fn):
        def wrapped(path, *a, **k):
            writes.append(str(path))
            return fn(path, *a, **k)
        return wrapped

    builtins.open, torch.save = rec_open, rec(real_save)
    torch.load = rec_load
    os.replace, os.remove = rec(real_replace), rec(real_remove)
    try:
        t = Trainer(cfg, workdir, train_data=train_data,
                    eval_data=eval_data, log_interval=2,
                    sampler_backend="python", prefetch_depth=2,
                    prefetch_threads=1, device="cpu", group=group)
        state = t.train()
    finally:
        builtins.open, torch.save = real_open, real_save
        torch.load = real_load
        os.replace, os.remove = real_replace, real_remove
    return {"step": int(state.step), "params": params_to_jax(state.params),
            "writes": writes, "reads": reads}


def evaluate(group, cfg, tree, dataset, runs):
    """``evaluate_dataset`` over the group for each (mode, eval_batch) of
    ``runs``: {mode: its dict, with the first image's denoised array}."""
    from ssdn_tpu_torch.data import open_dataset
    from ssdn_tpu_torch.infer import evaluate_dataset
    from ssdn_tpu_torch.models.blindspot_unet import params_from_jax

    params = params_from_jax(tree, device="cpu")
    out = {}
    for mode, eval_batch in runs:
        res = evaluate_dataset(cfg, params, open_dataset(dataset), mode=mode,
                               eval_batch=eval_batch, device="cpu",
                               group=group, return_images=1)
        res["denoised0"] = np.asarray(res.pop("images")[0]["denoised"])
        out[mode] = res
    return out


def ppermute_cases(group):
    """``ppermute`` of a rank-stamped tensor: one-hop (rank 0 gets zeros),
    the reversal (a self-pair at the middle rank of an odd world) and a
    W-slice of a channels_last tensor."""
    import torch

    from ssdn_tpu_torch.parallel import ppermute

    n, r = group.world, group.rank
    t = torch.full((2, 3), float(r + 1))
    x = (torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
         + 1000 * r).contiguous(memory_format=torch.channels_last)
    return {
        "fwd": ppermute(t, [(i, i + 1) for i in range(n - 1)], group).numpy(),
        "rev": ppermute(t, [(i, n - 1 - i) for i in range(n)], group).numpy(),
        "none": ppermute(t, [], group).numpy(),
        "slice": ppermute(x[..., -1:], [(i, (i + 1) % n) for i in range(n)],
                          group).numpy(),
        "dtype": str(ppermute(t.double(), [], group).dtype),
    }


def shard_rows_of(group, b):
    """``shard_rows`` of a batch of ``b`` rows (raises unless it divides)."""
    import torch

    from ssdn_tpu_torch.parallel import shard_rows

    return shard_rows(torch.arange(b), group).tolist()
