"""The port's data parallelism (``ssdn_tpu_torch.parallel``, ``TrainStep`` and
``Trainer`` with a group, ``cli.train --data-parallel``) over 2 and 4 gloo
ranks on the CPU, at narrow widths (enc 8, dec 16, nin 32/16) in fp32.

* DP equals the port's single-process step at the same seed, through the
  uint8 path (every rank draws the global noisy batch and keeps its rows),
  at ``tests/test_parallel_and_resume.py``'s bars: loss rtol 1e-5, params
  rtol 1e-4 / atol 1e-6. The default objective's beta-NLL normalises by a
  batch mean, which only the cross-rank mean keeps equal.
* DP tracks the JAX package's loss / grad + optax update on the whole
  batch, one numpy noisy batch split over 4 ranks: the losses at the
  bounds of ``tests/test_torch_train_step.py``'s matched trajectory, each
  leaf's gap within 1e-3 of the distance it moved.
* A DP Trainer restarted from its step-2 checkpoint ends on the
  uninterrupted run's bits; ranks other than 0 write nothing.
* ``ppermute``'s zeros, self-pair and strided slices; ``shard_rows``
  refuses a batch that does not divide.
* ``cli.train --data-parallel --device cpu`` through ``python -m
  torch.distributed.run --standalone --nproc-per-node 2``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ssdn_tpu.config as jcfg
import ssdn_tpu_torch.config as tcfg
import torch_dist
from ssdn_tpu.train import step as jstep
from ssdn_tpu_torch.models.blindspot_unet import params_to_jax
from ssdn_tpu_torch.parallel import Group, shard_rows
from ssdn_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
TINY = dict(compute_dtype="float32", enc_features=8, dec_features=16,
            nin_a_features=32, nin_b_features=16)
TINY_FLAGS = ["--enc-features", "8", "--dec-features", "16",
              "--nin-a-features", "32", "--nin-b-features", "16",
              "--compute-dtype", "float32"]


def _cfg(mod, style="gauss25", blind=False, **over):
    kw = dict(patch_size=32, batch_size=BATCH, iterations=60, lr=1e-3,
              seed=0)
    kw.update(over)
    return mod.TrainConfig(noise=mod.parse_noise_style(style, blind=blind),
                           model=mod.ModelConfig(in_channels=3, **TINY), **kw)


def _u8_batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
            for _ in range(n)]


def _single(cfg, batches):
    ts = tstep.make_train_step(cfg, device="cpu")
    state = tstep.init_state(cfg, device="cpu")
    losses = []
    for b in batches:
        state, m = ts(state, b)
        losses.append(float(m["loss"]))
    return losses, params_to_jax(state.params)


def _assert_params_close(got, ref, **tol):
    assert sorted(got) == sorted(ref)
    for layer, leaf in ref.items():
        for key, v in leaf.items():
            np.testing.assert_allclose(got[layer][key], v,
                                       err_msg=f"{layer}.{key}", **tol)


# ------------------------- DP == one process -------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["gauss25", "blind_clipped"])
def test_dp_equals_single_device(world, case):
    """3 steps at global batch 8: gauss25 at the default beta-NLL, and the
    variable-blind model with a global-norm clip (the clip must see the
    averaged gradient's norm)."""
    cfg = (_cfg(tcfg) if case == "gauss25" else
           _cfg(tcfg, "gauss5_50", "variable", grad_clip=0.5))
    batches = _u8_batches(3)
    l1, p1 = _single(cfg, batches)
    runs = torch_dist.run(torch_dist.dp_steps, world, cfg, batches)
    for r, (lr_, pr) in enumerate(runs):
        assert lr_ == runs[0][0], f"rank {r} logged other losses"
        _assert_params_close(pr, runs[0][1], rtol=0, atol=0)
    np.testing.assert_allclose(runs[0][0], l1, rtol=1e-5)
    _assert_params_close(runs[0][1], p1, rtol=1e-4, atol=1e-6)


def test_beta_nll_needs_the_global_batch_mean():
    """The rank-local beta-NLL normaliser is a different loss: a rank's
    rows alone, normalised by their own mean, do not give the global
    batch's loss — which is why ``TrainStep`` passes the cross-rank
    mean."""
    from ssdn_tpu_torch import estimator

    cfg = _cfg(tcfg)
    ts = tstep.make_train_step(cfg, device="cpu")
    state = tstep.init_state(cfg, device="cpu")
    x, y, npar, _ = ts.noisy_batch(_u8_batches(1)[0], 0)
    with torch.no_grad():
        out = ts.forward(state.params, y)
    whole, _ = estimator.nll(out, y, cfg.noise, npar, beta=1.0)
    halves = []
    for rows in (slice(0, 4), slice(4, 8)):
        loss, _ = estimator.nll(out[rows], y[rows], cfg.noise,
                                {k: v[rows] for k, v in npar.items()},
                                beta=1.0)
        halves.append(float(loss))
    w_mean = torch.mean(_beta_weights(estimator, out, y, cfg, npar))
    pooled = []
    for rows in (slice(0, 4), slice(4, 8)):
        loss, _ = estimator.nll(out[rows], y[rows], cfg.noise,
                                {k: v[rows] for k, v in npar.items()},
                                beta=1.0, batch_mean=lambda t: w_mean)
        pooled.append(float(loss))
    np.testing.assert_allclose(np.mean(pooled), float(whole), rtol=1e-6)
    assert abs(np.mean(halves) - float(whole)) > 1e-6 * abs(float(whole))


def _beta_weights(estimator, out, y, cfg, npar):
    """The detached beta-NLL weights of the whole batch, as ``nll`` forms
    them (captured through its ``batch_mean`` hook)."""
    seen = []
    estimator.nll(out, y, cfg.noise, npar, beta=1.0,
                  batch_mean=lambda t: seen.append(t) or torch.mean(t))
    return seen[0]


# ------------------------------ DP == JAX ------------------------------


def _numpy_batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (BATCH, 32, 32, 3)).astype(np.float32)
    sig = np.full((BATCH,), 25 / 255, np.float32)
    noisy = (x + sig[:, None, None, None]
             * rng.standard_normal(x.shape)).astype(np.float32)
    return x, noisy, {"sigma": sig}, noisy


def test_dp_tracks_the_jax_update():
    """Three global batches of 8, each split over 4 ranks, against the JAX
    package's loss, ``jax.value_and_grad`` and optax update on the whole
    batch (the loss written as in ``tests/test_torch_train_step.py``):
    the first loss at 1e-5, the losses at 5e-3, and every leaf's gap to
    the JAX weights within 1e-3 of the distance that leaf moved (L2). At
    lr 1e-3 no weight moves more than about 3e-3 in three steps, so an
    absolute bar could not tell a wrong update; this one reads about 3e-6
    here, 1.0 for an update that is never applied, and 0.07 or more for
    one made from a rank's own gradient without the all-reduce."""
    from ssdn_tpu import estimator as jest
    from ssdn_tpu.models import blindspot_unet as jbu

    jc = _cfg(jcfg)
    st = jstep.init_state(jc)
    opt = jstep.make_optimizer(jc)

    def loss_fn(params, x, y, npar, i):
        out = jbu.apply(params, y, blindspot=True,
                        compute_dtype=jnp.float32,
                        conv_precision=jc.model.conv_precision,
                        decoder_mode=jc.model.decoder_mode)
        return jest.nll(out, y, jc.noise, npar,
                        blind_reg=jstep.blind_reg_schedule(jc)(i),
                        beta=jc.nll_beta, robust=jc.robust_nll,
                        bound=jc.bound_outputs)

    @jax.jit
    def step(params, ostate, x, y, npar, i):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(
            params, x, y, npar, i)
        updates, ostate = opt.update(g, ostate, params)
        return optax.apply_updates(params, updates), ostate, loss

    tree = jax.tree.map(np.asarray, st.params)
    batches = [_numpy_batch(100 + i) for i in range(3)]
    params, ostate, lj = st.params, st.opt_state, []
    for i, (x, y, npar, _) in enumerate(batches):
        params, ostate, loss = step(
            params, ostate, jnp.asarray(x), jnp.asarray(y),
            {k: jnp.asarray(v) for k, v in npar.items()}, i)
        lj.append(float(loss))
    lt, pt = torch_dist.run(torch_dist.dp_steps_on, 4, _cfg(tcfg), tree,
                            batches)[0]
    np.testing.assert_allclose(lt[0], lj[0], rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=5e-3)
    for layer, leaf in jax.tree.map(np.asarray, params).items():
        for key, w in leaf.items():
            moved = np.linalg.norm(w - tree[layer][key])
            gap = np.linalg.norm(pt[layer][key] - w)
            assert moved > 0 and gap <= 1e-3 * moved, (
                f"{layer}.{key}: |port - jax| {gap:.3g} against |moved| "
                f"{moved:.3g}")


# --------------------------- Trainer over DP ---------------------------


@pytest.fixture(scope="module")
def restarted(tmp_path_factory):
    """A 2-rank DP Trainer run of 4 steps (eval and snapshots every 2),
    then its step-4 checkpoint removed and the run restarted by a new
    spawn: (first run, restarted run, workdir)."""
    wd = str(tmp_path_factory.mktemp("dp_trainer"))
    cfg = _cfg(tcfg, iterations=4, eval_interval=2, snapshot_interval=2)
    args = (cfg, wd, "synthetic:8:64", "synthetic:2:64")
    first = torch_dist.run(torch_dist.trainer, 2, *args)
    os.remove(os.path.join(wd, "ckpt", f"step_{4:010d}.pt"))
    again = torch_dist.run(torch_dist.trainer, 2, *args)
    return first, again, wd


def test_dp_restart_is_exact(restarted):
    first, again, _ = restarted
    for run in (first, again):
        for rank in run:
            assert rank["step"] == 4
            _assert_params_close(rank["params"], run[0]["params"], rtol=0,
                                 atol=0)
    _assert_params_close(again[0]["params"], first[0]["params"], rtol=0,
                         atol=0)


def test_only_rank0_writes(restarted):
    first, again, wd = restarted
    for run in (first, again):
        assert run[0]["writes"], "rank 0 wrote nothing"
        assert run[1]["writes"] == []
    names = set(os.listdir(wd))
    assert {"ckpt", "ckpt_best", "best_psnr.json", "metrics.jsonl",
            "sampler_backend.json", "config.json"} <= names
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    # rank 0 alone logged: steps 2 and 4 (train, eval) in the first run,
    # step 4 again after the restart
    assert len(lines) == 6, lines


def test_only_rank0_reads_the_checkpoint(restarted):
    """The restart's checkpoint is read by rank 0 and broadcast: rank 1
    reads nothing of the workdir, so its ranks need not share one."""
    first, again, _ = restarted
    assert any(os.path.basename(p) == f"step_{2:010d}.pt"
               for p in again[0]["reads"]), again[0]["reads"]
    for run in (first, again):
        assert run[1]["reads"] == []


# ------------------------------ collectives ------------------------------


def test_ppermute_zeros_self_pair_and_slices():
    n = 3
    runs = torch_dist.run(torch_dist.ppermute_cases, n)
    for r, got in enumerate(runs):
        np.testing.assert_array_equal(got["fwd"], np.full((2, 3), float(r)))
        np.testing.assert_array_equal(got["rev"],
                                      np.full((2, 3), float(n - r)))
        np.testing.assert_array_equal(got["none"], np.zeros((2, 3)))
        src = (r - 1) % n
        x = np.arange(120, dtype=np.float32).reshape(2, 3, 4, 5) + 1000 * src
        np.testing.assert_array_equal(got["slice"], x[..., -1:])
        assert got["dtype"] == "torch.float64"


def test_shard_rows_refuses_a_batch_that_does_not_divide():
    three = [Group(rank=r, world=3, device=torch.device("cpu"),
                   backend="gloo") for r in range(3)]
    assert [shard_rows(torch.arange(9), g).tolist() for g in three] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8]]
    with pytest.raises(ValueError, match="does not divide"):
        shard_rows(torch.arange(8), three[1])
    ts = tstep.make_train_step(_cfg(tcfg), device="cpu", group=three[0])
    with pytest.raises(ValueError, match="does not divide"):
        ts(tstep.init_state(_cfg(tcfg), device="cpu"), _u8_batches(1)[0])
    with pytest.raises(AssertionError, match="does not divide"):
        torch_dist.run(torch_dist.shard_rows_of, 2, 7)


# ------------------------------ the CLI ------------------------------


def _train_cli(wd, *launcher):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    argv = [sys.executable, *launcher, "-m", "ssdn_tpu_torch.cli.train",
            "--device", "cpu", "--workdir", str(wd),
            "--train-data", "synthetic:8:64", "--eval-data",
            "synthetic:2:64", "--iterations", "4", "--batch-size", "4",
            "--patch-size", "32", "--eval-interval", "2",
            "--snapshot-interval", "2", "--log-interval", "1",
            "--sampler-backend", "python", *TINY_FLAGS]
    if launcher:
        argv.append("--data-parallel")
    return subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)


def test_cli_train_data_parallel_under_torchrun(tmp_path):
    dp = _train_cli(tmp_path / "dp", "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "2")
    assert dp.returncode == 0, dp.stderr[-3000:]
    one = _train_cli(tmp_path / "one")
    assert one.returncode == 0, one.stderr[-3000:]
    # only rank 0 printed the run's lines
    assert dp.stdout.count("training: ") == 1
    assert "data-parallel x2" in dp.stdout
    logs = {}
    for d in ("dp", "one"):
        with open(tmp_path / d / "metrics.jsonl") as f:
            logs[d] = [json.loads(line) for line in f]
    # the same log lines (rank 0's alone) and the same guard decisions: at
    # this width and batch the loss swings from batch to batch, and the
    # guard rolls back steps 2-4 in both runs
    assert [(m["step"], m["prefix"]) for m in logs["dp"]] == [
        (m["step"], m["prefix"]) for m in logs["one"]]
    guard = [line for line in one.stdout.splitlines() if "[guard @" in line]
    assert guard and guard == [line for line in dp.stdout.splitlines()
                               if "[guard @" in line]
    for a, b in zip(logs["dp"], logs["one"]):
        key = "loss" if a["prefix"] == "train" else "psnr"
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5)
    blobs = [torch.load(tmp_path / d / "ckpt" / f"step_{4:010d}.pt",
                        weights_only=True) for d in ("dp", "one")]
    for layer, leaf in blobs[1]["params"].items():
        for key, v in leaf.items():
            np.testing.assert_allclose(blobs[0]["params"][layer][key].numpy(),
                                       v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{layer}.{key}")
