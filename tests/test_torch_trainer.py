"""The port's Trainer (``ssdn_tpu_torch/train/loop.py``) on the CPU: its
versions of ``tests/test_trainer_guard.py``, ``tests/test_eval_patience.py``
and ``tests/test_parallel_and_resume.py::test_checkpoint_resume_exact``
(bitwise), exact resume through the Trainer itself, and a loop-parity test
that drives a JAX ``Trainer`` and a port ``Trainer`` with the same stub
step and the same scripted losses and eval PSNRs: both must see the same
batches (bit for bit) and take the same guard, rollback, checkpoint and
eval decisions."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.train.loop as jloop
from ssdn_tpu.config import ModelConfig as JModelConfig
from ssdn_tpu.config import TrainConfig as JTrainConfig
from ssdn_tpu.config import parse_noise_style as jparse_noise_style
from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style
from ssdn_tpu_torch.data import PatchSampler, synthetic_dataset
from ssdn_tpu_torch.train import loop
from ssdn_tpu_torch.train.loop import CheckpointManager, Trainer
from ssdn_tpu_torch.train.step import init_state, make_train_step

TINY_MODEL = dict(enc_features=8, dec_features=16, nin_a_features=32,
                  nin_b_features=16, compute_dtype="float32")


def guard_cfg(**kw):
    kw.setdefault("guard_check", 2)
    return TrainConfig(
        noise=parse_noise_style("gauss25"),
        model=ModelConfig(in_channels=3, **TINY_MODEL),
        patch_size=32,
        batch_size=2,
        iterations=16,
        eval_interval=10_000,
        snapshot_interval=10_000,
        seed=3,
        **kw,
    )


def trainer(cfg, wd, **kw):
    return Trainer(cfg, str(wd), train_data="synthetic:6:64", device="cpu",
                   **kw)


def run_with_scripted_losses(tmp_path, losses, cfg=None, subdir="w"):
    """Run Trainer.train with step_fn's loss overridden by a per-window
    script (one entry per guard window, cycled)."""
    cfg = cfg or guard_cfg()
    tr = trainer(cfg, tmp_path / subdir, log_interval=1000)
    real = tr.step_fn
    window = {"i": -1}

    def scripted(state, batch):
        state, m = real(state, batch)
        window["i"] += 1
        per = max(cfg.guard_check, 1)
        val = losses[min(window["i"] // per, len(losses) - 1)]
        return state, {**m, "loss": torch.tensor(val, dtype=torch.float32)}

    tr.step_fn = scripted
    state = tr.train(resume=False)
    return state, tr


# ---------------- the port's version of tests/test_trainer_guard.py ----------------


def test_guard_triggers_on_mse_scale_spike(tmp_path, capsys):
    losses = [0.010, 0.011, 0.010, 0.011, 0.010, 0.25, 0.010, 0.011]
    state, _ = run_with_scripted_losses(tmp_path, losses, subdir="mse")
    assert "[guard @" in capsys.readouterr().out
    assert state.step == 16  # skipped past the window, finished


def test_guard_triggers_on_negative_nll_spike(tmp_path, capsys):
    losses = [-2.00, -1.99, -2.00, -2.01, -2.00, -1.60, -2.00, -2.00]
    state, _ = run_with_scripted_losses(tmp_path, losses, subdir="nll")
    assert "[guard @" in capsys.readouterr().out
    assert state.step == 16


def test_guard_no_false_trigger_on_normal_decrease(tmp_path, capsys):
    losses = [1.0, 0.9, 0.85, 0.8, 0.78, 0.74, 0.7, 0.69]
    state, _ = run_with_scripted_losses(tmp_path, losses, subdir="ok")
    assert "[guard @" not in capsys.readouterr().out
    assert state.step == 16


def test_guard_disabled(tmp_path, capsys):
    cfg = guard_cfg(guard_check=0)
    state, _ = run_with_scripted_losses(tmp_path, [0.01, 0.25, 0.01, 0.25],
                                        cfg=cfg, subdir="off")
    assert "[guard @" not in capsys.readouterr().out
    assert state.step == 16


def test_best_psnr_persists_across_trainer_restart(tmp_path):
    cfg = guard_cfg()
    wd = tmp_path / "bp"
    tr = trainer(cfg, wd)
    assert tr.best_psnr == float("-inf")
    with open(wd / "best_psnr.json", "w") as f:
        json.dump({"psnr": 30.5, "step": 8}, f)
    assert trainer(cfg, wd).best_psnr == 30.5


def test_sampler_backend_pinned_across_restart(tmp_path):
    from ssdn_tpu_torch.native import NativePatchSampler

    cfg = guard_cfg()
    wd = tmp_path / "sb"
    trainer(cfg, wd)
    with open(wd / "sampler_backend.json") as f:
        recorded = json.load(f)["backend"]
    assert recorded in ("native", "python")
    tr2 = trainer(cfg, wd)
    resolved = ("native" if isinstance(tr2.sampler, NativePatchSampler)
                else "python")
    assert resolved == recorded


def test_guard_rewinds_to_best_on_sustained_rollbacks(tmp_path, capsys):
    """At guard_max_consecutive//2 consecutive rollbacks the trainer
    rewinds the weights to ckpt_best, keeping the step counter; sustained
    spiking still early-stops at the full limit."""
    cfg = dataclasses.replace(guard_cfg(guard_max_consecutive=4),
                              iterations=40)
    tr = trainer(cfg, tmp_path / "resc", log_interval=1000)
    best = init_state(cfg, device="cpu")
    marker = torch.full_like(best.params["enc0"]["b"], 0.123)
    best = dataclasses.replace(
        best, params={**best.params,
                      "enc0": {**best.params["enc0"], "b": marker}},
        step=6)
    captured = {}
    real = tr.step_fn
    window = {"i": -1}
    losses = [-2.0, -2.0, -2.0, 5.0]  # stable, then spike forever

    def scripted(state, batch):
        state, m = real(state, batch)
        window["i"] += 1
        if window["i"] == 0:
            # plant the best DURING the run (as _eval would): train() on a
            # fresh start rightly clears any pre-existing ckpt_best
            tr.best_ckpt.save(best, wait=True)
        per = max(cfg.guard_check, 1)
        val = losses[min(window["i"] // per, len(losses) - 1)]
        captured["enc0_b"] = state.params["enc0"]["b"].numpy().copy()
        return state, {**m, "loss": torch.tensor(val)}

    tr.step_fn = scripted
    tr.train(resume=False)
    out = capsys.readouterr().out
    assert "rewinding weights to ckpt_best" in out
    assert "early-stopping" in out
    # the windows after the rewind trained FROM the planted best params
    np.testing.assert_allclose(captured["enc0_b"], 0.123, atol=0.05)


def test_all_intervals_disabled_still_trains(tmp_path):
    cfg = guard_cfg(guard_check=0)
    tr = trainer(cfg, tmp_path / "nolog", log_interval=0)
    assert tr.train(resume=False).step == cfg.iterations


def test_fresh_run_discards_stale_best(tmp_path, capsys):
    cfg = guard_cfg()
    wd = tmp_path / "stale"
    tr = trainer(cfg, wd, log_interval=1000)
    tr.best_ckpt.save(dataclasses.replace(init_state(cfg, device="cpu"),
                                          step=4), wait=True)
    with open(wd / "best_psnr.json", "w") as f:
        json.dump({"psnr": 55.0, "step": 4}, f)
    tr2 = trainer(cfg, wd, log_interval=1000)
    assert tr2.best_psnr == 55.0  # loaded (resume case would keep it)
    tr2.train(resume=False)
    out = capsys.readouterr().out
    assert "discarding stale best" in out
    assert tr2.best_psnr != 55.0
    assert tr2.best_ckpt.latest_step() is None
    assert not os.path.exists(wd / "best_psnr.json")


# -------------- the port's version of tests/test_eval_patience.py --------------


def patience_cfg(**kw):
    return TrainConfig(
        noise=parse_noise_style("gauss25"),
        model=ModelConfig(in_channels=3, **TINY_MODEL),
        patch_size=32, batch_size=2, iterations=20, eval_interval=2,
        snapshot_interval=10_000, guard_check=0, seed=3, **kw)


def run_with_scripted_psnrs(tmp_path, psnrs, cfg, monkeypatch, subdir="w"):
    tr = Trainer(cfg, str(tmp_path / subdir), train_data="synthetic:6:64",
                 eval_data="synthetic:2:64", log_interval=1000, device="cpu")
    seq = {"i": 0}

    def fake_eval(cfg_, params, dataset, **kw):
        v = psnrs[min(seq["i"], len(psnrs) - 1)]
        seq["i"] += 1
        return {"psnr_mean": v, "psnr_per_image": [v],
                "noisy_psnr_mean": 20.0, "n_images": 1}

    monkeypatch.setattr(loop, "evaluate_dataset", fake_eval)
    return tr, tr.train(resume=False)


def test_early_stop_on_sustained_degradation(tmp_path, capsys, monkeypatch):
    cfg = patience_cfg(eval_patience=3, eval_patience_delta=1.0)
    tr, state = run_with_scripted_psnrs(
        tmp_path, [30.0, 28.0, 27.5, 27.0, 26.0, 25.0], cfg, monkeypatch)
    assert "eval-patience" in capsys.readouterr().out
    assert state.step == 8  # the 4th eval, long before iterations=20
    assert tr.best_psnr == 30.0
    with open(tmp_path / "w" / "best_psnr.json") as f:
        assert json.load(f)["psnr"] == 30.0


def test_recovery_resets_the_streak(tmp_path, capsys, monkeypatch):
    cfg = patience_cfg(eval_patience=3, eval_patience_delta=1.0)
    tr, state = run_with_scripted_psnrs(
        tmp_path, [30.0, 28.0, 28.0, 29.5, 28.0, 28.0, 29.6, 28.0, 29.5,
                   29.5], cfg, monkeypatch)
    assert "eval-patience" not in capsys.readouterr().out
    assert state.step == cfg.iterations


def test_disabled_by_default(tmp_path, capsys, monkeypatch):
    cfg = patience_cfg()  # eval_patience = 0
    tr, state = run_with_scripted_psnrs(
        tmp_path, [30.0, 20.0, 20.0, 20.0, 20.0], cfg, monkeypatch)
    assert "eval-patience" not in capsys.readouterr().out
    assert state.step == cfg.iterations


# ------------------------------ resume ------------------------------


def _params_equal(a, b):
    for name in a:
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)


def test_checkpoint_resume_exact(tmp_path):
    """Save -> restore -> continue equals the uninterrupted run, bit for
    bit on the CPU."""
    cfg = dataclasses.replace(guard_cfg(), batch_size=8, iterations=100,
                              lr=1e-3)
    s = PatchSampler(synthetic_dataset(n=6, size=64, channels=3, seed=2),
                     cfg.patch_size, cfg.batch_size, seed=cfg.seed)
    bs = [s.sample(i) for i in range(6)]
    step = make_train_step(cfg, device="cpu")
    full = init_state(cfg, device="cpu")
    for b in bs:
        full, _ = step(full, b)
    part = init_state(cfg, device="cpu")
    for b in bs[:3]:
        part, _ = step(part, b)
    ck = CheckpointManager(str(tmp_path), cfg)
    ck.save(part, wait=True)
    restored = ck.restore(init_state(cfg, device="cpu"))
    assert restored.step == 3
    for b in bs[3:]:
        restored, _ = step(restored, b)
    _params_equal(full.params, restored.params)
    _params_equal(full.opt_state["nu"], restored.opt_state["nu"])


class _Preempted(Exception):
    pass


def test_trainer_resume_after_preemption_is_exact(tmp_path):
    """A Trainer stopped after its step-4 snapshot and a new Trainer on the
    same workdir end, at step 8, with the uninterrupted run's bits."""
    cfg = dataclasses.replace(guard_cfg(guard_check=0), iterations=8,
                              snapshot_interval=4)
    full = trainer(cfg, tmp_path / "full", log_interval=2).train()
    tr = trainer(cfg, tmp_path / "cut", log_interval=2)
    real = tr.step_fn

    def preempted(state, batch):
        if state.step == 4:
            raise _Preempted
        return real(state, batch)

    tr.step_fn = preempted
    with pytest.raises(_Preempted):
        tr.train()
    assert tr.ckpt.latest_step() == 4
    resumed = trainer(cfg, tmp_path / "cut", log_interval=2).train()
    assert resumed.step == 8
    _params_equal(full.params, resumed.params)


def test_checkpoints_keep_the_last_k(tmp_path):
    cfg = dataclasses.replace(guard_cfg(), keep_checkpoints=2)
    ck = CheckpointManager(str(tmp_path), cfg)
    state = init_state(cfg, device="cpu")
    for s in (1, 2, 5, 9):
        ck.save(dataclasses.replace(state, step=s))
    assert ck.all_steps() == [5, 9]
    assert ck.restore(state).step == 9
    assert not [n for n in os.listdir(ck.dir) if n.endswith(".tmp")]


def test_trainer_needs_a_gpu_unless_cpu(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(guard_cfg(), str(tmp_path), train_data="synthetic:6:64")


# ------------------------------ loop parity ------------------------------

# the step executed at each listed index returns a spike: one isolated
# spike, a sustained run (rollbacks, then the rewind to ckpt_best), a
# recovery, then spikes to the early stop
SPIKES = {9} | set(range(17, 22)) | set(range(33, 60))


def _scripted_loss(step):
    return 5.0 if step in SPIKES else 1.0 - 0.01 * step + 0.002 * (step % 3)


PSNRS = [20.0, 22.0, 21.5, 25.0, 24.0, 26.0, 23.0, 22.0, 21.0]


def _run_parity_side(jax_side, tmp_path, monkeypatch, capsys):
    kw = dict(patch_size=32, batch_size=2, iterations=50, eval_interval=4,
              snapshot_interval=6, guard_check=2, guard_max_consecutive=6,
              seed=5, keep_checkpoints=2)
    if jax_side:
        cfg = JTrainConfig(noise=jparse_noise_style("gauss25"),
                           model=JModelConfig(in_channels=3, **TINY_MODEL),
                           **kw)
        tr = jloop.Trainer(cfg, str(tmp_path / "jax"),
                           train_data="synthetic:6:64",
                           eval_data="synthetic:2:64", log_interval=5,
                           sampler_backend="python")
    else:
        cfg = TrainConfig(noise=parse_noise_style("gauss25"),
                          model=ModelConfig(in_channels=3, **TINY_MODEL),
                          **kw)
        tr = Trainer(cfg, str(tmp_path / "torch"),
                     train_data="synthetic:6:64", eval_data="synthetic:2:64",
                     log_interval=5, sampler_backend="python", device="cpu")
    seen, saves, evals = [], [], []

    def stub_step(state, batch):
        s = int(state.step)
        seen.append((s, np.asarray(batch).tobytes()))
        if jax_side:
            return (state.replace(step=state.step + 1),
                    {"loss": jnp.asarray(_scripted_loss(s), jnp.float32)})
        return (dataclasses.replace(state, step=s + 1),
                {"loss": torch.tensor(_scripted_loss(s))})

    def fake_eval(cfg_, params, dataset, **kw):
        v = PSNRS[min(len(evals) - 1, len(PSNRS) - 1)]
        return {"psnr_mean": v, "psnr_per_image": [v],
                "noisy_psnr_mean": 20.0, "n_images": 1}

    def recording(kind, fn):
        def wrapped(state, *a, **k):
            saves.append((kind, int(state.step)))
            return fn(state, *a, **k)
        return wrapped

    orig_eval = tr._eval
    tr._eval = lambda state, step: (evals.append(step), orig_eval(state, step))[1]
    tr.step_fn = stub_step
    tr.ckpt.save = recording("ckpt", tr.ckpt.save)
    tr.best_ckpt.save = recording("best", tr.best_ckpt.save)
    monkeypatch.setattr(jloop if jax_side else loop, "evaluate_dataset",
                        fake_eval)
    capsys.readouterr()
    state = tr.train(resume=False)
    # every bracketed status line (log, guard, eval), without the timing
    lines = [ln.split(" (")[0] if "patches/s" in ln else ln
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[")]
    ckpt_steps = (list(tr.ckpt.mgr.all_steps()) if jax_side
                  else tr.ckpt.all_steps())
    return dict(seen=seen, saves=saves, evals=evals, lines=lines,
                final_step=int(state.step), ckpt_steps=sorted(ckpt_steps))


def test_loop_control_flow_matches_the_jax_trainer(tmp_path, monkeypatch,
                                                  capsys):
    ours = _run_parity_side(False, tmp_path, monkeypatch, capsys)
    theirs = _run_parity_side(True, tmp_path, monkeypatch, capsys)
    assert any("rolling back" in ln for ln in ours["lines"])
    assert any("rewinding weights to ckpt_best" in ln for ln in ours["lines"])
    assert any("early-stopping" in ln for ln in ours["lines"])
    assert [s for s, _ in ours["seen"]] == [s for s, _ in theirs["seen"]]
    for (s, a), (_, b) in zip(ours["seen"], theirs["seen"]):
        assert a == b, f"batch of step {s} differs"
    assert ours["lines"] == theirs["lines"]
    assert ours["evals"] == theirs["evals"]
    assert ours["saves"] == theirs["saves"]
    assert ours["ckpt_steps"] == theirs["ckpt_steps"]
    assert ours["final_step"] == theirs["final_step"]


def test_step_noise_depends_on_the_seed_and_the_step():
    """The CPU generator keeps only the low 32 bits of its seed: the
    step's seed must mix cfg.seed into them."""
    batch = np.full((2, 32, 32, 3), 128, np.uint8)
    noise = {}
    for seed, step in ((0, 3), (1, 3), (0, 4)):
        ts = make_train_step(dataclasses.replace(guard_cfg(), seed=seed),
                             device="cpu")
        x, y, _, _ = ts.noisy_batch(batch, step)
        noise[seed, step] = y - x
    assert not torch.equal(noise[0, 3], noise[1, 3])
    assert not torch.equal(noise[0, 3], noise[0, 4])
