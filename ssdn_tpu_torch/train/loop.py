"""Trainer: iteration loop, checkpoint/resume, eval hooks, metrics (port of
``ssdn_tpu/train/loop.py``; reference ``DenoiserTrainer`` [R]).

Checkpoints are ``torch.save`` files, one per step, written under a
temporary name and renamed into place, keep-last-K. The loader needs no
saved state beyond the step counter — batches are a pure function of
(seed, step) (data/sampler.py) and the step's noise generator is seeded
from (seed, step) (train/step.py) — so preemption-resume is exact.

Host syncs: the loop reads the loss once per guard window (the guard's
fetch) and the logged metrics once per log line; nothing is read back per
step. The guard's snapshot of the last good state is a device copy.

Data parallelism (``Trainer(..., group=)``, ``ssdn_tpu_torch.parallel``):
every rank runs the same sampler on the same seed and trains on its rows
of the global batch (``TrainStep``), so batches stay a function of (seed,
step) and resume stays exact. Only rank 0 writes the workdir and prints;
a barrier follows every save, and a restored checkpoint is read by rank 0
and broadcast. Every decision that changes the state (guard
rollback, rewind to best, early stop, best PSNR) reads rank 0's value,
broadcast, never a rank's own reading: cuDNN picks its algorithms per
process, so two ranks' own readings may differ in their last bits.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ssdn_tpu_torch.config import TrainConfig, to_json, train_config_from_json
from ssdn_tpu_torch.data import Prefetcher, open_dataset, to_device
from ssdn_tpu_torch.infer import evaluate_dataset
from ssdn_tpu_torch.parallel import Group, barrier, broadcast_tree_
from ssdn_tpu_torch.train.step import TrainState, init_state, make_train_step
from ssdn_tpu_torch.utils.debug import span
from ssdn_tpu_torch.utils.device import resolve_device


def save_config(workdir: str, cfg: TrainConfig) -> None:
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.json"), "w") as f:
        f.write(to_json(cfg))


def load_config(workdir: str) -> TrainConfig:
    with open(os.path.join(workdir, "config.json")) as f:
        return train_config_from_json(f.read())


def _clone_tree(tree):
    return {k: {n: t.clone() for n, t in leaf.items()}
            for k, leaf in tree.items()}


def _clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` on its device (the guard's snapshot)."""
    return TrainState(
        params=_clone_tree(state.params),
        opt_state={k: _clone_tree(v) for k, v in state.opt_state.items()},
        step=state.step)


class CheckpointManager:
    """Keep-last-K checkpoints of a TrainState: ``<workdir>/<subdir>/
    step_<N>.pt``, each a ``torch.save`` of params, opt_state and step.

    subdir "ckpt" holds the rolling keep-K snapshots; subdir "ckpt_best"
    (see Trainer._eval) holds the single best-by-eval-PSNR state — the one
    users generally want, since NLL loss health does not guarantee eval
    quality. Saves are synchronous, so ``wait_until_finished`` and
    ``close`` have nothing to wait for.
    """

    def __init__(self, workdir: str, cfg: TrainConfig, subdir: str = "ckpt",
                 max_to_keep: Optional[int] = None):
        self.cfg = cfg
        self.dir = os.path.abspath(os.path.join(workdir, subdir))
        self.max_to_keep = max_to_keep or cfg.keep_checkpoints
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(n[5:-3]) for n in os.listdir(self.dir)
                      if n.startswith("step_") and n.endswith(".pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, wait: bool = False) -> None:
        step = int(state.step)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"params": state.params, "opt_state": state.opt_state,
                    "step": step}, tmp)
        os.replace(tmp, path)  # a crash never leaves half a checkpoint
        for old in self.all_steps()[:-self.max_to_keep]:
            self.delete(old)

    def delete(self, step: int) -> None:
        os.remove(self._path(step))

    def restore(self, target: TrainState) -> TrainState:
        """The latest checkpoint, on the device of ``target``'s params;
        its layers must be ``target``'s."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        device = next(iter(next(iter(target.params.values())).values())).device
        blob = torch.load(self._path(step), map_location=device,
                          weights_only=True)
        if blob["params"].keys() != target.params.keys():
            raise ValueError(
                f"checkpoint {self._path(step)} has layers "
                f"{sorted(blob['params'])}, the config's model has "
                f"{sorted(target.params)}")
        return TrainState(params=blob["params"], opt_state=blob["opt_state"],
                          step=int(blob["step"]))

    def wait_until_finished(self) -> None:
        pass

    def close(self) -> None:
        pass


class MetricsLogger:
    """JSONL + stdout scalars; TensorBoard when tensorboardX is importable."""

    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self.jsonl_path = os.path.join(workdir, "metrics.jsonl")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter

            self.tb = SummaryWriter(os.path.join(workdir, "tb"))
        except ImportError:
            pass

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "train"):
        scalars = {k: float(v) for k, v in scalars.items()}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": step, "prefix": prefix, **scalars}) + "\n")
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{prefix}/{k}", v, step)

    def log_image(self, step: int, tag: str, img) -> None:
        """img: (H, W, C) float internal range — reference-style eval image
        grids."""
        if self.tb is None:
            return
        from ssdn_tpu_torch.utils.images import from_internal

        self.tb.add_image(tag, from_internal(np.asarray(img)), step,
                          dataformats="HWC")

    def close(self):
        if self.tb is not None:
            self.tb.close()


class _Silent:
    """The metrics logger of a rank other than 0: writes nothing."""

    def log(self, *args, **kwargs):
        pass

    log_image = close = log


def _quiet(*args, **kwargs):
    pass


class Trainer:
    """The training loop on ``device`` (default cuda; raises without a GPU
    unless device="cpu"). On the card, batches reach the step through the
    Prefetcher's workers, which copy them host-to-device on streams of
    their own (``data.to_device``). With a ``group`` the loop is data-
    parallel over its ranks on ``group.device`` (module docstring)."""

    def __init__(
        self,
        cfg: TrainConfig,
        workdir: str,
        train_data: str = "synthetic:64:128",
        eval_data: Optional[str] = None,
        log_interval: int = 100,
        sampler_backend: str = "auto",
        profile_dir: Optional[str] = None,
        profile_window: tuple = (10, 15),
        prefetch_depth: int = 12,
        prefetch_threads: int = 4,
        device=None,
        group: Optional[Group] = None,
    ):
        self.group = group
        self.rank0 = group is None or group.rank == 0
        self._print = print if self.rank0 else _quiet
        # profiling: a torch.profiler trace of the window that holds step
        # start + profile_window[0], written to profile_dir/trace.json
        self.profile_dir = profile_dir if self.rank0 else None
        self.profile_window = profile_window
        self.device = (group.device if group is not None
                       else resolve_device(device))
        self.cfg = cfg
        self.workdir = workdir
        self.log_interval = log_interval
        self.prefetch_depth = prefetch_depth
        self.prefetch_threads = prefetch_threads
        if self.rank0:
            save_config(workdir, cfg)
        self.dataset = open_dataset(train_data, grayscale=cfg.grayscale)
        self.eval_dataset = (
            open_dataset(eval_data, grayscale=cfg.grayscale)
            if eval_data
            else None
        )
        if getattr(self.eval_dataset, "streaming", False):
            # Fail fast: evaluate_dataset rejects streaming datasets, but
            # only at the FIRST eval — with the default eval_interval that
            # would be 10k steps of wasted device time before the error.
            raise ValueError(
                f"eval_data={eval_data!r} is a streaming (unbounded) "
                "dataset; evaluation needs a fixed finite set — use e.g. "
                "'synthetic:8' or an image folder"
            )
        # A 5-level U-Net trained on patches < 64 px does not extrapolate
        # to larger inference sizes — its deepest stages only ever see
        # 1x1/2x2 maps and specialize to that degenerate regime, so eval
        # PSNR on larger images DEGRADES as training proceeds (measured on
        # the JAX package: tests/test_psnr_regression.py's docstring).
        if self.eval_dataset is not None and cfg.patch_size < 64:
            try:
                eh, ew = self.eval_dataset[0].shape[:2]
            except Exception:
                eh = ew = 0
            if max(eh, ew) > cfg.patch_size:
                self._print(
                    f"[warn] training patch {cfg.patch_size}px is smaller "
                    f"than the eval images ({eh}x{ew}) and below the ~64px "
                    f"size-generalization floor of the 5-level U-Net: eval "
                    f"PSNR on larger images will degrade as deep stages "
                    f"specialize to tiny training maps. Train with "
                    f"--patch-size >= 64 for full-size inference.",
                    flush=True,
                )
        from ssdn_tpu_torch.native import NativePatchSampler, make_sampler

        # Pin the sampler backend across resumes: 'auto' re-decided per
        # environment would silently change the (deterministic) crop stream
        # mid-run if the native build outcome differs, breaking the
        # (seed, step) exact-resume contract. The first run records the
        # resolved backend; later runs reuse it.
        backend_path = os.path.join(workdir, "sampler_backend.json")
        # rank 0 alone reads the workdir (others take its backend below)
        if (self.rank0 and sampler_backend == "auto"
                and os.path.exists(backend_path)):
            with open(backend_path) as f:
                sampler_backend = json.load(f)["backend"]
        self.sampler = make_sampler(
            self.dataset, cfg.patch_size, cfg.batch_size, seed=cfg.seed,
            backend=sampler_backend,
        )
        resolved = (
            "native" if isinstance(self.sampler, NativePatchSampler)
            else "python"
        )
        if group is not None:
            # every rank must crop rank 0's batches: run rank 0's backend
            flag = torch.tensor([resolved == "native"], dtype=torch.int32,
                                device=self.device)
            want = ("native" if int(broadcast_tree_(flag, group)[0])
                    else "python")
            if want != resolved:
                self.sampler = make_sampler(
                    self.dataset, cfg.patch_size, cfg.batch_size,
                    seed=cfg.seed, backend=want)
                resolved = want
        if self.rank0 and not os.path.exists(backend_path):
            with open(backend_path, "w") as f:
                json.dump({"backend": resolved}, f)
        elif self.rank0:
            with open(backend_path) as f:
                recorded = json.load(f)["backend"]
            if recorded != resolved:
                print(
                    f"[warn] sampler backend changed across resume: "
                    f"recorded={recorded} resolved={resolved} — the crop "
                    f"stream will differ from the original run",
                    flush=True,
                )
        self.step_fn = make_train_step(cfg, device=self.device, group=group)
        self.ckpt = CheckpointManager(workdir, cfg)
        self.best_ckpt = CheckpointManager(workdir, cfg, subdir="ckpt_best",
                                           max_to_keep=1)
        # best_psnr persists across preemption-resume so a post-restart eval
        # can't overwrite ckpt_best with a worse state.
        self._best_path = os.path.join(workdir, "best_psnr.json")
        self.eval_bad_streak = 0
        self.best_psnr = float("-inf")
        if self.rank0 and os.path.exists(self._best_path):
            with open(self._best_path) as f:
                self.best_psnr = float(json.load(f)["psnr"])
        self.best_psnr = self._agreed(self.best_psnr)
        self.logger = MetricsLogger(workdir) if self.rank0 else _Silent()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _agreed(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (``value`` itself without a
        group): what every decision that changes the state reads."""
        if self.group is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        return float(broadcast_tree_(t, self.group)[0])

    def _save(self, mgr: CheckpointManager, state: TrainState) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        with span("ssdn.trainer.checkpoint"):
            if self.rank0:
                mgr.save(state)
            barrier(self.group)

    def _replicate(self, state: TrainState) -> TrainState:
        """Rank 0's state, step included, on every rank (``replicated``'s
        placement)."""
        if self.group is None:
            return state
        step = torch.tensor([state.step], dtype=torch.int64, device=self.device)
        broadcast_tree_({"p": state.params, "o": state.opt_state, "s": step},
                        self.group)
        return dataclasses.replace(state, step=int(step[0]))

    def _restore(self, mgr: CheckpointManager) -> TrainState:
        """``mgr``'s latest checkpoint on every rank: rank 0 reads it, the
        others receive it into a fresh state's buffers and read nothing of
        the workdir."""
        state = init_state(self.cfg, device=self.device)
        if self.rank0:
            state = mgr.restore(state)
        return self._replicate(state)

    def _eval(self, state: TrainState, step: int) -> Optional[float]:
        if self.eval_dataset is None:
            return None
        res = evaluate_dataset(
            self.cfg, state.params, self.eval_dataset, return_images=2,
            eval_batch=4,  # same-shaped eval sets batch per forward
            device=self.device, group=self.group,
        )
        psnr_mean = self._agreed(res["psnr_mean"])
        self.logger.log(
            step,
            {"psnr": psnr_mean, "noisy_psnr": res["noisy_psnr_mean"]},
            prefix="eval",
        )
        for i, trio in enumerate(res.get("images", [])):
            self.logger.log_image(step, f"eval/{i}/noisy", trio["noisy"])
            self.logger.log_image(step, f"eval/{i}/denoised", trio["denoised"])
        self._print(
            f"[eval @ {step}] psnr {psnr_mean:.3f} dB "
            f"(noisy {res['noisy_psnr_mean']:.3f})",
            flush=True,
        )
        if psnr_mean > self.best_psnr:
            self.best_psnr = psnr_mean
            self._save(self.best_ckpt, state)
            if self.rank0:
                with open(self._best_path, "w") as f:
                    json.dump({"psnr": self.best_psnr, "step": step}, f)
        # eval-quality degradation streak (TrainConfig.eval_patience)
        if psnr_mean < self.best_psnr - self.cfg.eval_patience_delta:
            self.eval_bad_streak += 1
        else:
            self.eval_bad_streak = 0
        return psnr_mean

    def _initial_state(self, resume: bool) -> TrainState:
        """The latest checkpoint with ``resume`` when there is one, else a
        fresh state (and the last run's best forgotten), on every rank."""
        cfg = self.cfg
        if resume and self._agreed(self.rank0
                                   and self.ckpt.latest_step() is not None):
            state = self._restore(self.ckpt)
            self._print(f"resumed from step {int(state.step)}", flush=True)
        else:
            # No checkpoint to resume => this run starts from step 0 even
            # with resume=True: a stale best_psnr.json / ckpt_best from a
            # previous run in this workdir would falsely trip eval-patience
            # and feed old weights to the guard escalation.
            if self.best_psnr != float("-inf"):
                self._print(
                    f"[fresh run] discarding stale best (psnr "
                    f"{self.best_psnr:.3f}) from a previous run in this "
                    "workdir",
                    flush=True,
                )
                self.best_psnr = float("-inf")
                self.eval_bad_streak = 0
                if self.rank0 and os.path.exists(self._best_path):
                    os.remove(self._best_path)
            if self.rank0:
                for s_ in self.best_ckpt.all_steps():
                    self.best_ckpt.delete(s_)
            barrier(self.group)
            state = self._replicate(init_state(cfg, device=self.device))
        return state

    def train(self, resume: bool = True) -> TrainState:
        cfg = self.cfg
        with span("ssdn.trainer.start"):
            state = self._initial_state(resume)
            start = int(state.step)
            todo = cfg.iterations - start
            if todo <= 0:
                return state
            good_state = _clone_state(state)  # the guard's snapshot
            # ONE prefetch pipeline spans the whole run: windows tile
            # [start, iterations) contiguously and a rollback advances the
            # step counter to window_end, so the iterator stays aligned
            # with the step counter either way.
            on_card = self.device.type == "cuda"
            prefetch = Prefetcher(
                self.sampler, start, todo,
                depth=self.prefetch_depth, n_threads=self.prefetch_threads,
                transform=to_device(self.device) if on_card else None,
            )
            batches = iter(prefetch)
        step = start

        # Loss-spike rollback guard: the NLL objective can nucleate a
        # runaway from a specific (weights, batch) interaction. Every
        # guard_check steps the loss scalar is fetched; a spike above the
        # EMA + margin (or non-finite) restores the last good state and
        # SKIPS past the offending data window (the sampler is step-indexed,
        # so skipping is just advancing the counter). The margin is scale-
        # aware — guard_margin_k times the EMA of the loss's absolute
        # deviation — so the same knobs fit NLL (negative, noise-model-
        # dependent scale) and MSE (~1e-2 scale) pipelines.
        guard_on = cfg.guard_check > 0
        # window length when the guard is off: the log cadence, with a
        # positive floor — guard_check=0 + log_interval=0 must not create
        # zero-length windows (metrics=None crash)
        guard_check = (
            cfg.guard_check if guard_on
            else (self.log_interval if self.log_interval > 0 else 100)
        )
        guard_max_consecutive = cfg.guard_max_consecutive
        guard_loss_ema = None
        guard_dev_ema = None  # EMA of |loss - ema|; sets the relative margin
        guard_streak = 0
        guard_escalated = False  # rewind-to-best fires once per streak

        def guard_margin():
            if guard_dev_ema is None:
                return cfg.guard_margin_floor
            return max(cfg.guard_margin_floor,
                       cfg.guard_margin_k * guard_dev_ema)

        profiled = False

        def run_window(state, from_step, to_step):
            nonlocal profiled
            if (
                self.profile_dir is not None
                and not profiled
                and from_step <= start + self.profile_window[0] < to_step
            ):
                profiled = True
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if on_card else [])
                with profile(activities=acts) as prof:
                    state, metrics = run_window(state, from_step, to_step)
                    self._sync()
                os.makedirs(self.profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(self.profile_dir, "trace.json"))
                return state, metrics
            metrics = None
            for _ in range(to_step - from_step):
                with span("ssdn.trainer.next_batch"):
                    batch = next(batches)
                    if on_card:
                        batch = batch.wait()
                state, metrics = self.step_fn(state, batch)
            return state, metrics

        t0, tn0 = time.perf_counter(), start
        try:
            while step < cfg.iterations:
                window_end = min(step + guard_check, cfg.iterations)
                # align windows to log/eval/snapshot boundaries
                for iv in (self.log_interval, cfg.eval_interval,
                           cfg.snapshot_interval):
                    if iv > 0:  # interval <= 0 disables the hook
                        nxt = (step // iv + 1) * iv
                        window_end = min(window_end, nxt)
                state, metrics = run_window(state, step, window_end)
                with span("ssdn.trainer.guard"):
                    # the window's one host sync (rank 0's, on every rank)
                    loss = self._agreed(float(metrics["loss"]))
                    if not np.isfinite(loss) or (
                        guard_on
                        and guard_loss_ema is not None
                        and loss > guard_loss_ema + guard_margin()
                    ):
                        self._print(
                            f"[guard @ {window_end}] loss {loss:.3f} vs ema "
                            f"{guard_loss_ema if guard_loss_ema is None else round(guard_loss_ema, 3)}"
                            f" (margin {guard_margin():.3g})"
                            f" — rolling back and skipping the window",
                            flush=True,
                        )
                        # restore last good params/opt state; skip the window's
                        # data by advancing the step counter without training
                        state = dataclasses.replace(_clone_state(good_state),
                                                    step=window_end)
                        step = window_end
                        guard_streak += 1
                        # Escalation: restore-and-skip can re-spike every window
                        # when the snapshot is already inside an unstable basin.
                        # Halfway to the early-stop limit, rewind the WEIGHTS to
                        # the best-by-eval-PSNR checkpoint while keeping the
                        # step counter, so training resumes from a known-good
                        # basin on fresh data. `>=` + a fired-once flag: if
                        # ckpt_best does not exist at the exact halfway streak,
                        # re-check on every later rollback.
                        if (
                            not guard_escalated
                            and guard_streak >= max(guard_max_consecutive // 2, 1)
                            and self._agreed(
                                self.rank0
                                and self.best_ckpt.latest_step() is not None)
                        ):
                            guard_escalated = True
                            self._print(
                                f"[guard @ {window_end}] {guard_streak} consecutive "
                                "rollbacks — rewinding weights to ckpt_best "
                                "(step counter keeps advancing)",
                                flush=True,
                            )
                            best = self._restore(self.best_ckpt)
                            state = dataclasses.replace(best, step=window_end)
                            good_state = _clone_state(state)
                            # keep the loss EMA/deviation stats: they describe
                            # the healthy basin being rewound to, so continued
                            # spiking still counts toward the early-stop limit
                        if guard_streak >= guard_max_consecutive:
                            self._print(
                                f"[guard] {guard_streak} consecutive rollbacks — "
                                "training has reached an unstable region; "
                                "early-stopping at the last good state",
                                flush=True,
                            )
                            self._save(self.ckpt, state)
                            break
                        continue
                    guard_streak = 0
                    guard_escalated = False
                    if guard_loss_ema is None:
                        guard_loss_ema = loss
                    else:
                        dev = abs(loss - guard_loss_ema)
                        guard_dev_ema = (
                            dev if guard_dev_ema is None
                            else 0.9 * guard_dev_ema + 0.1 * dev
                        )
                        guard_loss_ema = 0.9 * guard_loss_ema + 0.1 * loss
                    good_state = _clone_state(state)
                step = next_step = window_end
                if (self.log_interval > 0 and next_step % self.log_interval == 0) or next_step == cfg.iterations:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    m["patches_per_sec"] = (
                        (next_step - tn0) * cfg.batch_size / max(dt, 1e-9)
                    )
                    t0, tn0 = time.perf_counter(), next_step
                    self.logger.log(next_step, m)
                    self._print(
                        f"[{next_step}/{cfg.iterations}] loss {m['loss']:.4f} "
                        f"({m['patches_per_sec']:.1f} patches/s)",
                        flush=True,
                    )
                if cfg.eval_interval > 0 and next_step % cfg.eval_interval == 0:
                    with span("ssdn.trainer.eval"):
                        self._eval(state, next_step)
                    if (
                        cfg.eval_patience > 0
                        and self.eval_bad_streak >= cfg.eval_patience
                    ):
                        self._print(
                            f"[eval-patience @ {next_step}] {self.eval_bad_streak} "
                            f"consecutive evals > {cfg.eval_patience_delta:g} dB "
                            f"below the best ({self.best_psnr:.3f}) — early "
                            "stop; ckpt_best holds the best state",
                            flush=True,
                        )
                        break
                if (
                    (cfg.snapshot_interval > 0
                     and next_step % cfg.snapshot_interval == 0)
                    or next_step == cfg.iterations
                ):
                    self._save(self.ckpt, state)
            # unconditional final save — a guard rollback on the last
            # window would otherwise skip the final snapshot
            if self._agreed(self.ckpt.latest_step() != int(state.step)):
                self._save(self.ckpt, state)
        finally:
            with span("ssdn.trainer.checkpoint"):
                prefetch.close()
                self.ckpt.wait_until_finished()
                self.best_ckpt.wait_until_finished()
            self.logger.close()
        return state
