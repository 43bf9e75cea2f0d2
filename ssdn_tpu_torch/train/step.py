"""The training step, in PyTorch (port of ``ssdn_tpu/train/step.py``).

One step: uint8 batch -> [-1/2, 1/2] on the device -> noise injection on
the device -> rotation-folded blind-spot forward -> loss -> grads -> Adam.
The forward runs in the configured backend arm (torch ops, or the CUDA
kernels through their autograd Functions), so the same step trains in all
three.

RNG: the step's generator is seeded from (seed, step), so training is a
function of (params0, data, seed) and resuming needs no RNG state beyond
the step counter (the JAX package folds the step into its key the same
way; the two draw different numbers).

The optimizer is optax's Adam written out (b1 0.9, b2 0.99 by default,
eps added outside the square root, bias-corrected moments), behind an
optional global-norm clip in optax's form; the learning rate and the blind
regulariser weight are read at the pre-increment step, as optax's
schedules are. Updates are functional: a step returns new tensors and
leaves the state it was given as it was.

Data parallelism (``group``, ``ssdn_tpu_torch.parallel``): every rank draws
the GLOBAL noisy batch from the step's generator and keeps its rows, so a
DP step is the single-device step at the same seed, as the JAX package's
sharded jit is. The gradients are averaged over the ranks between
``loss_and_grads`` and ``apply_grads`` (the clip sees the global norm), the
beta-NLL weights are normalised by their mean over every rank's rows, and
the metrics are averaged over the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ssdn_tpu_torch import estimator
from ssdn_tpu_torch.config import (
    NoiseModel,
    NoiseValue,
    Pipeline,
    TrainConfig,
    n_output_channels,
)
from ssdn_tpu_torch.models import blindspot_unet
from ssdn_tpu_torch.noise import add_noise
from ssdn_tpu_torch.parallel import Group, mean_grads_, pmean, shard_rows
from ssdn_tpu_torch.utils.debug import span
from ssdn_tpu_torch.utils.device import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class TrainState:
    """params: the model's ``{layer: {leaf: tensor}}`` tree (plus
    ``noise_scalar/raw`` for constant-blind SSDN); opt_state: Adam's first
    and second moments ``{"mu": tree, "nu": tree}``; step: the number of
    updates taken (Adam's bias-correction count)."""

    params: Params
    opt_state: Dict[str, Params]
    step: int = 0


def pipeline_blindspot(pipeline: Pipeline) -> bool:
    return pipeline in (Pipeline.SSDN, Pipeline.SSDN_MSE)


def _cosine_rampdown(step: int, iterations: int, frac: float) -> float:
    t = step / max(iterations, 1)
    v = min(max((1.0 - t) / frac, 0.0), 1.0)
    return 0.5 - 0.5 * math.cos(v * math.pi)


def lr_schedule(cfg: TrainConfig):
    """Constant LR with a cosine ramp-down over the final
    ``lr_rampdown_frac`` of training; step -> float."""

    def schedule(step: int) -> float:
        if cfg.lr_rampdown_frac <= 0:
            return cfg.lr
        return cfg.lr * _cosine_rampdown(step, cfg.iterations,
                                         cfg.lr_rampdown_frac)

    return schedule


def blind_reg_schedule(cfg: TrainConfig):
    """The blind regulariser's weight: ``blind_reg``, cosined to 0 over the
    final ``blind_reg_rampdown_frac`` of training; step -> float."""

    def schedule(step: int) -> float:
        if cfg.blind_reg_rampdown_frac <= 0:
            return cfg.blind_reg
        return cfg.blind_reg * _cosine_rampdown(
            step, cfg.iterations, cfg.blind_reg_rampdown_frac)

    return schedule


def _blind_const_init(cfg: TrainConfig) -> float:
    """Raw init of the BLIND_CONST free scalar: softplus^-1(0.1) (~sigma
    25/255) for Gaussian/Poisson, 0 (alpha 0.5) for impulse."""
    if cfg.noise.model == NoiseModel.IMPULSE:
        return 0.0
    return math.log(math.expm1(0.1))


def _map(fn, *trees) -> Params:
    return {name: {k: fn(*(t[name][k] for t in trees)) for k in leaf}
            for name, leaf in trees[0].items()}


def _leaves(tree: Params):
    return [t for leaf in tree.values() for t in leaf.values()]


def state_from_params(params: Params) -> TrainState:
    """A fresh TrainState (zero Adam moments, step 0) around ``params``."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return TrainState(params=params,
                      opt_state={"mu": _map(zeros, params),
                                 "nu": _map(zeros, params)})


def init_state(cfg: TrainConfig, *, device=None) -> TrainState:
    """He-normal params from a CPU generator seeded with ``cfg.seed`` (the
    same on every device), placed on ``device`` (default cuda)."""
    dev = resolve_device(device)
    c = cfg.model.in_channels
    params = blindspot_unet.init_params(
        torch.Generator().manual_seed(cfg.seed), c,
        n_output_channels(cfg.pipeline, cfg.noise, c),
        blindspot=pipeline_blindspot(cfg.pipeline),
        enc=cfg.model.enc_features, dec=cfg.model.dec_features,
        nin_a=cfg.model.nin_a_features, nin_b=cfg.model.nin_b_features,
        device=dev)
    if (cfg.pipeline == Pipeline.SSDN
            and cfg.noise.value == NoiseValue.BLIND_CONST):
        params["noise_scalar"] = {
            "raw": torch.tensor(_blind_const_init(cfg), device=dev)}
    return state_from_params(params)


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a 63-bit hash of (seed,
    step). Every bit depends on both, because the CPU generator keeps only
    the low 32 bits of its seed (packing seed and step side by side made
    the CPU's noise ignore the seed)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, step % 2 ** 64])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class TrainStep:
    """``step(state, batch_u8) -> (state, metrics)``; ``step_on`` takes an
    already noisy batch (the tests feed both packages one numpy batch).
    With a ``group``, ``batch_u8`` is the global batch and ``step_on`` takes
    the rank's rows."""

    def __init__(self, cfg: TrainConfig, *, device=None,
                 group: Optional[Group] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        self.blindspot = pipeline_blindspot(cfg.pipeline)
        self.compute_dtype = getattr(torch, cfg.model.compute_dtype)
        self.lr = lr_schedule(cfg)
        self.blind_reg = blind_reg_schedule(cfg)

    def forward(self, params: Params, y: torch.Tensor) -> torch.Tensor:
        m = self.cfg.model
        return blindspot_unet.apply(
            params, y, blindspot=self.blindspot,
            compute_dtype=self.compute_dtype, conv_backend=m.conv_backend,
            conv_precision=m.conv_precision, decoder_mode=m.decoder_mode,
            head_backend=m.head_backend)

    def noisy_batch(self, batch_u8, step: int):
        """(x, y, noise_params, y2): the clean batch in [-1/2, 1/2], its
        noisy copy, the true noise parameters, and for N2N an independent
        second noisy copy (else None), drawn from step ``step``'s
        generator on the device."""
        x = torch.as_tensor(batch_u8).to(self.device).float() / 255.0 - 0.5
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.cfg.seed, step))
        y, noise_params = add_noise(gen, x, self.cfg.noise)
        y2 = (add_noise(gen, x, self.cfg.noise)[0]
              if self.cfg.pipeline == Pipeline.N2N else None)
        return x, y, noise_params, y2

    def loss(self, params: Params, x, y, noise_params, y2=None, step: int = 0):
        """(loss, aux) of the configured pipeline, over the rows given."""
        cfg = self.cfg
        group = self.group
        batch_mean = (torch.mean if group is None
                      else lambda t: pmean(torch.mean(t), group))
        if cfg.pipeline == Pipeline.SSDN:
            out = self.forward(params, y)
            if "noise_scalar" in params:
                # BLIND_CONST: the learned scalar feeds the estimator, and
                # its gradient flows back through the NLL
                noise_params = {**noise_params,
                                "raw_scale": params["noise_scalar"]["raw"]}
            return estimator.nll(
                out, y, cfg.noise, noise_params,
                blind_reg=self.blind_reg(step), beta=cfg.nll_beta,
                robust=cfg.robust_nll, bound=cfg.bound_outputs,
                batch_mean=batch_mean)
        if cfg.pipeline == Pipeline.SSDN_MSE:
            # mu-only ablation against the noisy target (the blind spot
            # rules out the identity)
            out = self.forward(params, y)
            return estimator.mse_loss(
                estimator.mu_only(out, x.shape[-1]), y), {}
        if cfg.pipeline == Pipeline.N2C:
            return estimator.mse_loss(self.forward(params, y), x), {}
        if cfg.pipeline == Pipeline.N2N:
            return estimator.mse_loss(self.forward(params, y), y2), {}
        raise ValueError(cfg.pipeline)

    def loss_and_grads(self, params: Params, x, y, noise_params, y2=None,
                       step: int = 0):
        """(loss, aux, grads): the loss and its gradient with respect to
        every leaf of ``params`` (a tree of the same shape)."""
        live = _map(lambda p: p.detach().requires_grad_(True), params)
        with span("ssdn.train.loss"):
            loss, aux = self.loss(live, x, y, noise_params, y2, step)
        leaves = _leaves(live)
        with span("ssdn.train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads, leaves))
        return loss.detach(), aux, _map(lambda _: next(it), live)

    def apply_grads(self, state: TrainState, grads: Params) -> TrainState:
        """Clip (optional) and Adam, in optax's arithmetic."""
        cfg = self.cfg
        if cfg.grad_clip > 0:
            # optax.clip_by_global_norm: scale by max/norm only above max
            norm = torch.sqrt(sum(torch.sum(g * g) for g in _leaves(grads)))
            clip = norm < cfg.grad_clip
            grads = _map(lambda g: torch.where(clip, g,
                                               g / norm * cfg.grad_clip),
                         grads)
        b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
        count = state.step + 1
        lr = self.lr(state.step)
        mu = _map(lambda g, m: (1 - b1) * g + b1 * m, grads,
                  state.opt_state["mu"])
        nu = _map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                  state.opt_state["nu"])
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        params = _map(
            lambda p, m, v: (p.detach()
                             - lr * ((m / c1) / (torch.sqrt(v / c2) + eps))
                             ).to(p.dtype),
            state.params, mu, nu)
        return TrainState(params=params, opt_state={"mu": mu, "nu": nu},
                          step=count)

    def step_on(self, state: TrainState, x, y, noise_params, y2=None):
        """One update from an already noisy batch (the rank's rows under a
        group): (state, metrics)."""
        loss, aux, grads = self.loss_and_grads(state.params, x, y,
                                               noise_params, y2, state.step)
        with (span("ssdn.train.allreduce") if self.group is not None
              else contextlib.nullcontext()):
            mean_grads_(grads, self.group)
            metrics = {"loss": pmean(loss, self.group),
                       "lr": self.lr(state.step)}
            for k, v in aux.items():
                metrics[k] = pmean(torch.mean(v.detach().float()), self.group)
        with span("ssdn.train.adam"):
            new = self.apply_grads(state, grads)
        return new, metrics

    def rows(self, x, y, noise_params, y2=None):
        """The rank's rows of a global (x, y, noise_params, y2)."""
        g = self.group
        return (shard_rows(x, g), shard_rows(y, g),
                {k: shard_rows(v, g) for k, v in noise_params.items()},
                None if y2 is None else shard_rows(y2, g))

    def __call__(self, state: TrainState, batch_u8):
        with span("ssdn.train.step"):
            with span("ssdn.train.noise"):
                noisy = self.noisy_batch(batch_u8, state.step)
            return self.step_on(state, *self.rows(*noisy))


def make_train_step(cfg: TrainConfig, *, device=None,
                    group: Optional[Group] = None) -> TrainStep:
    """The training step for ``cfg`` on ``device`` (default cuda; raises
    without a GPU unless device="cpu"), data-parallel over ``group``."""
    return TrainStep(cfg, device=device, group=group)
