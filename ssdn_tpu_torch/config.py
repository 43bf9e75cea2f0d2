"""Configuration system (the PyTorch port's own copy of ``ssdn_tpu/config.py``).

The port imports nothing of ``ssdn_tpu``, so it keeps this copy; the zoo
artifacts' ``__config__`` JSON must parse identically on both sides
(tests/test_torch_denoise.py). The backend names keep their meaning per
package: ``"lax"`` is the framework's own ops (XLA there, torch/cuDNN
here) and ``"pallas"`` the hand-written kernel (CUDA here).

Re-creates the selectable axes of the reference's ``params.py``/``cfg.py``
enums (``NoiseAlgorithm``, ``Pipeline``, ``NoiseValue`` — SURVEY.md §2.1, §5.6)
as frozen dataclasses that serialize into checkpoints.

Axes (SURVEY.md §5.6, the [B] config matrix):
  * algorithm:  ssdn | ssdn_mse (mu-only ablation) | n2c | n2n
  * noise:      gauss sigma | gauss blind [a, b] | poisson lam | impulse p
  * sigma known / blind (estimated by the network)
"""

from __future__ import annotations

import dataclasses
import enum
import json
import re


class NoiseModel(str, enum.Enum):
    GAUSSIAN = "gaussian"
    POISSON = "poisson"
    IMPULSE = "impulse"


class NoiseValue(str, enum.Enum):
    """How the noise parameter is obtained at loss/posterior time.

    The reference's ``NoiseValue`` enum has three modes (SURVEY.md §5.6:
    "known / constant-blind / variable-blind"):

    KNOWN: the true per-image parameter used by the injector is fed to the
    estimator.  BLIND: per-image variable-blind — the network emits an
    extra output channel from which the parameter is estimated per image
    (SURVEY.md §2.5 "blind-sigma").  BLIND_CONST: constant-blind — the
    parameter is assumed constant over the corpus but unknown, and is
    learned as a single free scalar trained jointly with the network by
    the same NLL ([P] §3.1's "fixed but unknown" case; no extra output
    channel).
    """

    KNOWN = "known"
    BLIND = "blind"
    BLIND_CONST = "blind_const"


class Pipeline(str, enum.Enum):
    """Training pipeline / algorithm (reference ``NoiseAlgorithm`` [R])."""

    SSDN = "ssdn"          # blind-spot net + Bayesian NLL / posterior mean
    SSDN_MSE = "ssdn_mse"  # blind-spot net, mu-only MSE ablation
    N2C = "n2c"            # supervised: noisy -> clean, plain U-Net
    N2N = "n2n"            # noise2noise: noisy -> independently-noisy target


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    model: NoiseModel = NoiseModel.GAUSSIAN
    value: NoiseValue = NoiseValue.KNOWN
    # Gaussian: sigma range in 0..255 units; sigma_min == sigma_max => fixed.
    sigma_min: float = 25.0
    sigma_max: float = 25.0
    # Poisson: event count at intensity 1.0 (lambda). lam_max=None => fixed;
    # otherwise lambda ~ U[lam, lam_max] per image ([P] Table 3's variable-
    # lambda rows; style "poisson5_50").
    lam: float = 30.0
    lam_max: float | None = None
    # Impulse: per-pixel replacement probability alpha. alpha_max=None =>
    # fixed; otherwise alpha ~ U[alpha, alpha_max] per image ([P] Table 3's
    # variable-alpha rows; style "impulse30_60", percent units).
    alpha: float = 0.5
    alpha_max: float | None = None

    @property
    def fixed_sigma(self) -> bool:
        return self.sigma_min == self.sigma_max

    @property
    def fixed_lam(self) -> bool:
        return self.lam_max is None or self.lam_max == self.lam

    @property
    def fixed_alpha(self) -> bool:
        return self.alpha_max is None or self.alpha_max == self.alpha

    def describe(self) -> str:
        if self.model == NoiseModel.GAUSSIAN:
            rng = (
                f"{self.sigma_min:g}"
                if self.fixed_sigma
                else f"[{self.sigma_min:g},{self.sigma_max:g}]"
            )
            return f"gauss sigma={rng} ({self.value.value})"
        if self.model == NoiseModel.POISSON:
            rng = (
                f"{self.lam:g}"
                if self.fixed_lam
                else f"[{self.lam:g},{self.lam_max:g}]"
            )
            return f"poisson lam={rng} ({self.value.value})"
        rng = (
            f"{self.alpha:g}"
            if self.fixed_alpha
            else f"[{self.alpha:g},{self.alpha_max:g}]"
        )
        return f"impulse alpha={rng} ({self.value.value})"


_STYLE_RE = re.compile(
    r"^(?P<kind>gauss|poisson|impulse)(?P<a>\d+(?:\.\d+)?)?(?:[_-](?P<b>\d+(?:\.\d+)?))?$"
)


def parse_noise_style(style: str, blind=False) -> NoiseConfig:
    """Parse reference-style noise strings: ``gauss25``, ``gauss5_50``,
    ``poisson30``, ``poisson5_50``, ``impulse50``, ``impulse30_60``
    (impulse arguments are percent; a range means a per-image uniform draw).

    blind: False/None -> KNOWN; True or "variable" -> BLIND (network
    estimate); "const" -> BLIND_CONST (learned global scalar).

    SURVEY.md §2.1 noise-synthesis row; [B] configs 1-4 plus [P] Table 3's
    variable-parameter rows.
    """
    m = _STYLE_RE.match(style.strip().lower())
    if not m:
        raise ValueError(f"unparseable noise style: {style!r}")
    kind, a, b = m.group("kind"), m.group("a"), m.group("b")
    if blind in (False, None):
        value = NoiseValue.KNOWN
    elif blind in (True, "variable", NoiseValue.BLIND):
        value = NoiseValue.BLIND
    elif blind in ("const", NoiseValue.BLIND_CONST):
        value = NoiseValue.BLIND_CONST
    else:
        raise ValueError(f"unknown blind mode: {blind!r}")
    if value == NoiseValue.BLIND_CONST and b is not None:
        # constant-blind assumes a corpus-constant parameter; with a ranged
        # style the injector draws a different value per image while the
        # loss fits ONE scalar — the model is mis-specified and the learned
        # scalar converges to an effective average of the range (ADVICE r3).
        import warnings

        warnings.warn(
            f"noise style {style!r} draws a per-image parameter but "
            "blind='const' learns a single corpus-constant scalar — the "
            "estimate will fit the range's effective mean; use "
            "blind='variable' for per-image estimation",
            UserWarning,
            stacklevel=2,
        )
    if kind == "gauss":
        lo = float(a) if a is not None else 25.0
        hi = float(b) if b is not None else lo
        return NoiseConfig(
            model=NoiseModel.GAUSSIAN, value=value, sigma_min=lo, sigma_max=hi
        )
    if kind == "poisson":
        return NoiseConfig(
            model=NoiseModel.POISSON, value=value,
            lam=float(a) if a else 30.0,
            lam_max=float(b) if b is not None else None,
        )
    pct = float(a) if a is not None else 50.0
    return NoiseConfig(
        model=NoiseModel.IMPULSE, value=value, alpha=pct / 100.0,
        alpha_max=float(b) / 100.0 if b is not None else None,
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    in_channels: int = 3
    # Encoder/decoder widths per Laine et al. appendix (SURVEY.md §2.4).
    enc_features: int = 48
    dec_features: int = 96
    nin_a_features: int = 384
    nin_b_features: int = 96
    blindspot: bool = True
    # Numerics (SURVEY.md §2.5 + the measured stability matrix in README):
    # with the beta=1 NLL weighting (TrainConfig.nll_beta) the bf16 MXU
    # fast path trains stably (validated 11k+ steps on the degenerate
    # corpus; 20k+ on the streaming corpus). "auto" resolves in
    # TrainConfig.__post_init__: bfloat16 for objective="stabilized",
    # float32 for objective="reference" (the conservative default for the
    # parity mode — ~40% the bf16 speed). An EXPLICIT dtype is always
    # respected, including bfloat16 + objective="reference": round 3
    # proved the raw NLL's round-1 instability was corpus memorization,
    # not precision (README), so the bf16 reference arm is a supported,
    # measured configuration rather than a forbidden one.
    compute_dtype: str = "auto"
    param_dtype: str = "float32"
    conv_precision: str = "highest"  # default | high | highest (fp32 inputs)
    # Hot-op backend: "lax" (XLA conv) or "pallas" (fused kernel).
    conv_backend: str = "lax"
    # 1x1 combiner head backend: "lax" or "pallas" (one fused kernel for
    # nin_a/nin_b/nin_c with VMEM-resident intermediates + custom VJP —
    # ops/pallas/nin_head.py).
    head_backend: str = "lax"
    # Decoder upsample->concat->conv stages: "fused" computes each one as a
    # phase-decomposed coarse-resolution conv (exact rewrite, ~0.67x MACs at
    # full MXU lane fill — ops.shifted_upsample_concat_conv); "naive" keeps
    # the literal composition (differential-test oracle). Parameters are
    # identical, so checkpoints move freely between modes.
    decoder_mode: str = "fused"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    pipeline: Pipeline = Pipeline.SSDN
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    # Training objective:
    #   "stabilized" (default): the production numerics — Huberized whitened
    #     residuals, soft tanh output bounds, beta-NLL weighting (README
    #     numerics notes). Per-pixel optima are identical to the raw NLL.
    #   "reference": the reference repo's exact objective [P eq. 2] — raw
    #     NLL (no Huber), unbounded network outputs, nll_beta=0, Adam
    #     eps=1e-8, fp32 compute at HIGHEST conv precision. __post_init__
    #     enforces all five so the mode cannot be half-selected.
    objective: str = "stabilized"
    patch_size: int = 64
    batch_size: int = 64           # global batch (split over the data mesh axis)
    iterations: int = 100_000
    lr: float = 3e-4
    lr_rampdown_frac: float = 0.3  # cosine rampdown over last fraction [N2N conv.]
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    # eps history: round 1 measured eps=1e-3 as a stability necessity, but
    # that was on the degenerate 64-image corpus and BEFORE beta-NLL
    # landed. The round-3 bisect on the non-memorizable streaming corpus
    # (README) shows eps=1e-3 costs ~1.6 dB of converged PSNR (31.5 vs
    # 33.1 at 10k steps) while beta-NLL/Huber/bounds cost nothing — so the
    # default returns to the reference's 1e-8, with the loss-spike guard +
    # rewind escalation still armed as the production backstop.
    adam_eps: float = 1e-8
    grad_clip: float = 0.0  # global-norm clip; 0 = off (stability knob)
    # Blind-noise regularizer coefficient (loss -= coef * sigma_hat), [P] §3.1;
    # flagged "re-verify" in SURVEY.md §2.5 — kept configurable.
    blind_reg: float = 0.1
    # Blind-regularizer rampdown: when > 0, the anti-degeneracy barrier
    # weight cosines from `blind_reg` to 0 over the final fraction of
    # training (same curve as lr_rampdown_frac). The barrier exists to
    # keep the early-training estimate off the degenerate rail (estimator
    # core docstrings); once the model has organized it only biases the
    # estimate — for impulse the symmetric log-barrier's minimum at
    # alpha=0.5 compresses alpha_hat toward the range midpoint
    # (CALIBRATION_r5.json round-5 measurement). Decaying it late keeps
    # the protection where it is needed and removes the equilibrium bias
    # where it is not. 0.0 (default) keeps the constant barrier.
    blind_reg_rampdown_frac: float = 0.0
    # beta-NLL pixel-weight exponent (estimator.nll docstring): 1.0 keeps
    # per-pixel optima identical to the reference NLL while removing the
    # 1/var gradient disparity that destabilizes training; 0.0 = raw NLL.
    nll_beta: float = 1.0
    # Loss-spike rollback guard (SURVEY.md §5.3; train/loop.py). The margin
    # is *relative* — k times the EMA of the loss's absolute deviation — so
    # the same knobs work for NLL pipelines (loss can be negative, scale
    # varies with the noise model) and MSE pipelines (scale ~1e-2).
    guard_check: int = 50            # loss fetch cadence in steps; <=0 disables
    guard_margin_k: float = 6.0      # spike threshold = k * EMA |deviation|
    guard_margin_floor: float = 0.05 # absolute floor before deviation stats exist
    guard_max_consecutive: int = 20  # rollbacks in a row before early-stop
    # Eval-quality early stop (SURVEY.md §5.3): the NLL loss can stay
    # healthy while eval PSNR decays (measured loss/eval disconnect on
    # small corpora — README parity table). After eval_patience consecutive
    # evals more than eval_patience_delta dB below the best seen, stop;
    # ckpt_best already holds the best state. 0 disables.
    eval_patience: int = 0
    eval_patience_delta: float = 1.0
    seed: int = 0
    eval_interval: int = 10_000
    snapshot_interval: int = 10_000
    keep_checkpoints: int = 3
    grayscale: bool = False

    def __post_init__(self):
        if self.grayscale and self.model.in_channels != 1:
            object.__setattr__(
                self, "model", dataclasses.replace(self.model, in_channels=1)
            )
        if self.objective not in ("stabilized", "reference"):
            raise ValueError(
                f"objective must be 'stabilized' or 'reference', "
                f"got {self.objective!r}"
            )
        if self.objective == "reference":
            # the mode is a complete preset: raw NLL + unbounded outputs
            # come from the objective flag itself (estimator reads
            # robust_nll / bound_outputs); the optimizer/precision halves
            # are enforced here. compute_dtype: "auto" resolves to the
            # conservative fp32 default, but an explicit dtype is
            # respected (see ModelConfig.compute_dtype).
            object.__setattr__(self, "nll_beta", 0.0)
            object.__setattr__(self, "adam_eps", 1e-8)
            object.__setattr__(
                self,
                "model",
                dataclasses.replace(
                    self.model,
                    compute_dtype=(
                        "float32"
                        if self.model.compute_dtype == "auto"
                        else self.model.compute_dtype
                    ),
                    conv_precision="highest",
                ),
            )
        elif self.model.compute_dtype == "auto":
            object.__setattr__(
                self,
                "model",
                dataclasses.replace(self.model, compute_dtype="bfloat16"),
            )

    @property
    def robust_nll(self) -> bool:
        """Huberize the whitened residuals in the training NLL."""
        return self.objective == "stabilized"

    @property
    def bound_outputs(self) -> bool:
        """Soft-bound mu / covariance factors with tanh."""
        return self.objective == "stabilized"


def n_output_channels(pipeline: Pipeline, noise: NoiseConfig, channels: int) -> int:
    """Network head width for a pipeline/noise combo (SURVEY.md §2.4).

    SSDN: C (mu) + C(C+1)/2 (covariance params) + 1 if the noise parameter is
    estimated by the network (BLIND only — BLIND_CONST learns a free scalar
    outside the network head). Other pipelines regress the image directly.
    """
    if pipeline == Pipeline.SSDN:
        n = channels + channels * (channels + 1) // 2
        if noise.value == NoiseValue.BLIND:
            n += 1
        return n
    return channels


def to_json(cfg) -> str:
    def default(o):
        if isinstance(o, enum.Enum):
            return o.value
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        raise TypeError(type(o))

    return json.dumps(dataclasses.asdict(cfg), default=default, indent=2)


def train_config_from_json(s: str) -> TrainConfig:
    d = json.loads(s)
    noise = d.pop("noise", {})
    model = d.pop("model", {})
    noise["model"] = NoiseModel(noise.get("model", "gaussian"))
    noise["value"] = NoiseValue(noise.get("value", "known"))
    d["pipeline"] = Pipeline(d.get("pipeline", "ssdn"))
    return TrainConfig(
        noise=NoiseConfig(**noise), model=ModelConfig(**model), **d
    )
