"""The plain reference of the blind-spot denoiser: plain PyTorch, written from
the published description (Laine et al. 2019, arXiv 1901.10277) and the
configuration's stated objective, imports nothing of the program.

- The network: four copies of one shared-weight U-Net trunk, each fed the
  input rotated by k*90 degrees; every 3x3 conv is shifted so an output row
  reads only rows at or above it; 2x2 max-pools are offset one row down;
  the decoder is the literal nearest-upsample, concat, conv; each branch is
  shifted down one row (the blind spot) and rotated back; three 1x1 convs
  (the head) combine the four branches, the last one linear.
- The objective: the Gaussian NLL of eq. 2 over Sigma_y = A^T A + sigma^2 I,
  A upper-triangular from six outputs; "stabilized" adds tanh soft bounds,
  Huberized whitened residuals and beta-NLL weights; blind models estimate
  sigma as the spatial mean of softplus of one more output and subtract
  ``blind_reg`` times it.
- The posterior mean mu + Sigma_x Sigma_y^-1 (y - mu).
- Adam as optax writes it, bias-corrected, eps outside the square root,
  with the configuration's cosine learning-rate ramp-down.
- The data: the crops a counter-based splitmix64 stream picks per (seed,
  step, row) and the step's Gaussian noise drawn from a generator seeded by
  a SeedSequence hash of (seed, step): the same rules the configuration's
  trainer follows, written out again here.

Everything computes in float32 with TF32 off, unless ``Precision`` asks for
one of the controls: "tf32" (TF32 on for every conv and matmul) or "fp8"
(every conv's and matmul's operands rounded to float8 e4m3 with a
per-tensor scale, gradients passed straight through).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LOG2PI = math.log(2.0 * math.pi)
SLOPE = 0.1
MU_BOUND, A_BOUND, HUBER = 2.0, 4.0, 5.0
SQRT_FLOOR = 1e-9
PRECISIONS = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def layer_shapes(c: int, n_out: int, enc: int, dec: int, nin_a: int,
                 nin_b: int) -> Dict[str, tuple]:
    """(cout, cin, kh, kw) of every layer, in the order their weights are
    drawn."""
    s = {"enc0": (enc, c, 3, 3)}
    for i in range(1, 7):
        s[f"enc{i}"] = (enc, enc, 3, 3)
    s["dec5a"] = (dec, 2 * enc, 3, 3)
    s["dec5b"] = (dec, dec, 3, 3)
    for i in (4, 3, 2):
        s[f"dec{i}a"] = (dec, dec + enc, 3, 3)
        s[f"dec{i}b"] = (dec, dec, 3, 3)
    s["dec1a"] = (dec, dec + c, 3, 3)
    s["dec1b"] = (dec, dec, 3, 3)
    s["nin_a"] = (nin_a, 4 * dec, 1, 1)
    s["nin_b"] = (nin_b, nin_a, 1, 1)
    s["nin_c"] = (n_out, nin_b, 1, 1)
    return s


def n_outputs(channels: int, blind: bool) -> int:
    return channels + channels * (channels + 1) // 2 + (1 if blind else 0)


def he_init(seed: int, shapes: Dict[str, tuple], device) -> Dict:
    """He-normal weights (std sqrt(2 / fan_in)) drawn layer by layer from a
    CPU generator seeded with ``seed``, zero biases: the initialisation the
    configuration's trainer starts from."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    for name, (co, ci, kh, kw) in shapes.items():
        w = torch.randn((co, ci, kh, kw), generator=g) * math.sqrt(
            2.0 / (kh * kw * ci))
        params[name] = {"w": w.to(device), "b": torch.zeros(co, device=device)}
    return params


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale; the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """Where the reference's convs and matmuls round: "fp32" (TF32 off),
    "tf32" or "fp8". Use as a context manager around forward and
    backward: it sets the TF32 flags for both."""

    def __init__(self, name: str = "fp32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.name = name
        self._saved = None

    def __enter__(self):
        self._saved = (torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32)
        tf32 = self.name == "tf32"
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self._saved
        return False

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t) if self.name == "fp8" else t


def lrelu(x):
    return torch.where(x >= 0, x, SLOPE * x)


def conv_up(p, x, w, b):
    """3x3 conv whose output row r reads input rows r-2..r (zero padding
    above, one column each side)."""
    x = F.pad(x, (1, 1, 2, 0))
    return F.conv2d(p.operand(x), p.operand(w)) + b.view(1, -1, 1, 1)


def pool_down(x):
    """2x2 max-pool over rows (2R-1, 2R): pad one row of -inf above, drop
    the last row."""
    x = F.pad(x, (0, 0, 1, 0), value=float("-inf"))[:, :, :-1]
    return F.max_pool2d(x, 2)


def trunk(p: Precision, params, x):
    """The shared U-Net trunk on NCHW ``x``, then the one-row blind-spot
    shift."""
    c = lambda n, h: lrelu(conv_up(p, h, params[n]["w"], params[n]["b"]))
    skips = [x]
    h = c("enc0", x)
    h = pool_down(c("enc1", h))
    skips.append(h)
    for i in (2, 3, 4):
        h = pool_down(c(f"enc{i}", h))
        skips.append(h)
    h = pool_down(c("enc5", h))
    h = c("enc6", h)
    for stage, skip in zip((5, 4, 3, 2, 1), reversed(skips)):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = c(f"dec{stage}a", torch.cat([h, skip], dim=1))
        h = c(f"dec{stage}b", h)
    return F.pad(h, (0, 0, 1, 0))[:, :, :-1]


def network(p: Precision, params, y_nhwc):
    """(B, H, W, C) -> (B, H, W, n_out): four rotated branches through the
    trunk, rotated back, the 1x1 head."""
    x = y_nhwc.permute(0, 3, 1, 2)
    branches = [torch.rot90(trunk(p, params, torch.rot90(x, k, (2, 3))),
                            -k, (2, 3)) for k in range(4)]
    f = torch.cat(branches, dim=1).permute(0, 2, 3, 1)
    for name, act in (("nin_a", True), ("nin_b", True), ("nin_c", False)):
        w = params[name]["w"][:, :, 0, 0]
        f = torch.matmul(p.operand(f), p.operand(w).t()) + params[name]["b"]
        if act:
            f = lrelu(f)
    return f


def huber(z):
    az = z.abs()
    return torch.where(az <= HUBER, z * z, 2 * HUBER * az - HUBER * HUBER)


def _gaussian_parts(out, y, noise, sigma_true, stabilized):
    """Per pixel (nll, posterior, exp(logdet / 3)), per image sigma (the
    true one, or the blind estimate)."""
    mu, a = out[..., :3], out[..., 3:9]
    if stabilized:
        mu = MU_BOUND * torch.tanh(mu / MU_BOUND)
        a = A_BOUND * torch.tanh(a / A_BOUND)
    if noise["value"] == "blind":
        ch = out[..., 9]
        sigma = torch.logaddexp(ch, torch.zeros_like(ch)).mean(dim=(1, 2))
    else:
        sigma = sigma_true
    a11, a12, a13, a22, a23, a33 = a.unbind(-1)
    # Sigma_x = A^T A, A = [[a11, a12, a13], [0, a22, a23], [0, 0, a33]]
    x11, x12, x13 = a11 * a11, a11 * a12, a11 * a13
    x22, x23 = a12 * a12 + a22 * a22, a12 * a13 + a22 * a23
    x33 = a13 * a13 + a23 * a23 + a33 * a33
    v = (sigma * sigma)[:, None, None]
    s11, s22, s33 = x11 + v, x22 + v, x33 + v
    # lower Cholesky factor of Sigma_y
    l11 = torch.sqrt(s11.clamp(min=SQRT_FLOOR))
    l21, l31 = x12 / l11, x13 / l11
    l22 = torch.sqrt((s22 - l21 * l21).clamp(min=SQRT_FLOOR))
    l32 = (x23 - l31 * l21) / l22
    l33 = torch.sqrt((s33 - l31 * l31 - l32 * l32).clamp(min=SQRT_FLOOR))
    d1, d2, d3 = (y - mu).unbind(-1)
    z1 = d1 / l11
    z2 = (d2 - l21 * z1) / l22
    z3 = (d3 - l31 * z1 - l32 * z2) / l33
    quad = (huber(z1) + huber(z2) + huber(z3)) if stabilized else (
        z1 * z1 + z2 * z2 + z3 * z3)
    logdet = 2 * (torch.log(l11) + torch.log(l22) + torch.log(l33))
    nll = 0.5 * (quad + logdet + 3 * LOG2PI)
    # Sigma_y^-1 d = L^-T z
    w3 = z3 / l33
    w2 = (z2 - l32 * w3) / l22
    w1 = (z1 - l21 * w2 - l31 * w3) / l11
    post = torch.stack([x11 * w1 + x12 * w2 + x13 * w3,
                        x12 * w1 + x22 * w2 + x23 * w3,
                        x13 * w1 + x23 * w2 + x33 * w3], -1) + mu
    return nll, post, torch.exp(logdet / 3), sigma


def posterior(p: Precision, params, y, cfg, sigma_true=None):
    """The denoised image E[x | y] of NHWC ``y``."""
    out = network(p, params, y)
    stab = cfg["objective"] == "stabilized"
    if sigma_true is None:
        sigma_true = torch.zeros(y.shape[0], device=y.device)
    return _gaussian_parts(out, y, cfg["noise"], sigma_true, stab)[1]


# ----------------------------- training -----------------------------


def splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def crops(corpus: Sequence[np.ndarray], seed: int, step: int, batch: int,
          patch: int) -> np.ndarray:
    """The batch of step ``step``: row j takes image r1 % n at row r2 %
    (h - patch + 1), column r3 % (w - patch + 1), where r1, r2, r3 are
    three successive splitmix64 draws from splitmix64(seed ^
    splitmix64(step ^ splitmix64(j)))."""
    with np.errstate(over="ignore"):
        j = np.arange(batch, dtype=np.uint64)
        s = splitmix64(np.uint64(seed % 2 ** 64)
                       ^ splitmix64(np.uint64(step % 2 ** 64) ^ splitmix64(j)))
        r1 = splitmix64(s)
        r2 = splitmix64(r1)
        r3 = splitmix64(r2)
    n = len(corpus)
    out = np.empty((batch, patch, patch, corpus[0].shape[-1]), np.uint8)
    for k in range(batch):
        img = corpus[int(r1[k] % np.uint64(n))]
        h, w = img.shape[:2]
        r = int(r2[k] % np.uint64(h - patch + 1))
        c = int(r3[k] % np.uint64(w - patch + 1))
        out[k] = img[r:r + patch, c:c + patch]
    return out


def step_seed(seed: int, step: int) -> int:
    ss = np.random.SeedSequence([seed % 2 ** 64, step % 2 ** 64])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def noisy(batch_u8: np.ndarray, cfg, step: int, device):
    """(clean, noisy, sigma per image) of a step's batch: sigma/255 drawn
    uniform in [sigma_min, sigma_max] (when they differ), then unit
    Gaussian noise over the whole batch, both from the step's generator."""
    x = torch.as_tensor(batch_u8, device=device).float() / 255.0 - 0.5
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(cfg["seed"], step))
    nz = cfg["noise"]
    b = x.shape[0]
    lo, hi = nz["sigma_min"] / 255.0, nz["sigma_max"] / 255.0
    if lo == hi:
        sigma = torch.full((b,), lo, device=device)
    else:
        sigma = lo + (hi - lo) * torch.rand((b,), generator=g, device=device)
    return x, x + sigma[:, None, None, None] * torch.randn(
        x.shape, generator=g, device=device), sigma


def lr_at(cfg, step: int) -> float:
    frac = cfg["lr_rampdown_frac"]
    if frac <= 0:
        return cfg["lr"]
    t = step / max(cfg["iterations"], 1)
    v = min(max((1.0 - t) / frac, 0.0), 1.0)
    return cfg["lr"] * (0.5 - 0.5 * math.cos(v * math.pi))


def _leaves(tree):
    return [t for leaf in tree.values() for t in leaf.values()]


def loss_and_grads(p: Precision, params, y, sigma, cfg, block: int,
                   keep: Optional[slice] = None):
    """The batch's loss and gradients, accumulated over blocks of
    ``block`` rows. The beta-NLL weights are normalised by their mean over
    the whole batch, taken first without gradients. ``keep`` limits the
    batch to some of its rows (a planted fault)."""
    if keep is not None:
        y, sigma = y[keep], sigma[keep]
    stab = cfg["objective"] == "stabilized"
    beta = cfg["nll_beta"] if stab else 0.0
    blind = cfg["noise"]["value"] == "blind"
    b = y.shape[0]
    n_pix = b * y.shape[1] * y.shape[2]
    mean_w = 1.0
    if beta:
        with torch.no_grad():
            total = 0.0
            for i in range(0, b, block):
                out = network(p, params, y[i:i + block])
                _, _, vs, _ = _gaussian_parts(out, y[i:i + block],
                                              cfg["noise"], sigma[i:i + block],
                                              stab)
                total += float((vs ** beta).double().sum())
            mean_w = total / n_pix
    live = {n: {k: t.detach().requires_grad_(True) for k, t in leaf.items()}
            for n, leaf in params.items()}
    leaves = _leaves(live)
    grads = [torch.zeros_like(t) for t in leaves]
    loss = 0.0
    for i in range(0, b, block):
        yb, sb = y[i:i + block], sigma[i:i + block]
        out = network(p, live, yb)
        nll, _, vs, sig = _gaussian_parts(out, yb, cfg["noise"], sb, stab)
        if beta:
            nll = vs.detach() ** beta / mean_w * nll
        part = nll.sum() / n_pix
        if blind:
            part = part - cfg["blind_reg"] * sig.sum() / b
        for acc, g in zip(grads, torch.autograd.grad(part, leaves)):
            acc += g
        loss += float(part.detach().double())
    it = iter(grads)
    return loss, {n: {k: next(it) for k in leaf} for n, leaf in live.items()}


def adam(params, opt, grads, step: int, cfg):
    """optax.adam(lr_at(step), b1, b2, eps): returns (params, opt)."""
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    lr, count = lr_at(cfg, step), step + 1
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new_p, mu, nu = {}, {}, {}
    for n, leaf in params.items():
        new_p[n], mu[n], nu[n] = {}, {}, {}
        for k, w in leaf.items():
            g = grads[n][k]
            m = (1 - b1) * g + b1 * opt["mu"][n][k]
            v = (1 - b2) * g * g + b2 * opt["nu"][n][k]
            new_p[n][k] = w - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            mu[n][k], nu[n][k] = m, v
    return new_p, {"mu": mu, "nu": nu}


def train_steps(cfg, corpus, n_steps: int, device, precision: str = "fp32",
                block: int = 64, keep_rows: Optional[int] = None) -> Dict:
    """The configuration's first ``n_steps`` training steps from its
    initialisation: {"loss": [per step], "grad0": first step's gradients,
    "params0", "params": after the last step} (trees of tensors).
    ``keep_rows`` trains on the leading rows of each batch only (a planted
    fault)."""
    c = 3
    if cfg.get("blind_reg_rampdown_frac", 0.0) or cfg["noise"]["model"] != (
            "gaussian"):
        raise ValueError("the reference trains Gaussian noise with a "
                         "constant blind regulariser")
    blind = cfg["noise"]["value"] == "blind"
    m = cfg["model"]
    shapes = layer_shapes(c, n_outputs(c, blind), m["enc_features"],
                          m["dec_features"], m["nin_a_features"],
                          m["nin_b_features"])
    params = he_init(cfg["seed"], shapes, device)
    params0 = params
    zeros = lambda: {n: {k: torch.zeros_like(t) for k, t in leaf.items()}
                     for n, leaf in params.items()}
    opt = {"mu": zeros(), "nu": zeros()}
    losses, grad0 = [], None
    keep = None if keep_rows is None else slice(0, keep_rows)
    with Precision(precision) as p:
        for s in range(n_steps):
            batch = crops(corpus, cfg["seed"], s, cfg["batch_size"],
                          cfg["patch_size"])
            _, y, sigma = noisy(batch, cfg, s, device)
            loss, grads = loss_and_grads(p, params, y, sigma, cfg, block, keep)
            if s == 0:
                grad0 = grads
            params, opt = adam(params, opt, grads, s, cfg)
            losses.append(loss)
    return {"loss": losses, "grad0": grad0, "params0": params0,
            "params": params}


def denoise(cfg, params, noisy_hwc: np.ndarray, sigma: float, device,
            precision: str = "fp32") -> np.ndarray:
    """One image (H, W, C, internal range) with noise ``sigma`` (internal
    units; blind models estimate their own) -> its posterior mean:
    reflect-pad to multiples of 32, the network, crop."""
    h, w = noisy_hwc.shape[:2]
    ph, pw = -h % 32, -w % 32
    y = np.pad(noisy_hwc, [(0, ph), (0, pw), (0, 0)], mode="reflect")
    with torch.no_grad(), Precision(precision) as p:
        out = posterior(p, params, torch.as_tensor(y, device=device)[None],
                        cfg, torch.full((1,), sigma, device=device))
    return out[0, :h, :w].cpu().numpy()
