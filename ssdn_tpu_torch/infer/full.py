"""Full-image inference and PSNR evaluation (port of
``ssdn_tpu/infer/full.py``).

Denoise: reflect-pad to stride-32 divisibility, one forward — the four
rotated branches are the "4-rotation ensembling" [B config 5] — the
Bayesian posterior mean, crop.

Evaluation (``evaluate_dataset``, the reference ``evaluate.py`` flow): load
a clean image, inject noise at the eval setting from a generator seeded
per image (the port draws from ``torch.Generator``, so its noisy images
are not the JAX package's), denoise, PSNR against the clean image. Modes
"full", "sequential" (``infer.tiled``) and, over a process group
(``ssdn_tpu_torch.parallel``), "sharded" and "sharded-window"
(``infer.tiled.tiled_denoise_sharded``); mode "full" with a group is
data-parallel eval, each rank denoising its rows of a batch of images.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ssdn_tpu_torch import estimator
from ssdn_tpu_torch.config import (
    NoiseConfig,
    NoiseModel,
    NoiseValue,
    Pipeline,
    TrainConfig,
)
from ssdn_tpu_torch.models import blindspot_unet
from ssdn_tpu_torch.noise import add_noise
from ssdn_tpu_torch.parallel import Group, all_gather_w, shard_rows
from ssdn_tpu_torch.train.step import step_seed
from ssdn_tpu_torch.utils.debug import span
from ssdn_tpu_torch.utils.device import resolve_device
from ssdn_tpu_torch.utils.images import pad_to_multiple, psnr, to_internal


def pipeline_blindspot(pipeline: Pipeline) -> bool:
    """Blind-spot net for the self-supervised pipelines (a copy of
    ``ssdn_tpu/train/step.py :: pipeline_blindspot``)."""
    return pipeline in (Pipeline.SSDN, Pipeline.SSDN_MSE)


def make_denoise_fn(cfg: TrainConfig, *, device=None):
    """(params, noisy_batch, noise_param_vec) -> denoised (B, H, W, C) fp32
    tensor on ``device`` (default cuda; raises without a GPU unless
    device="cpu"). The batch may be a numpy array or a tensor (NHWC,
    internal range); it runs under ``torch.inference_mode``. ``params`` must
    already be on ``device`` (``blindspot_unet.params_from_jax``)."""
    dev = resolve_device(device)
    blindspot = pipeline_blindspot(cfg.pipeline)
    compute_dtype = getattr(torch, cfg.model.compute_dtype)

    @torch.inference_mode()
    def denoise(params, y, sigma_or_param):
        with span("ssdn.infer.to_device"):
            y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        with span("ssdn.infer.forward"):
            out = blindspot_unet.apply(
                params, y, blindspot=blindspot, compute_dtype=compute_dtype,
                conv_backend=cfg.model.conv_backend,
                conv_precision=cfg.model.conv_precision,
                decoder_mode=cfg.model.decoder_mode,
                head_backend=cfg.model.head_backend,
            )
            if cfg.pipeline == Pipeline.SSDN:
                noise_params = runtime_noise_params(
                    cfg.noise, params,
                    torch.as_tensor(sigma_or_param, dtype=torch.float32,
                                    device=dev))
                return estimator.posterior_mean(
                    out, y, cfg.noise, noise_params, bound=cfg.bound_outputs)
            return estimator.mu_only(out, y.shape[-1])

    return denoise


def _noise_param_dict(noise: NoiseConfig, vec):
    if noise.model == NoiseModel.GAUSSIAN:
        return {"sigma": vec}
    if noise.model == NoiseModel.POISSON:
        return {"lam": vec}
    return {"alpha": vec}


def runtime_noise_params(noise: NoiseConfig, params, vec):
    """Estimator noise_params for inference: the CLI/true param vec, plus —
    for BLIND_CONST models — the learned free scalar from the params (which
    the estimator reads instead of the vec)."""
    d = _noise_param_dict(noise, vec)
    if noise.value == NoiseValue.BLIND_CONST:
        d["raw_scale"] = params["noise_scalar"]["raw"]
    return d


def _true_param(noise: NoiseConfig, injected: Dict) -> torch.Tensor:
    if noise.model == NoiseModel.GAUSSIAN:
        return injected["sigma"]
    if noise.model == NoiseModel.POISSON:
        return injected["lam"]
    return injected["alpha"]


def denoise_image(denoise_fn, params, noisy: np.ndarray, noise_param, *,
                  square: bool = False) -> np.ndarray:
    """Denoise one full-resolution image (H, W, C float32 internal range)
    -> (H, W, C) numpy. Pads (reflect) to stride-32 divisibility, runs the
    denoise program, crops back. square=True additionally pads to a square
    (forces the single-4x-batch rotation fold; the model handles non-square
    natively)."""
    with span("ssdn.infer.request"):
        with span("ssdn.infer.pad"):
            padded, (h, w) = pad_to_multiple(noisy, blindspot_unet.STRIDE,
                                             square=square)
        out = denoise_fn(params, padded[None], noise_param)
        with span("ssdn.infer.to_host"):
            return out[0, :h, :w].cpu().numpy()


def evaluate_dataset(
    cfg: TrainConfig,
    params,
    dataset,
    *,
    eval_noise: Optional[NoiseConfig] = None,
    seed: int = 0x5EED,
    mode: str = "full",
    halo: int = 320,
    tile_w: int = 512,
    return_images: int = 0,
    eval_batch: int = 1,
    device=None,
    group: Optional[Group] = None,
) -> Dict:
    """Reference evaluate.py flow over a dataset: returns mean/per-image
    PSNR of the denoised estimates plus the noisy-input baseline PSNR.
    ``params`` are the port's tensors on ``device`` (default cuda; raises
    without a GPU unless device="cpu"; ``group.device`` with a group).

    mode: "full" (whole image at once), "sequential" (overlap windows
    of ``tile_w + 2*halo`` columns looped on one device,
    ``infer.tiled.tiled_denoise_sequential``), or, over ``group``,
    "sharded" (``tiled_denoise_sharded``'s strategy "auto") and
    "sharded-window" (its strategy "window").

    eval_batch > 1 groups same-shaped images into one forward — identical
    per-image math (every op is batch-independent and the noise generator
    is per-image) in fewer launches. Images stream through: a buffer per
    shape is flushed whenever it holds eval_batch images, so host memory
    stays O(#shapes * eval_batch images). With a group (mode "full" only),
    each chunk is padded to a multiple of the world size, every rank
    denoises its rows and the results are gathered: every rank returns the
    same dict."""
    noise = eval_noise or cfg.noise
    if getattr(dataset, "streaming", False):
        raise ValueError(
            "evaluation needs a finite dataset; 'synthetic:inf' is for "
            "training — use 'synthetic:N[:size]' for eval"
        )
    if eval_batch > 1 and mode != "full":
        raise ValueError(
            f"eval_batch={eval_batch} requires mode='full' (got {mode!r}); "
            "tiled modes process one image at a time"
        )
    if (group is not None and group.world > 1 and mode == "full"
            and eval_batch <= 1):
        # one image per forward would leave every rank but one idle
        raise ValueError(
            "a group with mode='full' needs eval_batch > 1 (data-parallel "
            "eval shards the image batch); pass eval_batch=group.world"
        )
    if mode in ("sharded", "sharded-window") and group is None:
        raise ValueError(f"mode {mode!r} needs a process group "
                         "(parallel.init_group())")
    if mode not in ("full", "sequential", "sharded", "sharded-window"):
        raise ValueError(mode)
    dev = group.device if group is not None else resolve_device(device)
    n = len(dataset)
    psnrs: List[Optional[float]] = [None] * n
    noisy_psnrs: List[Optional[float]] = [None] * n
    images: Dict[int, Dict] = {}

    def handle_one(i, clean, y_np, den):
        psnrs[i] = psnr(den, clean)
        noisy_psnrs[i] = psnr(y_np, clean)
        if i < return_images:
            images[i] = {"noisy": y_np, "denoised": den, "clean": clean}

    def noisy_for(i, clean):
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(seed, i))
        y, injected = add_noise(
            gen, torch.as_tensor(clean, device=dev)[None], noise)
        # KNOWN: the true injected parameter feeds the estimator; BLIND:
        # the estimator reads its own estimate and ignores this value
        return y[0].cpu().numpy(), _true_param(noise, injected)

    def flush(chunk):
        """chunk: list of (i, clean); one batched forward."""
        ys, ps = zip(*(noisy_for(i, c) for i, c in chunk))
        padded = [pad_to_multiple(y, blindspot_unet.STRIDE) for y in ys]
        stack = [p[0] for p in padded]
        pv = [torch.as_tensor(p).reshape(-1) for p in ps]
        n_dev = group.world if group is not None else 1
        # pad the chunk to a multiple of the world size (duplicates dropped)
        while len(stack) % n_dev:
            stack.append(stack[-1])
            pv.append(pv[-1])
        batch = shard_rows(np.stack(stack), group)
        pvec = shard_rows(torch.cat(pv), group)
        out = all_gather_w(denoise_fn(params, batch, pvec), group, dim=0)
        out = out.cpu().numpy()
        for k, (i, clean) in enumerate(chunk):
            h, w = padded[k][1]
            handle_one(i, clean, ys[k], out[k, :h, :w])

    if mode != "full":
        from ssdn_tpu_torch.infer.tiled import (
            tiled_denoise_sequential,
            tiled_denoise_sharded,
        )

        for i in range(n):
            clean = to_internal(dataset[i])
            y_np, param = noisy_for(i, clean)
            if mode == "sequential":
                den = tiled_denoise_sequential(
                    cfg, params, y_np, param, tile_w=tile_w, halo=halo,
                    device=dev)
            else:
                den = tiled_denoise_sharded(
                    cfg, params, y_np, param, group, halo=halo,
                    strategy="window" if mode == "sharded-window" else "auto")
            handle_one(i, clean, y_np, den)
    else:
        denoise_fn = make_denoise_fn(cfg, device=dev)
        pending: Dict[tuple, list] = {}
        for i in range(n):
            clean = to_internal(dataset[i])
            buf = pending.setdefault(clean.shape, [])
            buf.append((i, clean))
            if len(buf) == eval_batch:
                flush(buf)
                buf.clear()
        for buf in pending.values():
            if buf:
                flush(buf)
    out = {
        "psnr_mean": float(np.mean(psnrs)),
        "psnr_per_image": psnrs,
        "noisy_psnr_mean": float(np.mean(noisy_psnrs)),
        "n_images": n,
    }
    if return_images:
        out["images"] = [images[i] for i in sorted(images)]
    return out
