"""Full-image inference (port of ``ssdn_tpu/infer/full.py``, the denoise
half): reflect-pad to stride-32 divisibility, one forward — the four
rotated branches are the "4-rotation ensembling" [B config 5] — the
Bayesian posterior mean, crop.

``evaluate_dataset`` (synthetic-noise PSNR over a dataset) comes with the
evaluation slice.
"""

from __future__ import annotations

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
from ssdn_tpu_torch.utils.device import resolve_device
from ssdn_tpu_torch.utils.images import pad_to_multiple


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
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
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
            return estimator.posterior_mean(out, y, cfg.noise, noise_params,
                                            bound=cfg.bound_outputs)
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


def denoise_image(denoise_fn, params, noisy: np.ndarray, noise_param, *,
                  square: bool = False) -> np.ndarray:
    """Denoise one full-resolution image (H, W, C float32 internal range)
    -> (H, W, C) numpy. Pads (reflect) to stride-32 divisibility, runs the
    denoise program, crops back. square=True additionally pads to a square
    (forces the single-4x-batch rotation fold; the model handles non-square
    natively)."""
    padded, (h, w) = pad_to_multiple(noisy, blindspot_unet.STRIDE,
                                     square=square)
    out = denoise_fn(params, padded[None], noise_param)
    return out[0, :h, :w].cpu().numpy()
