"""Blind noise-parameter calibration sweep (port of
``tools/blind_calibration.py``): feed a variable-blind model images
corrupted at KNOWN parameter values across its trained range and report
estimate-vs-truth per value, plus the denoised PSNR.

Usage:
  python -m ssdn_tpu_torch.tools.blind_calibration WORKDIR_OR_PRETRAINED \\
      [--values 5,15,25,40,50] [--images 8] [--size 128] [--seed 7] \\
      [--json-out PATH] [--device cuda|cpu]

Values are in the noise style's native units (sigma/alpha in 0-255-percent
units like the CLI styles: gauss sigma 5..50, impulse alpha percent;
poisson lambda is the event count). The noise of image i comes from a
generator seeded with ``train.step.step_seed(seed, i)``, the same draw for
every value.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ssdn_tpu_torch.config import NoiseModel, NoiseValue
from ssdn_tpu_torch.estimator.core import _ALPHA_HI, _ALPHA_LO, estimate_sigma

DEFAULT_VALUES = {
    NoiseModel.GAUSSIAN: [5, 15, 25, 40, 50],
    NoiseModel.POISSON: [5, 15, 30, 40, 50],
    NoiseModel.IMPULSE: [30, 40, 50, 60],
}
UNITS = {NoiseModel.GAUSSIAN: "sigma (0-255)",
         NoiseModel.POISSON: "lambda",
         NoiseModel.IMPULSE: "alpha %"}


def estimates(out: torch.Tensor, noise_model: NoiseModel,
              channels: int) -> np.ndarray:
    """(B,) native-unit estimates from the blind channel of a
    variable-blind model's output (B, H, W, n_out)."""
    t = channels * (channels + 1) // 2
    ch = out[..., channels + t].float()
    if noise_model == NoiseModel.GAUSSIAN:
        return estimate_sigma(ch).cpu().numpy() * 255.0
    if noise_model == NoiseModel.POISSON:
        s = estimate_sigma(ch).cpu().numpy()
        return 0.5 / (s ** 2 + 1e-8)
    m = torch.mean(torch.sigmoid(ch), dim=(1, 2)).cpu().numpy()
    return (_ALPHA_LO + (_ALPHA_HI - _ALPHA_LO) * m) * 100.0


def fixed_noise(noise, v: float):
    """The config's noise with its range collapsed to the one value v
    (sigma_min/max are in 0..255 units; alpha styles are percent)."""
    if noise.model == NoiseModel.GAUSSIAN:
        return dataclasses.replace(noise, sigma_min=v, sigma_max=v)
    if noise.model == NoiseModel.POISSON:
        return dataclasses.replace(noise, lam=v, lam_max=None)
    return dataclasses.replace(noise, alpha=v / 100, alpha_max=None)


def main(argv=None) -> None:
    from ssdn_tpu_torch.cli.evaluate import _load_model
    from ssdn_tpu_torch.data import open_dataset
    from ssdn_tpu_torch.estimator import posterior_mean
    from ssdn_tpu_torch.models import blindspot_unet
    from ssdn_tpu_torch.noise import add_noise
    from ssdn_tpu_torch.train.step import pipeline_blindspot, step_seed
    from ssdn_tpu_torch.utils.device import resolve_device
    from ssdn_tpu_torch.utils.images import psnr, to_internal

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model", help="training workdir or pretrained name/.npz")
    p.add_argument("--values", default=None,
                   help="comma list of true parameter values to sweep")
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default: the GPU)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    workdir = os.path.isdir(args.model)
    cfg, params, step = _load_model(argparse.Namespace(
        workdir=args.model if workdir else None,
        pretrained=None if workdir else args.model,
        which="auto", device=args.device))
    if cfg.noise.value != NoiseValue.BLIND:
        raise SystemExit(f"model is {cfg.noise.value}, need variable-blind")

    model = cfg.noise.model
    values = ([float(v) for v in args.values.split(",")] if args.values
              else DEFAULT_VALUES[model])

    # clean eval images from the deterministic procedural corpus
    ds = open_dataset(f"synthetic:{args.images}:{args.size}",
                      grayscale=cfg.grayscale)
    cleans = [to_internal(ds[i]) for i in range(len(ds))]
    c = cleans[0].shape[-1]

    @torch.inference_mode()
    def forward(y):
        return blindspot_unet.apply(
            params, y, blindspot=pipeline_blindspot(cfg.pipeline),
            compute_dtype=getattr(torch, cfg.model.compute_dtype),
            conv_backend=cfg.model.conv_backend,
            conv_precision=cfg.model.conv_precision,
            decoder_mode=cfg.model.decoder_mode,
            head_backend=cfg.model.head_backend,
        )

    rows = []
    for v in values:
        fixed = fixed_noise(cfg.noise, v)
        ests, psnrs = [], []
        for i, clean in enumerate(cleans):
            gen = torch.Generator(device=dev)
            gen.manual_seed(step_seed(args.seed, i))
            y, _ = add_noise(gen, torch.as_tensor(clean, device=dev)[None],
                             fixed)
            out = forward(y)
            ests.append(float(estimates(out, model, c)[0]))
            # the blind estimator reads its own estimate, not these values
            den = posterior_mean(out, y, cfg.noise,
                                 {"sigma": 0.0, "lam": 1.0, "alpha": 0.5},
                                 bound=cfg.bound_outputs)
            psnrs.append(psnr(den[0].cpu().numpy(), clean))
        rows.append({
            "true": v,
            "est_mean": round(float(np.mean(ests)), 3),
            "est_std": round(float(np.std(ests)), 3),
            "psnr": round(float(np.mean(psnrs)), 3),
        })

    print(f"model: {args.model} (step {step}), noise {cfg.noise.describe()}")
    print(f"| true {UNITS[model]} | estimate (mean ± std, {args.images} "
          "images) | denoised PSNR |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r['true']:g} | {r['est_mean']:.2f} ± {r['est_std']:.2f} "
              f"| {r['psnr']:.2f} dB |")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
