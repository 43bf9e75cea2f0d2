"""Denoise real images with a trained or pretrained model, on the GPU
(port of ``ssdn_tpu/cli/denoise.py``).

The inputs are treated as ALREADY-NOISY photographs, denoised with the
model's Bayesian posterior mean, and written back out as PNG.

Examples:
  # gaussian model, noise level known (sigma in 0..255 units)
  python -m ssdn_tpu_torch.cli.denoise --pretrained gauss25_rgb \
      --input noisy_photos/ --output denoised/ --param 25

  # blind model (the network estimates the noise level itself), on the CPU
  python -m ssdn_tpu_torch.cli.denoise --pretrained gauss5_50_blind_rgb \
      --input shot.png --output out/ --device cpu

  # a training workdir's best checkpoint (cli.train)
  python -m ssdn_tpu_torch.cli.denoise --workdir /tmp/run \
      --input noisy_photos/ --output denoised/ --param 25

  # bounded-memory tiling for huge scans: one window of tile-w + 2*halo
  # columns on the card at a time
  python -m ssdn_tpu_torch.cli.denoise ... --tiled sequential --tile-w 512

  # one image's W axis split over the node's cards (one process per card;
  # only rank 0 writes)
  torchrun --nproc-per-node 4 -m ssdn_tpu_torch.cli.denoise ... \
      --tiled sharded
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssdn_tpu_torch import parallel
from ssdn_tpu_torch.config import NoiseModel


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None,
                   help="training workdir containing config.json and ckpt/")
    p.add_argument("--pretrained", default=None,
                   help="bundled pretrained model name (see "
                        "ssdn_tpu_torch.zoo.available()) or an exported "
                        ".npz path")
    p.add_argument("--input", required=True,
                   help="a noisy image file or a folder of them")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--param", type=float, default=None,
                   help="noise parameter for KNOWN-noise models: gaussian "
                        "sigma in 0..255 units / poisson lambda / impulse "
                        "alpha (default: the training config's value); "
                        "ignored by BLIND models, which estimate it")
    p.add_argument("--which", default="auto",
                   choices=["auto", "best", "latest"],
                   help="checkpoint of --workdir: 'best' = highest eval "
                        "PSNR seen during training; 'auto' prefers best")
    p.add_argument("--tiled", default="full",
                   choices=["full", "sequential", "sharded"],
                   help="'sequential' bounds memory on one device; "
                        "'sharded' splits each image's W axis over the "
                        "ranks of a torchrun launch")
    p.add_argument("--halo", type=int, default=320,
                   help="window overlap in px for --tiled sequential; "
                        ">= 320 is exact (see infer/tiled.py)")
    p.add_argument("--tile-w", type=int, default=512)
    p.add_argument("--suffix", default="_denoised",
                   help="appended to each output filename stem")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default: the GPU)")
    return p


def default_param(cfg) -> float:
    n = cfg.noise
    if n.model == NoiseModel.GAUSSIAN:
        return 0.5 * (n.sigma_min + n.sigma_max)
    if n.model == NoiseModel.POISSON:
        return n.lam
    return n.alpha


def to_internal_param(cfg, value: float) -> np.ndarray:
    """CLI-unit noise parameter -> the estimator's internal vector
    (gaussian sigma is stored in the [0,1] image range)."""
    if cfg.noise.model == NoiseModel.GAUSSIAN:
        value = value / 255.0
    return np.full((1,), value, np.float32)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    group = None
    if args.tiled == "sharded":
        group = parallel.init_group(args.device)
        args.device = group.device
    try:
        _denoise(args, group)
    finally:
        if group is not None:
            parallel.destroy_group()


def _denoise(args, group) -> None:
    from ssdn_tpu_torch.cli.evaluate import _load_model
    from ssdn_tpu_torch.infer import denoise_image, make_denoise_fn
    from ssdn_tpu_torch.infer.tiled import (
        tiled_denoise_sequential,
        tiled_denoise_sharded,
    )
    from ssdn_tpu_torch.utils import list_images, load_image, save_image
    from ssdn_tpu_torch.utils.images import to_internal

    rank0 = group is None or group.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg, params, step = _load_model(args, say)
    say(f"checkpoint step: {step}")
    say(f"noise model:     {cfg.noise.describe()}")

    paths = list_images(args.input) if os.path.isdir(args.input) else [args.input]
    if not paths:
        raise FileNotFoundError(f"no images under {args.input!r}")
    value = args.param if args.param is not None else default_param(cfg)
    param = to_internal_param(cfg, value)

    # the tiled paths build their own per-window functions
    fn = (make_denoise_fn(cfg, device=args.device) if args.tiled == "full"
          else None)
    if rank0:
        os.makedirs(args.output, exist_ok=True)
    emitted = set()
    for path in paths:
        noisy = to_internal(load_image(path, grayscale=cfg.grayscale))
        if args.tiled == "full":
            den = denoise_image(fn, params, noisy, param)
        elif args.tiled == "sequential":
            den = tiled_denoise_sequential(cfg, params, noisy, param,
                                           tile_w=args.tile_w, halo=args.halo,
                                           device=args.device)
        else:
            den = tiled_denoise_sharded(cfg, params, noisy, param, group,
                                        halo=args.halo)
        stem, ext = os.path.splitext(os.path.basename(path))
        out_path = os.path.join(args.output, f"{stem}{args.suffix}.png")
        if out_path in emitted:
            # img.png and img.jpg in one folder must not overwrite each
            # other's output: uniquify with the original extension (keyed
            # on this run's outputs, not on files already on disk)
            out_path = os.path.join(
                args.output, f"{stem}_{ext.lstrip('.')}{args.suffix}.png"
            )
        emitted.add(out_path)
        if rank0:
            save_image(out_path, den)
        say(f"  {path} -> {out_path} ({den.shape[1]}x{den.shape[0]})")


if __name__ == "__main__":
    main()
