"""Evaluation CLI, on the GPU (port of ``ssdn_tpu/cli/evaluate.py``;
reference repo-root ``evaluate.py`` [R]): load a trained checkpoint or a
pretrained model, denoise an eval set (Kodak/BSD68/Set14 folders or the
synthetic corpus), print/save the PSNR table and optionally the images.

Example:
  python -m ssdn_tpu_torch.cli.evaluate --workdir /tmp/run1 \\
      --dataset /data/kodak --save-images /tmp/run1/denoised

``--tiled sequential`` denoises each image in overlap windows on one
device (bounded memory). ``--tiled sharded`` / ``sharded-window`` split
each image's W axis over the ranks of a torchrun launch, and
``--data-parallel`` splits batches of images over them; only rank 0
prints and writes:
  torchrun --nproc-per-node 4 -m ssdn_tpu_torch.cli.evaluate \
      --workdir /tmp/run1 --dataset /data/kodak --tiled sharded
"""

from __future__ import annotations

import argparse
import json
import os

from ssdn_tpu_torch import parallel
from ssdn_tpu_torch.config import parse_noise_style
from ssdn_tpu_torch.data import open_dataset
from ssdn_tpu_torch.infer import evaluate_dataset
from ssdn_tpu_torch.train.loop import CheckpointManager, load_config
from ssdn_tpu_torch.train.step import init_state


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None,
                   help="training workdir containing config.json and ckpt/")
    p.add_argument("--pretrained", default=None,
                   help="bundled pretrained model name (see "
                        "ssdn_tpu_torch.zoo.available()) or an exported "
                        ".npz path — evaluate without a training workdir")
    p.add_argument("--dataset", required=True, action="append",
                   help="image folder | .h5 | synthetic[:n[:size]]; repeat "
                        "the flag or comma-separate to build the reference-"
                        "style multi-set PSNR table (Kodak/BSD68/Set14)")
    p.add_argument("--noise-style", default=None,
                   help="override eval noise (default: training noise)")
    p.add_argument("--seed", type=int, default=0x5EED,
                   help="eval noise seed (deterministic per image)")
    p.add_argument("--save-images", default=None)
    p.add_argument("--json-out", default=None)
    p.add_argument("--which", default="auto", choices=["auto", "best", "latest"],
                   help="checkpoint choice: 'best' = highest eval PSNR seen "
                        "during training; 'auto' prefers best when present")
    p.add_argument(
        "--tiled",
        default="full",
        choices=["full", "sharded", "sharded-window", "sequential"],
        help="'sharded' = per-level halo exchange over the ranks of a "
             "torchrun launch (exact, strip-sized per-rank windows at any "
             "image width; the torch-ops arm, else 'sharded-window'); "
             "'sharded-window' = the clamped-window strategies (one "
             "pre-forward exchange of --halo columns, or all_gather when "
             "strips are narrow); 'sequential' = overlap tiles on one "
             "device (bounded memory)",
    )
    p.add_argument("--halo", type=int, default=320,
                   help="tile overlap in px for the window strategies; "
                        ">= 320 is exact (see infer/tiled.py)")
    p.add_argument("--tile-w", type=int, default=512)
    p.add_argument("--eval-batch", type=int, default=1,
                   help="batch same-shaped images per forward (mode 'full'; "
                        "identical per-image math, higher throughput)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard each batch of images over the ranks of a "
                        "torchrun launch (each rank denoises different "
                        "images); --eval-batch defaults to the world size")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default: the GPU)")
    args = p.parse_args(argv)
    group = None
    if args.tiled in ("sharded", "sharded-window") or args.data_parallel:
        group = parallel.init_group(args.device)
        args.device = group.device
    try:
        _evaluate(args, group)
    finally:
        if group is not None:
            parallel.destroy_group()


def _evaluate(args, group) -> None:
    rank0 = group is None or group.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    if group is not None and args.tiled == "full" and args.eval_batch <= 1:
        # data-parallel eval needs a multi-image batch to shard: one image
        # per rank rather than silently doing nothing
        args.eval_batch = group.world
        say(f"[data-parallel] eval batch -> {args.eval_batch} "
            "(one image per rank)")
    cfg, params, step = _load_model(args, say)
    datasets = [d for spec in args.dataset for d in spec.split(",") if d]
    # --noise-style overrides the noise *parameters* but must preserve the
    # trained NoiseValue mode: a BLIND_CONST checkpoint keeps reading its
    # learned scalar, a BLIND one its head channel.
    blind_mode = {"blind": "variable", "blind_const": "const"}.get(
        cfg.noise.value.value, False
    )
    eval_noise = (
        parse_noise_style(args.noise_style, blind=blind_mode)
        if args.noise_style
        else None
    )

    say(f"checkpoint step: {step}")
    say(f"noise:   {(eval_noise or cfg.noise).describe()}")
    results = {}
    for idx, name in enumerate(datasets):
        ds = open_dataset(name, grayscale=cfg.grayscale)
        res = evaluate_dataset(
            cfg, params, ds, eval_noise=eval_noise, seed=args.seed,
            mode=args.tiled, halo=args.halo, tile_w=args.tile_w,
            eval_batch=args.eval_batch, device=args.device, group=group,
            return_images=len(ds) if args.save_images else 0,
        )
        results[name] = {k: v for k, v in res.items() if k != "images"}
        say(f"\ndataset: {name} ({res['n_images']} images)")
        for i, v in enumerate(res["psnr_per_image"]):
            say(f"  image {i:3d}: {v:7.3f} dB")
        say(f"noisy PSNR mean:    {res['noisy_psnr_mean']:7.3f} dB")
        say(f"denoised PSNR mean: {res['psnr_mean']:7.3f} dB")
        if args.save_images and rank0:
            # index prefix disambiguates datasets sharing a basename
            # (/a/kodak vs /b/kodak — or the same spec repeated — would
            # otherwise overwrite each other)
            subdir = (args.save_images if len(datasets) == 1 else
                      os.path.join(
                          args.save_images,
                          f"{idx:02d}_"
                          f"{os.path.basename(name.replace(':', '_'))}"))
            _save_images(res["images"], subdir)

    # the reference's eval artifact is a PSNR *table* over the eval sets
    if len(datasets) > 1:
        say("\nPSNR table (dB):")
        width = max(len(n) for n in datasets)
        say(f"  {'dataset':<{width}}  {'noisy':>8}  {'denoised':>8}  images")
        for name in datasets:
            r = results[name]
            say(f"  {name:<{width}}  {r['noisy_psnr_mean']:8.3f}  "
                f"{r['psnr_mean']:8.3f}  {r['n_images']:4d}")

    if args.json_out and rank0:
        payload = results[datasets[0]] if len(datasets) == 1 else {
            "datasets": results,
            "table": {
                n: {"psnr_mean": results[n]["psnr_mean"],
                    "noisy_psnr_mean": results[n]["noisy_psnr_mean"],
                    "n_images": results[n]["n_images"]}
                for n in datasets
            },
        }
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)


def _load_model(args, say=print):
    """(cfg, the port's params on ``args.device``, step) from --pretrained
    or --workdir; ``say`` prints (a no-op on ranks other than 0)."""
    if getattr(args, "pretrained", None):
        from ssdn_tpu_torch import zoo
        from ssdn_tpu_torch.models.blindspot_unet import params_from_jax

        cfg, tree, meta = zoo.load(args.pretrained)
        return cfg, params_from_jax(tree, device=args.device), int(
            meta.get("step", -1))
    if not args.workdir:
        raise SystemExit("one of --workdir / --pretrained is required")
    cfg = load_config(args.workdir)
    state = _restore(args, cfg, init_state(cfg, device=args.device), say)
    return cfg, state.params, int(state.step)


def _restore(args, cfg, state, say=print):
    if args.which in ("best", "auto"):
        best = CheckpointManager(args.workdir, cfg, subdir="ckpt_best",
                                 max_to_keep=1)
        if best.latest_step() is not None:
            say("restoring best-PSNR checkpoint (ckpt_best)")
            return best.restore(state)
        if args.which == "best":
            raise FileNotFoundError(
                f"no best checkpoint in {args.workdir}/ckpt_best"
            )
    return CheckpointManager(args.workdir, cfg).restore(state)


def _save_images(images, outdir) -> None:
    """The noisy, denoised and clean image of every evaluated image, as
    ``evaluate_dataset`` returned them (the same noisy draw it scored; with
    --save-images it keeps every image of a dataset in host memory)."""
    from ssdn_tpu_torch.utils import save_image

    os.makedirs(outdir, exist_ok=True)
    for i, trio in enumerate(images):
        save_image(os.path.join(outdir, f"{i:03d}_noisy.png"), trio["noisy"])
        save_image(os.path.join(outdir, f"{i:03d}_denoised.png"),
                   trio["denoised"])
        save_image(os.path.join(outdir, f"{i:03d}_clean.png"), trio["clean"])


if __name__ == "__main__":
    main()
