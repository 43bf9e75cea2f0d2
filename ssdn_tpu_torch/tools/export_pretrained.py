"""Export a training workdir's checkpoint as a single-file pretrained
artifact for ``ssdn_tpu_torch.zoo`` (params + config + provenance, no
optimizer state), in the layout the JAX package's ``zoo.load`` reads too
(port of ``tools/export_pretrained.py``).

Usage:
  python -m ssdn_tpu_torch.tools.export_pretrained WORKDIR OUT.npz \\
      [--which auto|best|latest] [--note "..."] [--eval DATASET] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from ssdn_tpu_torch import zoo
    from ssdn_tpu_torch.cli.evaluate import _restore
    from ssdn_tpu_torch.models.blindspot_unet import param_count
    from ssdn_tpu_torch.train.loop import load_config
    from ssdn_tpu_torch.train.step import init_state

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("workdir")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--which", default="auto",
                   choices=["auto", "best", "latest"])
    p.add_argument("--note", default="", help="free-form provenance note")
    p.add_argument("--eval", default=None, metavar="DATASET",
                   help="evaluate the checkpoint on this dataset spec "
                        "(e.g. 'bundled') and record the PSNR in the "
                        "artifact meta")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the checkpoint is restored and evaluated "
                        "(default: the GPU)")
    args = p.parse_args(argv)

    cfg = load_config(args.workdir)
    state = _restore(args, cfg, init_state(cfg, device=args.device))
    meta = {
        "step": int(state.step),
        "noise": cfg.noise.describe(),
        "which": args.which,
        "note": args.note,
    }
    if args.eval:
        from ssdn_tpu_torch.data import open_dataset
        from ssdn_tpu_torch.infer import evaluate_dataset

        res = evaluate_dataset(
            cfg, state.params,
            open_dataset(args.eval, grayscale=cfg.grayscale),
            device=args.device,
        )
        meta["eval"] = {
            args.eval: {
                "psnr_mean": round(res["psnr_mean"], 3),
                "noisy_psnr_mean": round(res["noisy_psnr_mean"], 3),
                "noise": cfg.noise.describe(),
            }
        }
        print(f"eval {args.eval}: {res['psnr_mean']:.3f} dB "
              f"(noisy {res['noisy_psnr_mean']:.3f})")
    zoo.save(args.out, cfg, state.params, meta)
    print(f"wrote {args.out}: step {meta['step']}, "
          f"{param_count(state.params)} params, noise {meta['noise']}")


if __name__ == "__main__":
    main()
