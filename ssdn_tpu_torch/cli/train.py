"""Training CLI, on the GPU (port of ``ssdn_tpu/cli/train.py``; reference
repo-root ``train.py`` [R]). The same flags as the JAX package's, plus
``--device``.

Examples:
  python -m ssdn_tpu_torch.cli.train --workdir /tmp/run1 \
      --noise-style gauss25 --grayscale --train-data /data/bsds300 \
      --eval-data /data/kodak --iterations 100000
  python -m ssdn_tpu_torch.cli.train --workdir /tmp/demo \
      --train-data synthetic:64 --iterations 200 --eval-data synthetic:4 \
      --compute-dtype float32
  # on the CPU, at a tiny width
  python -m ssdn_tpu_torch.cli.train --workdir /tmp/cpu --device cpu \
      --train-data synthetic:8:64 --iterations 4 --batch-size 2 \
      --patch-size 32 --enc-features 8 --dec-features 16 \
      --nin-a-features 32 --nin-b-features 16
  # data-parallel over the node's cards, one process per card (NCCL);
  # --batch-size is the global batch, split over the ranks
  torchrun --nproc-per-node 4 -m ssdn_tpu_torch.cli.train --data-parallel \
      --workdir /tmp/dp --batch-size 384 ...
"""

from __future__ import annotations

import argparse

from ssdn_tpu_torch import parallel
from ssdn_tpu_torch.config import (
    ModelConfig,
    Pipeline,
    TrainConfig,
    parse_noise_style,
)
from ssdn_tpu_torch.train.loop import Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument(
        "--algorithm",
        default="ssdn",
        choices=[pl.value for pl in Pipeline],
        help="ssdn | ssdn_mse (mu-only ablation) | n2c | n2n",
    )
    p.add_argument(
        "--noise-style",
        default="gauss25",
        help="gauss25 | gauss5_50 | poisson30 | impulse50 (SURVEY.md §2.1)",
    )
    p.add_argument(
        "--blind",
        nargs="?",
        const="variable",
        default=None,
        choices=["variable", "const"],
        help="estimate the noise parameter instead of feeding the true "
        "value (SURVEY.md §2.5 blind-sigma; reference NoiseValue modes): "
        "'variable' (bare --blind; per-image, network-estimated) or "
        "'const' (corpus-constant, learned as a free scalar)",
    )
    p.add_argument("--train-data", default="synthetic:64:128",
                   help="image folder | .h5 file | synthetic[:n[:size]]")
    p.add_argument("--eval-data", default=None)
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--patch-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--iterations", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--objective", default="stabilized",
                   choices=["stabilized", "reference"],
                   help="'stabilized' (default): Huberized residuals, soft "
                        "output bounds, beta-NLL — the production numerics "
                        "with identical per-pixel optima. "
                        "'reference': the reference repo's exact "
                        "objective — raw NLL, unbounded outputs, beta=0, "
                        "Adam eps 1e-8, fp32/HIGHEST (forces those knobs)")
    p.add_argument("--nll-beta", type=float, default=1.0,
                   help="beta-NLL pixel weight exponent; 1.0 = stable "
                        "default with identical per-pixel optima "
                        "(--objective reference forces 0)")
    p.add_argument("--blind-reg", type=float, default=0.1,
                   help="blind-noise anti-degeneracy barrier weight "
                        "([P] §3.1; estimator.nll)")
    p.add_argument("--blind-reg-rampdown", type=float, default=0.0,
                   help="cosine the barrier weight to 0 over this final "
                        "fraction of training (0 = constant barrier; "
                        "removes the converged alpha_hat midpoint bias — "
                        "config.py field note)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-interval", type=int, default=10_000)
    p.add_argument("--eval-patience", type=int, default=0,
                   help="early-stop after N consecutive evals more than "
                        "--eval-patience-delta dB below the best (0 = off); "
                        "ckpt_best keeps the best state either way")
    p.add_argument("--eval-patience-delta", type=float, default=1.0)
    p.add_argument("--snapshot-interval", type=int, default=10_000)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--compute-dtype", default="auto",
                   choices=["auto", "bfloat16", "float32"],
                   help="auto = bfloat16 for --objective stabilized, "
                        "float32 for --objective reference (conservative "
                        "parity default, ~40%% the speed); an explicit "
                        "value is always respected — including bfloat16 "
                        "with --objective reference (measured stable on "
                        "non-degenerate corpora, README)")
    p.add_argument("--conv-precision", default="highest",
                   choices=["default", "high", "highest"])
    p.add_argument("--conv-backend", default="lax", choices=["lax", "pallas"])
    p.add_argument("--decoder-mode", default="fused", choices=["fused", "naive"])
    p.add_argument("--enc-features", type=int, default=48,
                   help="encoder conv width (48 = paper; smaller for "
                        "experiments/CI)")
    p.add_argument("--dec-features", type=int, default=96,
                   help="decoder conv width (96 = paper)")
    p.add_argument("--nin-a-features", type=int, default=384)
    p.add_argument("--nin-b-features", type=int, default=96)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--sampler-backend", default="auto",
                   choices=["auto", "native", "python"],
                   help="host patch gatherer: C++ (native) or pure Python")
    p.add_argument("--prefetch-depth", type=int, default=12,
                   help="host->device prefetch pipeline depth (batches "
                        "sampled/transferred ahead of the training step)")
    p.add_argument("--prefetch-threads", type=int, default=4,
                   help="concurrent sample + host-to-device copy worker "
                        "threads; >1 keeps several copies in flight")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the window holding "
                        "step 10 to this dir (trace.json, chrome://tracing)")
    p.add_argument(
        "--data-parallel",
        action="store_true",
        help="shard the batch over the ranks of a torchrun launch (one "
             "process per card, NCCL; gloo with --device cpu); only rank "
             "0 writes the workdir",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model trains (default: the GPU)")
    return p


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        pipeline=Pipeline(args.algorithm),
        noise=parse_noise_style(args.noise_style, blind=args.blind),
        model=ModelConfig(
            in_channels=1 if args.grayscale else 3,
            compute_dtype=args.compute_dtype,
            conv_backend=args.conv_backend,
            conv_precision=args.conv_precision,
            decoder_mode=args.decoder_mode,
            enc_features=args.enc_features,
            dec_features=args.dec_features,
            nin_a_features=args.nin_a_features,
            nin_b_features=args.nin_b_features,
        ),
        objective=args.objective,
        patch_size=args.patch_size,
        batch_size=args.batch_size,
        iterations=args.iterations,
        lr=args.lr,
        grad_clip=args.grad_clip,
        blind_reg=args.blind_reg,
        blind_reg_rampdown_frac=args.blind_reg_rampdown,
        nll_beta=args.nll_beta,
        seed=args.seed,
        eval_interval=args.eval_interval,
        eval_patience=args.eval_patience,
        eval_patience_delta=args.eval_patience_delta,
        snapshot_interval=args.snapshot_interval,
        grayscale=args.grayscale,
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    group = parallel.init_group(args.device) if args.data_parallel else None
    try:
        trainer = Trainer(
            cfg,
            args.workdir,
            train_data=args.train_data,
            eval_data=args.eval_data,
            log_interval=args.log_interval,
            sampler_backend=args.sampler_backend,
            profile_dir=args.profile_dir,
            prefetch_depth=args.prefetch_depth,
            prefetch_threads=args.prefetch_threads,
            device=args.device,
            group=group,
        )
        if trainer.rank0:
            print(f"training: {cfg.pipeline.value} | {cfg.noise.describe()} "
                  f"| objective={cfg.objective} | {cfg.patch_size}px "
                  f"x{cfg.batch_size} | {cfg.iterations} iters"
                  + (f" | data-parallel x{group.world}" if group else ""),
                  flush=True)
        trainer.train(resume=not args.no_resume)
    finally:
        if group is not None:
            parallel.destroy_group()


if __name__ == "__main__":
    main()
