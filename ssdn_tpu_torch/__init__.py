"""ssdn_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``ssdn_tpu``.

A second package beside the JAX one, module for module: the JAX package
is the reference and this package imports nothing of it (nor of JAX).
Everything the JAX package does is ported, nothing is left: the serving
path (pretrained denoise, full-image, sequential and sharded tiled), the
training step, the training entry point (data, Trainer, evaluation,
CLIs), data parallelism over ``torch.distributed``, the zoo's writer and
the tools:

  config.py   a copy of the JAX package's config (the zoo JSON parses the same)
  zoo.py      reads the bundled ``ssdn_tpu/pretrained/*.npz`` artifacts by
              path, and writes artifacts in the same layout
  ops/        shifted conv / pool / upsample, rotation fold (torch ops)
  numerics.py what ops/ and kernels/ share (precision contract, layout,
              LeakyReLU and a conv's epilogue in torch ops); kernels/
              imports nothing of ops/
  kernels/    hand-written CUDA kernels K1 (shifted conv), K2/K2' (1x1 head
              forward), K3 (its backward) and the bf16 trunk conv's
              epilogue, each with its plain PyTorch twin and an autograd
              entry point; built lazily with nvcc
  models/     the blind-spot U-Net; weights carried from JAX trees
  estimator/  the NLL losses and the Bayesian posterior means (fp32)
  noise/      noise injection on the batch's device
  data/       datasets, step-indexed patch samplers, the Prefetcher and its
              host-to-device copy (numpy: the JAX package's batches)
  native/     the C++ crop gatherer, built with g++ on first use
  train/      the training step (four pipelines, Adam, schedules) and the
              Trainer (guard, eval, checkpoints, exact resume)
  parallel/   process groups (``torchrun``: NCCL on the cards, gloo on the
              CPU) and the collectives of DP training and sharded tiling
  infer/      full-image denoise, sequential tiled denoise (one window of
              ``tile_w + 2*halo`` columns at a time), sharded tiled
              denoise (per-level halo exchange ``halo.py``, exchange and
              gather windows) and ``evaluate_dataset``
  utils/      images, device selection, and the debug helpers (profiler
              trace, anomaly mode, step timer, finiteness check)
  cli/        ``python -m ssdn_tpu_torch.cli.{train,evaluate,denoise,
              dataset_tool}``
  tools/      ``python -m ssdn_tpu_torch.tools.{export_pretrained,
              blind_calibration,parity_check}``

Tensors at the public functions are NHWC, as in the JAX package; inside,
NCHW, in ``channels_last`` memory for a bf16 trunk and contiguous for an
fp32 one (``ops.trunk_memory_format``). Entry points run on the GPU unless the
caller passes ``device="cpu"``; where the JAX package takes a ``mesh``, the
port takes a ``parallel.Group``.
"""

__version__ = "0.1.0"
