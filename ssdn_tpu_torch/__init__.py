"""ssdn_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``ssdn_tpu``.

A second package beside the JAX one, module for module: the JAX package
is the reference and this package imports nothing of it (nor of JAX).
What is ported so far is the serving path (pretrained denoise), the
training step and the training entry point (data, Trainer, evaluation,
CLIs); tiled inference and data parallelism are not:

  config.py   a copy of the JAX package's config (the zoo JSON parses the same)
  zoo.py      reads the bundled ``ssdn_tpu/pretrained/*.npz`` artifacts by path
  ops/        shifted conv / pool / upsample, rotation fold (torch ops)
  kernels/    hand-written CUDA kernels K1 (shifted conv), K2/K2' (1x1 head
              forward) and K3 (its backward), each with its plain PyTorch
              twin and an autograd entry point; built lazily with nvcc
  models/     the blind-spot U-Net; weights carried from JAX trees
  estimator/  the NLL losses and the Bayesian posterior means (fp32)
  noise/      noise injection on the batch's device
  data/       datasets, step-indexed patch samplers, the Prefetcher and its
              host-to-device copy (numpy: the JAX package's batches)
  native/     the C++ crop gatherer, built with g++ on first use
  train/      the training step (four pipelines, Adam, schedules) and the
              Trainer (guard, eval, checkpoints, exact resume)
  infer/      full-image denoise and ``evaluate_dataset``
  cli/        ``python -m ssdn_tpu_torch.cli.{train,evaluate,denoise,
              dataset_tool}``

Tensors at the public functions are NHWC, as in the JAX package; inside,
NCHW in ``channels_last`` memory. Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
