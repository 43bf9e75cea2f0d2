"""ssdn_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``ssdn_tpu``.

A second package beside the JAX one, module for module: the JAX package
is the reference and this package imports nothing of it (nor of JAX).
What is ported so far is the serving path (pretrained denoise) and the
training step:

  config.py   a copy of the JAX package's config (the zoo JSON parses the same)
  zoo.py      reads the bundled ``ssdn_tpu/pretrained/*.npz`` artifacts by path
  ops/        shifted conv / pool / upsample, rotation fold (torch ops)
  kernels/    hand-written CUDA kernels K1 (shifted conv), K2/K2' (1x1 head
              forward) and K3 (its backward), each with its plain PyTorch
              twin and an autograd entry point; built lazily with nvcc
  models/     the blind-spot U-Net; weights carried from JAX trees
  estimator/  the NLL losses and the Bayesian posterior means (fp32)
  noise/      noise injection on the batch's device
  train/      the training step (four pipelines, Adam, schedules)
  infer/      full-image denoise
  cli/        ``python -m ssdn_tpu_torch.cli.denoise``

Tensors at the public functions are NHWC, as in the JAX package; inside,
NCHW in ``channels_last`` memory. Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
