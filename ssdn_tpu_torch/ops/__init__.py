from ssdn_tpu_torch.ops.rotation import (
    rot90,
    rotation_fold,
    rotation_stack,
    rotation_unfold,
    rotation_unstack,
    trunk_memory_format,
)
from ssdn_tpu_torch.ops.shifted import (
    conv2d,
    leaky_relu,
    matmul_acc_f32,
    maxpool_2x2,
    shift_down,
    shifted_maxpool_2x2,
    shifted_upsample_concat_conv,
    upsample_2x_nearest,
)

__all__ = [
    "conv2d",
    "leaky_relu",
    "matmul_acc_f32",
    "maxpool_2x2",
    "shift_down",
    "shifted_maxpool_2x2",
    "shifted_upsample_concat_conv",
    "upsample_2x_nearest",
    "rot90",
    "rotation_fold",
    "rotation_stack",
    "rotation_unfold",
    "rotation_unstack",
    "trunk_memory_format",
]
