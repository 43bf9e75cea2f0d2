from ssdn_tpu_torch.utils.debug import (
    assert_finite_tree,
    debug_nans,
    profile_trace,
)
from ssdn_tpu_torch.utils.device import resolve_device
from ssdn_tpu_torch.utils.images import (
    from_internal,
    list_images,
    load_image,
    pad_to_multiple,
    psnr,
    save_image,
    to_internal,
)

__all__ = [
    "assert_finite_tree",
    "debug_nans",
    "profile_trace",
    "resolve_device",
    "from_internal",
    "list_images",
    "load_image",
    "pad_to_multiple",
    "psnr",
    "save_image",
    "to_internal",
]
