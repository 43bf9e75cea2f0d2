from ssdn_tpu_torch.infer.full import (
    denoise_image,
    evaluate_dataset,
    make_denoise_fn,
)

__all__ = ["denoise_image", "evaluate_dataset", "make_denoise_fn"]
