from ssdn_tpu_torch.infer.full import denoise_image, make_denoise_fn

__all__ = ["denoise_image", "make_denoise_fn"]
