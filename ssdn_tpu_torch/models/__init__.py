from ssdn_tpu_torch.models.blindspot_unet import (
    apply,
    init_params,
    layer_shapes,
    param_count,
    params_from_jax,
    params_to_jax,
)

__all__ = ["apply", "init_params", "layer_shapes", "param_count",
           "params_from_jax", "params_to_jax"]
