from ssdn_tpu_torch.estimator.core import (
    estimate_sigma,
    mu_only,
    posterior_mean,
    split_outputs,
)

__all__ = ["estimate_sigma", "mu_only", "posterior_mean", "split_outputs"]
