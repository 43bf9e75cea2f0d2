from ssdn_tpu_torch.estimator.core import (
    estimate_sigma,
    mse_loss,
    mu_only,
    nll,
    posterior_mean,
    split_outputs,
)

__all__ = ["estimate_sigma", "mse_loss", "mu_only", "nll", "posterior_mean",
           "split_outputs"]
