"""k3_roofline.train (%): the fused head backward's least time at the
step's shapes (``counts.k3_cost`` over the card's rows times the patch
area, on the published peaks) times the window's steps, over the device
time of K3's kernels in the trace. Layer: kernels."""

from h100_bench import counts, trace
from h100_bench.metrics_base import need, positive

K3_KERNELS = ("bwd_rows_tc_kernel", "bwd_rows_fma_kernel", "bwd_dx_fma_kernel",
              "wgrad_tc_kernel", "wgrad_fma_kernel", "reduce_splits_kernel")


def read(records):
    t = need(records, "train")
    k3_s = positive(trace.device_seconds(t, *K3_KERNELS), "K3 kernels")
    m = records["rows_per_card"] * records["patch"] ** 2
    nbytes, ops = counts.k3_cost(m, records["dtype"],
                                 counts.n_outputs(records["blind"]))
    least = counts.bound_s(nbytes, ops, records["dtype"]) * records["steps"]
    return 100.0 * least / k3_s
