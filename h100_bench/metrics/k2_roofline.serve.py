"""k2_roofline.serve (%): the fused head forward's least time for every
request of the window (``counts.k2_cost`` over the padded image's pixels,
which the kernel reads, on the published peaks) over the device time of
K2's kernels in the trace. Layer: kernels."""

from h100_bench import counts, trace
from h100_bench.metrics_base import need, positive

K2_KERNELS = ("head_fwd_tc_kernel", "head_fwd_fma_kernel")


def read(records):
    t = need(records, "serve")
    k2_s = positive(trace.device_seconds(t, *K2_KERNELS), "K2 kernels")
    n_out = counts.n_outputs(records["blind"])
    least = sum(counts.bound_s(*counts.k2_cost(ph * pw, records["dtype"],
                                               n_out), records["dtype"])
                for ph, pw, _, _ in records["requests"])
    return 100.0 * least / k2_s
