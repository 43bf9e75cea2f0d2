"""request_mfu.serve (%): the model FLOPs of every request answered in the
window (the forward of the published architecture over each image's real,
unpadded pixels, ``counts.forward_flops``) over the window's wall time
times the compute dtype's peak. Layer: inference. It is read in the
traced run: where the host sets the pace, the profiler's cost on the host
lowers it, so it compares with other traced runs only."""

from h100_bench import counts
from h100_bench.metrics_base import need, positive


def read(records):
    need(records, "serve")
    flops = sum(counts.forward_flops(h, w, records["blind"])
                for _, _, h, w in records["requests"])
    return positive(100.0 * flops / (records["wall_s"]
                                     * counts.PEAK_OPS[records["dtype"]]),
                    "requests")
