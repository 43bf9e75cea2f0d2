"""step_mfu.train (%): the model FLOPs of the window's steps on one card
(three times the published architecture's forward over the card's rows,
``counts.step_flops``) over the window's wall time times the compute
dtype's peak. Layer: train step."""

from h100_bench import counts
from h100_bench.metrics_base import need, positive


def read(records):
    need(records, "train")
    flops = records["steps"] * counts.step_flops(
        records["rows_per_card"], records["patch"], records["blind"])
    return positive(100.0 * flops / (records["wall_s"]
                                     * counts.PEAK_OPS[records["dtype"]]),
                    "steps")
