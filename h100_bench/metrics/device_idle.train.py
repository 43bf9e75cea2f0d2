"""device_idle.train (%): the share of the traced window in which no
kernel, copy or memset ran on the device (one profiler window, the union
of device intervals), averaged over the cards. Layer: device."""

from h100_bench.metrics_base import need, positive


def read(records):
    need(records, "train")
    traces = [t for t in records["traces"] if t]
    return positive(100.0 * sum(1.0 - t["busy_s"] / t["window_s"]
                                for t in traces) / len(traces), "idle time")
