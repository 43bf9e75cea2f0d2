"""device_idle.serve (%): the share of the traced serving window in which
no kernel, copy or memset ran on the device (one profiler window, the union
of device intervals). Layer: device. Where the host sets the pace, the
profiler's cost on the host raises it above an untraced run's idle
share."""

from h100_bench.metrics_base import need, positive


def read(records):
    t = need(records, "serve")
    return positive(100.0 * (1.0 - t["busy_s"] / t["window_s"]), "idle time")
