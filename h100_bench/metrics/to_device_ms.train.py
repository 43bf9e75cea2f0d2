"""to_device_ms.train (ms/batch): the mean of the port's span
``ssdn.data.to_device``, in which a Prefetcher worker pins a batch and
issues its copy to the card on the worker's stream (the copy itself runs
on the device, after the span). A run on the CPU makes no copy and reads
nothing. Layer: Trainer and data."""

from h100_bench import program_spans
from h100_bench.metrics_base import need


def read(records):
    need(records, "train")
    return program_spans.mean_ms("ssdn.data.to_device")
