"""batch_wait_ms.train (ms/step): the mean of the port's span
``ssdn.trainer.next_batch``, the time the Trainer's loop waits for the next
batch from the Prefetcher and orders its stream after the batch's copy,
once per step. Layer: Trainer and data."""

from h100_bench import program_spans
from h100_bench.metrics_base import need


def read(records):
    need(records, "train")
    return program_spans.mean_ms("ssdn.trainer.next_batch")
