"""dispatch_ms.serve (ms/request): the mean of the port's span
``ssdn.infer.forward``, the host's time in a request's forward and
posterior mean: enqueueing their work on the card, and waiting for it
wherever a copy from pageable host memory synchronises the stream. Layer:
inference."""

from h100_bench import program_spans
from h100_bench.metrics_base import need


def read(records):
    need(records, "serve")
    return program_spans.mean_ms("ssdn.infer.forward")
