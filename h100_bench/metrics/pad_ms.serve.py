"""pad_ms.serve (ms/request): the mean of the port's span
``ssdn.infer.pad``, the host's reflect pad of a request's image to the
network's stride in ``denoise_image``, once per request. Layer:
inference."""

from h100_bench import program_spans
from h100_bench.metrics_base import need


def read(records):
    need(records, "serve")
    return program_spans.mean_ms("ssdn.infer.pad")
