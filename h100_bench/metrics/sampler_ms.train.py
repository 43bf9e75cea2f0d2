"""sampler_ms.train (ms/batch): the mean host-clock span of one
``Trainer.sampler.sample`` call in the window, as the Prefetcher's workers
make it (the benchmark's proxy around the sampler). Layer: Trainer and
data."""

from h100_bench.metrics_base import NothingToRead, positive


def read(records):
    if records.get("kind") != "train" or not records.get("sampler_spans"):
        raise NothingToRead("no sampler spans")
    spans = records["sampler_spans"]
    return positive(1e3 * sum(spans) / len(spans), "sampler time")
