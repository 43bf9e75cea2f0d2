"""fixed_ms.train (ms/call): the time of one ``Trainer.train`` call spent
outside its steps and guard windows: the port's spans
``ssdn.trainer.start`` (restore or init, replicate, the guard's first
snapshot, the Prefetcher's start), ``ssdn.trainer.eval`` and
``ssdn.trainer.checkpoint`` (each save, and the closing of the Prefetcher
and the checkpoint managers), over the calls. A span inside another of the
three (a best checkpoint saved by an eval) is counted once. Layer: Trainer
and data."""

from h100_bench import program_spans
from h100_bench.metrics_base import NothingToRead, need

START = "ssdn.trainer.start"
FIXED = (START, "ssdn.trainer.eval", "ssdn.trainer.checkpoint")


def read(records):
    need(records, "train")
    recs = program_spans.spans()
    done = [s for s in recs if s.end_ns is not None]
    calls = sum(s.name == START for s in done)
    if not calls:
        raise NothingToRead(f"no span {START}")
    ns = sum(s.end_ns - s.start_ns for s in done if s.name in FIXED and (
        s.parent is None or recs[s.parent].name not in FIXED))
    return ns / 1e6 / calls
