"""What the per-layer readers share. A reader is ``metrics/<name>.py`` with
``read(records) -> float``; ``records`` is the traced run's record (the
driver's ``records``: its kind, counts, host spans and the trace's
reduction, ``trace.reduce_trace``). A reader that finds nothing raises
``NothingToRead`` and the metric is left out of the line; a share of a
peak or of a roofline is never reported as 0."""

from __future__ import annotations

from typing import Dict


class NothingToRead(LookupError):
    pass


def need(records: Dict, kind: str) -> Dict:
    """The trace of a ``kind`` ("train" or "serve") run, or NothingToRead."""
    if records.get("kind") != kind:
        raise NothingToRead(f"not a {kind} run")
    if not records.get("trace"):
        raise NothingToRead("no trace")
    return records["trace"]


def positive(value: float, what: str) -> float:
    if not value > 0:
        raise NothingToRead(f"no {what}")
    return value
