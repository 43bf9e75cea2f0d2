"""The port's own spans (``ssdn_tpu_torch.utils.debug``: ``span``,
``spans``, ``totals``) as the readers of ``"source": "program_span"``
metrics see them. The port records its spans only while a profiler
session records and keeps the newest session's, so after a traced run they
are the traced window's. A port that records none, or a span that the
window never entered (a copy to the device in a CPU run), reads nothing
(``NothingToRead``)."""

from __future__ import annotations

from typing import List

from h100_bench.metrics_base import NothingToRead


def _debug():
    from ssdn_tpu_torch.utils import debug

    if not hasattr(debug, "spans"):
        raise NothingToRead("the port records no spans")
    return debug


def spans() -> List:
    """The window's spans (``debug.Span``: name, start_ns, end_ns, thread,
    parent), in the order they started."""
    return _debug().spans()


def mean_ms(name: str) -> float:
    """The mean duration of the span ``name`` in the window, in ms."""
    count, seconds = _debug().totals().get(name, (0, 0.0))
    if not count:
        raise NothingToRead(f"no span {name}")
    return 1e3 * seconds / count
