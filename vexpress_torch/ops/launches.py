"""Launch counts of the port's kernels and calls of their plain versions.

Each kernel wrapper adds one to its entry in `counts` where it launches its
kernel, and each plain version where it runs. At the same place a wrapper adds
one to `shapes`, keyed by the kernel's name and the shape it was launched at,
so a run can tell how often each shape ran. A run that must show which path it
took (`chip_smoke.py`, the tests) calls `reset()` before it and reads the
counters after it.

A CUDA graph's capture calls the wrappers but launches nothing, and its
replays launch without calling them: a capture runs under `recording()`,
which takes the counts it made out of the counters into a `Record`, and
`replay(record)` adds them back once for each replay of the graph.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Iterator

counts: "collections.Counter[str]" = collections.Counter()
shapes: "collections.Counter[tuple]" = collections.Counter()


def reset() -> None:
    counts.clear()
    shapes.clear()


@dataclasses.dataclass
class Record:
    """The counts that one capture made, by kernel and by shape."""

    counts: "collections.Counter[str]" = dataclasses.field(default_factory=collections.Counter)
    shapes: "collections.Counter[tuple]" = dataclasses.field(default_factory=collections.Counter)


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Moves the counts made inside the block from the counters into the
    Record it yields, once the block ends."""
    record = Record()
    before = counts.copy(), shapes.copy()
    try:
        yield record
    finally:
        for live, old, kept in ((counts, before[0], record.counts),
                                (shapes, before[1], record.shapes)):
            kept.update(live - old)
            live.clear()
            live.update(old)


def replay(record: Record) -> None:
    """Adds one replay of a captured graph's launches to the counters."""
    counts.update(record.counts)
    shapes.update(record.shapes)
