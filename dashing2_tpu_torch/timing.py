"""Phase timing / progress observability.

Copy of dashing2_tpu/timing.py, cut to the phase and span timers. The
spans are host wall-clock: a span around a CUDA launch measures the
enqueue unless the code inside it synchronises. Device time is read with
CUDA events by the callers that need it (chip_smoke.py).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time


@contextlib.contextmanager
def phase(name: str, verbosity: int = 0, min_level: int = 1):
    """Time a pipeline phase; prints to stderr when verbosity >= min_level
    (repeated -v raises it, options.h:364). Always records into the
    span accumulator (below) so harnesses can read the breakdown."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        add_span(name, dt)
        if verbosity >= min_level:
            print(f"#dashing2-tpu-torch [{name}] {dt:.3f}s", file=sys.stderr)


# ----------------------------------------------------------------------
# span accumulator: named wall-clock totals across a run, so harnesses
# (chip_smoke.py) can publish a per-phase breakdown. Spans may be added
# from the emitter's prefetch thread, hence the lock.
# ----------------------------------------------------------------------

_spans: dict = {}
_spans_lock = threading.Lock()


def add_span(name: str, dt: float) -> None:
    with _spans_lock:
        _spans[name] = _spans.get(name, 0.0) + dt


def spans() -> dict:
    """Accumulated {name: seconds} since the last reset."""
    with _spans_lock:
        return dict(_spans)


def reset_spans() -> None:
    with _spans_lock:
        _spans.clear()


@contextlib.contextmanager
def span(name: str):
    """Accumulate wall-clock into the named span (no printing)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_span(name, time.perf_counter() - t0)
