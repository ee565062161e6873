"""Producer/consumer pipeline overlap for host ingest.

Whole copy of dashing2_tpu/io/prefetch.py. In the port it drives the
comparison generator (and with it the CUDA kernel launch) from a
background thread while the emitter writes.

Reference parity: the salmon-derived FastxParser feeder threads + lock-free
queues (src/fqfeeder.cpp, src/FastxParser.hpp, used by contain's read loop
src/contain_main.cpp:81-107) and the async emit thread (P4/P8 in SURVEY
§2.4). Here one background thread runs the (file read + encode + pack)
generator and a bounded queue hands fixed-shape batches to the device
loop, so host packing overlaps device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `it` on a background thread, keeping up to `depth` items
    ready. Exceptions in the producer re-raise at the consumer.

    Abandoning the generator early (consumer error, GeneratorExit) sets
    a cancellation flag the producer polls through its bounded put, so
    the thread exits instead of blocking forever on a full queue with
    the in-flight item pinned."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err = []
    cancelled = threading.Event()

    def _put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - reraised at consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        cancelled.set()
