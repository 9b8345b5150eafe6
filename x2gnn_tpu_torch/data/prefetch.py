"""Background-thread prefetch for the streamed data paths
(x2gnn_tpu/data/prefetch.py).

When the Trainer does not cache batches on the card (datasets over ~20k
molecules), each step would wait for the host to assemble and pad the
next GraphBatch. `prefetch` runs the producing iterator in a daemon
thread a bounded number of items ahead, so host batch assembly (and,
for the card, the copy issued on a stream of its own) overlaps the
device's compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from `it`, produced in a background daemon thread up to
    `depth` items ahead. Exceptions in the producer are re-raised at the
    consuming call site. Abandoning the iterator (early break, exception
    in the consumer, garbage collection) cancels the producer: the worker
    polls a stop event between puts instead of blocking forever, so no
    thread or buffered batch outlives the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(item) -> bool:
        """put() that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            src = iter(it)
            while True:
                # re-check stop BEFORE advancing the source: a put that
                # raced a consumer shutdown must not pull (and strand)
                # one more item from the underlying iterator
                if stop.is_set():
                    return
                try:
                    item = next(src)
                except StopIteration:
                    break
                if not _put(item):
                    return
        except BaseException as exc:    # re-raise on the consumer side
            _put((_SENTINEL, exc))
            return
        _put((_SENTINEL, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        # drain until the producer has actually exited — a put already in
        # flight when stop was set can land after a single drain pass
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
