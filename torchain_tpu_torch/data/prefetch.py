"""Background prefetching for the chunk loaders (a copy of
torchain_tpu/data/prefetch.py).

The egs role Kaldi solved with offline archives (SURVEY.md section 2.2):
supervision compilation is host-side Python work; without overlap it
serializes with device steps.  `Prefetcher` wraps any batch iterator with
a bounded background thread so the next batch's FST compilation runs while
the device executes the current step.  Thread-based (the work is numpy/
pure-Python but releases chunks of the GIL in numpy ops); depth 2 keeps
one batch ready while the next is prepared.
"""

from __future__ import annotations

import queue
import threading


class _End:
    pass


class Prefetcher:
    """Iterate `iterable` on a background thread, `depth` items ahead.

    Exceptions raised by the producer are re-raised at the consumer's next
    __next__ call.  Always either exhaust the iterator or call .close(),
    which returns when the producer's thread has ended.
    """

    def __init__(self, iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, args=(iter(iterable),), daemon=True
        )
        self._thread.start()

    def _run(self, it):
        try:
            for item in it:
                if self._closed:
                    return
                self._q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            self._exc = e
        finally:
            # a generator's own resources (a loader's thread pool) end here,
            # on this thread, not at garbage collection
            close = getattr(it, "close", None)
            if close is not None:
                close()
            self._q.put(_End)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _End:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        """Stop the producer and wait for its thread to end (it finishes the
        item it is making): no thread outlives the iterator."""
        self._closed = True
        # drain so the producer unblocks, until it has put _End
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
