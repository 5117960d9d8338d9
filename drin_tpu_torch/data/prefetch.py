# -*- coding: utf-8 -*-
"""Host-side prefetching: batch assembly + device transfer run ahead of the
training step in a background thread.

A single background thread is enough because batch assembly is whole-batch
numpy (``dataset.py``): the thread keeps a depth-bounded queue of batches
already copied to the device, so the device never waits on the host
(double/triple buffering via ``depth``).  The port's own copy of
``drin_tpu/data/prefetch.py``."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from drin_tpu_torch.common.spans import span


class _Sentinel:
    pass


_END = _Sentinel()


class Prefetcher:
    """Iterate ``source`` in a background thread, applying ``transform``
    (e.g. pad + device_put) to each item, keeping up to ``depth`` transformed
    items ready.  Exceptions in the worker propagate to the consumer.

    If the consumer abandons iteration early (an exception in the train
    step, a break), call :meth:`close` — or use the context manager — to
    unblock and join the worker; otherwise the thread would sit in
    ``q.put`` holding device-resident batches for the process lifetime
    (a leak that compounds across retried epochs in a long-lived process)."""

    def __init__(self, source: Iterable, transform: Optional[Callable] = None, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._transform = transform or (lambda x: x)
        self._exc: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, args=(iter(source),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """put() that aborts when close() was requested (bounded wait so a
        blocked worker notices the stop flag)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it: Iterator):
        try:
            for item in it:
                if self._stop.is_set() or not self._put(self._transform(item)):
                    return
        except BaseException as e:  # propagate to the consumer
            self._exc = e
        finally:
            self._put(_END)

    def close(self):
        """Stop the worker and drop queued items (releasing their device
        buffers); idempotent, safe after normal exhaustion too."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=10)
        # a put() that had already passed the stop check can land BEHIND the
        # first drain; the worker is done (or parked on the stop flag) after
        # the join, so one more drain guarantees nothing stays queued —
        # otherwise the last device batch lives until the Prefetcher is GC'd
        self._drain()

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        with span("drin.prefetch.wait"):
            item = self._q.get()
        if item is _END:
            self._thread.join()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item
