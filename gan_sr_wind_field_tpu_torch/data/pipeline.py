"""Host→device input pipeline: a background thread copies host batches to
the device while the device runs the previous step.

Counterpart of ``gan_sr_wind_field_tpu/data/pipeline.py:prefetch_to_device``;
this is the loop's path when ``device_resident_data`` is off. Exceptions of
the producer are raised again in the consumer: a producer that died
silently would otherwise end the training loop without a word. ``close``
stops the producer, which otherwise would wait forever to hand over the
batches it copied ahead, holding them on the device.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

_DONE = object()


def _to_device(x, device):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


class Prefetcher:
    """Iterator over the batches of a host iterator, copied to ``device``
    by a producer thread at most ``size`` batches ahead. ``wait_s`` sums
    the seconds the consumer waited for a batch (host clock)."""

    def __init__(self, iterator, device, size: int = 2):
        self.device = torch.device(device)
        self.wait_s = 0.0
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._produce,
                                        args=(iterator,), daemon=True,
                                        name="prefetch_to_device")
        self._thread.start()

    def _put(self, item) -> bool:
        """Hand ``item`` over unless ``close`` was called first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, iterator):
        try:
            for item in iterator:
                if isinstance(item, (tuple, list)):
                    item = type(item)(_to_device(x, self.device)
                                      for x in item)
                else:
                    item = _to_device(item, self.device)
                if not self._put(item):
                    return
        except BaseException as e:  # propagate into the consumer
            self._put(e)
            return
        self._put(_DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t = time.monotonic()
        item = self._q.get()
        self.wait_s += time.monotonic() - t
        if item is _DONE:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return item

    def close(self, timeout: float = 10.0) -> None:
        """Stop the producer and drop the batches it copied ahead."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)


def prefetch_to_device(iterator, device, size: int = 2) -> Prefetcher:
    """Wrap a host batch iterator; yields the batches on ``device``.

    Each item may be an array or a tuple/list of arrays; every one is
    copied as a float32 tensor. ``close()`` the result when done."""
    return Prefetcher(iterator, device, size)
