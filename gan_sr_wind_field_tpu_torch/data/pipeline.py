"""Host→device input pipeline: a background thread copies host batches to
the device while the device runs the previous step.

Counterpart of ``gan_sr_wind_field_tpu/data/pipeline.py:prefetch_to_device``;
this is the loop's path when ``device_resident_data`` is off. Exceptions of
the producer are raised again in the consumer: a producer that died
silently would otherwise end the training loop without a word.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

_DONE = object()


def _to_device(x, device):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def prefetch_to_device(iterator, device, size: int = 2):
    """Wrap a host batch iterator; yields the batches on ``device``.

    Each item may be an array or a tuple/list of arrays; every one is
    copied as a float32 tensor."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)

    def put(item):
        if isinstance(item, (tuple, list)):
            return type(item)(_to_device(x, device) for x in item)
        return _to_device(item, device)

    def producer():
        try:
            for item in iterator:
                q.put(put(item))
        except BaseException as e:  # propagate into the consumer
            q.put(e)
            return
        q.put(_DONE)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    while True:
        item = q.get()
        if item is _DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
