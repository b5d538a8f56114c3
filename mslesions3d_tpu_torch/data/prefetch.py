"""Host-to-device batch prefetching.

Counterpart of ``mslesions3d_tpu/data/prefetch.py``. The reference overlaps
data loading with compute through DataLoader worker processes
(datasets.py:141). Here a background thread assembles the host batches and
starts each one's copy to the device while the device computes the step
before: array leaves go through pinned memory with ``non_blocking=True``.
This is the streaming path of ``Trainer.fit``, taken when the dataset is not
held on the device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

_SENTINEL = object()


def _to_device(value: np.ndarray, device: torch.device) -> torch.Tensor:
    tensor = torch.from_numpy(np.ascontiguousarray(value))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def prefetch_batches(iterator, prefetch: int = 2, device="cuda"):
    """Wrap a host-batch iterator with a threaded producer that copies to ``device``.

    ``device`` defaults to the card, as the JAX package's ``device_put``
    defaults to the accelerator; without a card it raises, and the CPU must
    be asked for with ``device="cpu"``.

    Array leaves (numpy arrays) become tensors on ``device`` as soon as a
    batch is produced; other entries pass through. Yields batches in order,
    at most ``prefetch`` ahead. An exception of the producer re-raises at
    the consumer. The copies are queued on the producer thread's current
    stream, the default stream that the steps use, so a step never reads a
    batch before its copy has landed.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prefetch_batches: no CUDA device is available; pass device='cpu' "
                           "to copy the batches to the CPU")
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))

    def put(batch):
        return {k: _to_device(v, device) if isinstance(v, np.ndarray) else v
                for k, v in batch.items()}

    def producer():
        try:
            for batch in iterator:
                q.put(put(batch))
        except Exception as e:  # surface in the consumer
            q.put(e)
            return
        q.put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, Exception):
            raise item
        yield item
