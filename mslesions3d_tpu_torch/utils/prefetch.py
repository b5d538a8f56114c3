"""Background-thread prefetch for host-side data iterators.

Counterpart of ``mslesions3d_tpu/utils/prefetch.py``. The predict path
interleaves two serial resources: host batch assembly (NIfTI load,
normalisation, box derivation; the reference hides this in torch
DataLoader workers) and inference on the card. Assembling the next batch on
a daemon thread while the card runs the current one overlaps them (a
bounded queue, so memory stays at ``depth + 1`` batches).

It moves nothing to the device: the items are the iterable's own. The
trainer's streaming path, which also copies batches to the card from pinned
memory, is ``data/prefetch.py::prefetch_batches``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_DONE = object()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead.

    Order-preserving; an exception raised by the producer re-raises at the
    consuming site. ``depth <= 0`` returns the iterable unchanged (off).
    """
    if depth <= 0:
        return iter(iterable)

    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put((_DONE, e))
        else:
            q.put((_DONE, None))

    threading.Thread(target=producer, daemon=True).start()

    def consumer():
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _DONE:
                if item[1] is not None:
                    raise item[1]
                return
            yield item

    return consumer()
