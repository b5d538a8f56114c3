"""Serve SSD3D detections: a live model on the card plus request coalescing.

Counterpart of the serving half of ``mslesions3d_tpu/serving.py``.
:class:`Detector` holds the model in eval mode and the priors on its device
and answers ``predict(images)`` with the chunk-and-pad routing of the JAX
package's ``ServingDetector``; :class:`RequestBatcher` coalesces concurrent
requests into shared device calls. The ``.mslx`` bundle export and the HTTP
front end are not ported yet (ROADMAP).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .models.ssd3d import SSD3D, SSD3DConfig, detect, model_priors


class Detector:
    """End-to-end detection (backbone, heads, decode, NMS, top-k) on one device.

    ``device`` defaults to the card; a missing card raises rather than
    running on the CPU, which must be asked for with ``device="cpu"``.
    Weights come from ``state_dict`` (the reference schema, e.g. from
    :func:`..weights.from_jax_variables`) or, if it is None, from the
    "torch" init scheme seeded with ``seed``. Requests are routed onto
    ``batch_sizes`` as in the JAX package's ``ServingDetector``: each chunk
    takes the largest batch size that fits the rows left, and a last partial
    chunk is padded with zero volumes whose rows are dropped.
    """

    def __init__(self, config: SSD3DConfig, state_dict: dict | None = None, *,
                 device="cuda", seed: int = 0, batch_sizes=(1, 8, 32)):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Detector: no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        self.config = config
        self.batch_sizes = sorted({int(b) for b in batch_sizes})
        model = SSD3D(config, generator=torch.Generator().manual_seed(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.eval().to(self.device, memory_format=torch.channels_last_3d)
        self.priors = torch.from_numpy(model_priors(config)).to(self.device)

    @torch.inference_mode()
    def detect(self, images: torch.Tensor) -> dict:
        """images (B, D, H, W, C) on the device -> detection dict of tensors."""
        return detect(self.config, *self.model(images), self.priors)

    def predict(self, images) -> dict:
        """images: (B, D, H, W, C) array -> detection dict of numpy arrays (size B)."""
        images = np.asarray(images)
        n = images.shape[0]
        if n == 0:
            top_k = self.config.top_k
            return {
                "boxes": np.zeros((0, top_k, 6), np.float32),
                "labels": np.zeros((0, top_k), np.int32),
                "scores": np.zeros((0, top_k), np.float32),
                "count": np.zeros((0,), np.int32),
            }
        outs = []
        start = 0
        while start < n:
            remaining = n - start
            fits = [b for b in self.batch_sizes if b <= remaining]
            b = max(fits) if fits else min(self.batch_sizes)
            chunk = images[start: start + b]
            pad = b - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                self.device, self.config.compute_dtype
            )
            det = self.detect(x)
            outs.append({k: v[: b - pad].cpu().numpy() for k, v in det.items()})
            start += b - pad
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


class RequestBatcher:
    """Coalesce concurrent predict requests into shared device calls.

    One dispatcher thread drains a bounded queue: while one device call is
    in flight, arriving requests accumulate, and the next call takes them
    all (up to ``max_rows``) in one concatenated batch. ``submit(rows)``
    blocks until its rows' results are ready and returns its slice of the
    detection dict. The bounded queue gives backpressure.
    """

    def __init__(self, predict_fn, max_rows: int = 64, max_queue: int = 256):
        self._predict = predict_fn
        self._max_rows = max_rows
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self.device_calls = 0  # dispatches actually issued
        self._thread = threading.Thread(target=self._run, name="msl-request-batcher",
                                        daemon=True)
        self._thread.start()

    def submit(self, rows: np.ndarray) -> dict:
        done = threading.Event()
        slot: dict = {}
        self._q.put((rows, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            rows = item[0].shape[0]
            # drain what queued while the previous call was in flight
            while rows < self._max_rows:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:  # shutdown sentinel: re-post and finish this batch
                    self._q.put(None)
                    break
                batch.append(nxt)
                rows += nxt[0].shape[0]
            stacked = (batch[0][0] if len(batch) == 1
                       else np.concatenate([b[0] for b in batch], axis=0))
            try:
                self.device_calls += 1
                res = self._predict(stacked)
            except Exception as e:  # deliver to every coalesced caller
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()
                continue
            off = 0
            for arr, done, slot in batch:
                n = arr.shape[0]
                slot["result"] = {k: v[off:off + n] for k, v in res.items()}
                off += n
                done.set()
