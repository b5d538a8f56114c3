"""Serve SSD3D detections: a live model on the card, ``.mslx`` bundles, request coalescing.

Counterpart of ``mslesions3d_tpu/serving.py``. :class:`Detector` holds the
model in eval mode and the priors on its device and answers
``predict(images)``. :func:`export_detector` and
:func:`export_sliding_window_detector` capture the end-to-end detection
function (backbone, heads, decode, NMS, top-k; or the whole patch-tile and
stitch program) with ``torch.export``, the weights baked into the program,
one program per batch size and platform; :func:`save_bundle` writes them
into one ``.mslx`` zip; :class:`ServingDetector` loads a bundle without the
model code or a checkpoint and routes requests onto its batch sizes.
:class:`RequestBatcher` coalesces concurrent requests into shared predict
calls.

The kernels K1-K3 (and the int8 conv Q1 of ``quant.py``) are registered
torch ops (``msl::greedy_nms``, ``msl::fused_depthwise_bn_relu``,
``msl::fused_tail``, ``msl::qconv``), so an exported program calls them as
the live model does: on the card they launch the kernels, on the CPU their
plain versions run.

On a card, :func:`route` stages its uploads (:class:`_Staging`): the host
casts a chunk into a pinned buffer of the thread's in the served dtype, and
the copy to the card runs while the host launches the program. On the CPU a
chunk takes one ``.to(device, dtype)``.

Spans (``utils.profiling.span``, profiler ranges opened only while a
profiler records): ``msl.route`` around a whole :func:`route` call, and in
it, a chunk at a time, ``msl.route.upload`` (the host cast and, on a
card, the queued copy; on the CPU the ``.to``), ``msl.detect``
(the program call) and ``msl.route.fetch`` (the wait for the device and the
copy back); ``msl.detect_objects`` around the detection of a live
:class:`DetectionProgram`. Counters: ``route.program_calls``,
``route.padded_rows``, ``route.staged_uploads`` (program calls whose input
was staged) and ``route.staged_bytes`` (the host bytes staged), and
:class:`RequestBatcher`'s ``requests``, ``rows``, ``device_calls`` and
``queue_wait_s``.

Bundle layout (a single ``.mslx`` zip):
  manifest.json            config, input spec, batch sizes, platforms, versions
  fn_b{N}_{platform}.pt2   a ``torch.export`` program per batch size and platform
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
import types
import zipfile
from pathlib import Path

import numpy as np
import torch
from torch import nn

from . import quant
from .models.ssd3d import SSD3D, SSD3DConfig, model_priors
from .ops.nms import detect_objects
from .utils.profiling import span

MANIFEST_VERSION = 1
FORMAT = "torch.export"


class DetectionProgram(nn.Module):
    """images (B, D, H, W, C) -> detection dict: a model's (locs, scores)
    through ``detect_objects`` with min_score, max_overlap and top_k fixed.

    ``model`` is any module mapping images to (locs (B, P, 6), scores (B, P,
    n_classes)): the eval-mode :class:`SSD3D`, or the int8 model of
    ``quant.py``. The priors are a buffer, so that an exported program
    carries them.
    """

    def __init__(self, model: nn.Module, priors, *, n_classes: int, min_score: float,
                 max_overlap: float, top_k: int):
        super().__init__()
        self.model = model
        self.register_buffer("priors", torch.as_tensor(priors, dtype=torch.float32))
        self.n_classes, self.min_score = int(n_classes), float(min_score)
        self.max_overlap, self.top_k = float(max_overlap), int(top_k)

    @classmethod
    def for_config(cls, model: nn.Module, config: SSD3DConfig, *, min_score=None,
                   top_k=None) -> "DetectionProgram":
        """``model`` with ``config``'s priors and NMS settings (min_score and
        top_k overridden where given)."""
        return cls(model, model_priors(config), n_classes=config.n_classes,
                   min_score=config.min_score if min_score is None else min_score,
                   max_overlap=config.max_overlap,
                   top_k=config.top_k if top_k is None else top_k)

    def forward(self, images: torch.Tensor) -> dict:
        locs, scores = self.model(images)
        with span("msl.detect_objects"):
            return detect_objects(locs, scores, self.priors, n_classes=self.n_classes,
                                  min_score=self.min_score, max_overlap=self.max_overlap,
                                  top_k=self.top_k)


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
        self.device = require_device(device, "Detector")
        self.config = config
        self.batch_sizes = sorted({int(b) for b in batch_sizes})
        model = SSD3D(config, generator=torch.Generator().manual_seed(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.eval().to(self.device, memory_format=torch.channels_last_3d)
        self.program = DetectionProgram.for_config(self.model, config).to(self.device)
        self.priors = self.program.priors

    @torch.inference_mode()
    def detect(self, images: torch.Tensor) -> dict:
        """images (B, D, H, W, C) on the device -> detection dict of tensors."""
        return self.program(images)

    def predict(self, images) -> dict:
        """images: (B, D, H, W, C) array -> detection dict of numpy arrays (size B)."""
        images = np.asarray(images)
        if images.shape[0] == 0:
            return empty_detections(self.config.top_k)
        return route(images, self.batch_sizes, self.device, self.config.compute_dtype,
                     self.detect)


def empty_detections(top_k: int) -> dict:
    """The answer to a request of no rows."""
    return {
        "boxes": np.zeros((0, top_k, 6), np.float32),
        "labels": np.zeros((0, top_k), np.int32),
        "scores": np.zeros((0, top_k), np.float32),
        "count": np.zeros((0,), np.int32),
    }


def route(images: np.ndarray, batch_sizes, device, dtype, call) -> dict:
    """Chunk-and-pad routing of the JAX package's ``ServingDetector``.

    Each chunk takes the largest batch size that fits the rows left; a last
    partial chunk is padded with zero volumes whose rows are dropped.
    ``call`` maps a (b, ...) tensor on ``device`` in ``dtype`` to a
    detection dict of tensors; the result is numpy, concatenated. A chunk
    bound for a card is staged (:class:`_Staging`, its padded rows zeroed
    there); on the CPU it goes in one ``.to(device, dtype)``.
    ``route.program_calls`` counts the calls of ``call``,
    ``route.padded_rows`` the zero volumes padded in, ``route.staged_uploads``
    the calls whose input was staged and ``route.staged_bytes`` the host
    bytes staged, over the process and its threads.
    """
    with span("msl.route"):
        n = images.shape[0]
        staged = torch.device(device).type == "cuda"
        outs = []
        start = 0
        while start < n:
            fits = [b for b in batch_sizes if b <= n - start]
            b = max(fits) if fits else min(batch_sizes)
            chunk = images[start: start + b]
            pad = b - chunk.shape[0]
            if pad and not staged:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            with span("msl.route.upload"):
                if staged:
                    x = _staging(device).upload(chunk, b, dtype)
                else:
                    x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device, dtype)
            with span("msl.detect"):
                det = call(x)
            with _ROUTE_COUNTS:
                route.program_calls += 1
                route.padded_rows += pad
                if staged:
                    route.staged_uploads += 1
                    route.staged_bytes += chunk.nbytes
            with span("msl.route.fetch"):
                outs.append({k: v[: b - pad].cpu().numpy() for k, v in det.items()})
            start += b - pad
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


route.program_calls = 0
route.padded_rows = 0
route.staged_uploads = 0
route.staged_bytes = 0
_ROUTE_COUNTS = threading.Lock()  # route may run in several threads at once


class _Staging:
    """One thread's uploads to one card: a pinned host buffer in the served
    dtype, grown to the largest chunk, and the event of its last copy.

    The host waits for that copy to end, casts the caller's rows into the
    buffer (a ``copy_`` on torch's host threads, the cast ``.to(device,
    dtype)`` makes, so the input is the same bit for bit) and queues one
    copy of it into the input on the current stream, which the card runs
    while the host launches the program. Padded rows are zeroed on the card.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.host = torch.empty(0)
        self.done = torch.cuda.Event()

    def upload(self, rows: np.ndarray, b: int, dtype) -> torch.Tensor:
        """``rows`` (n <= b, ...) -> (b, ...) ``dtype`` on the card, rows n to
        b zero, ordered before the current stream's next work."""
        part = torch.from_numpy(np.ascontiguousarray(rows))
        self.done.synchronize()  # the buffer is not refilled while it is copied
        if self.host.dtype != dtype or self.host.numel() < part.numel():
            self.host = torch.empty(part.numel(), dtype=dtype, pin_memory=True)
        host = self.host[: part.numel()].view(part.shape)
        host.copy_(part)
        x = torch.empty((b, *part.shape[1:]), dtype=dtype, device=self.device)
        x[: len(part)].copy_(host, non_blocking=True)
        self.done.record(torch.cuda.current_stream(self.device))
        if len(part) < b:
            x[len(part):].zero_()
        return x


_STAGING = threading.local()  # each thread's _Staging by card: no two threads share a buffer


def _staging(device) -> _Staging:
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    by_card = _STAGING.__dict__.setdefault("by_card", {})
    if index not in by_card:
        by_card[index] = _Staging(torch.device("cuda", index))
    return by_card[index]


def require_device(device, caller: str) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{caller}: device {device}; 'cuda' or 'cpu'")
    return device


def _input_dtype(config: SSD3DConfig, dtype) -> torch.dtype:
    name = str(dtype or config.dtype).removeprefix("torch.")
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _eval_model(config: SSD3DConfig, state_dict: dict, device) -> SSD3D:
    """The eval-mode model in the layout the live paths give it (channels_last_3d)."""
    model = SSD3D(config)
    model.load_state_dict(state_dict)
    return model.eval().to(device, memory_format=torch.channels_last_3d)


def _export(module: nn.Module, example: torch.Tensor) -> tuple[bytes, set]:
    """One ``torch.export`` program, serialized, and the ``msl::`` ops it calls."""
    with torch.no_grad():
        ep = torch.export.export(module, (example,))
    ops = {n.target.name() for n in ep.graph.nodes
           if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
           and n.target.namespace == "msl"}
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), ops


def _platform_models(config: SSD3DConfig, state_dict: dict, platforms, caller: str,
                     quantize, calib_images) -> list:
    """[(platform, the model to export there)] for ``platforms``, each
    checked; an int8 model is quantized once, on the first platform's
    device, and copied to the others."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if quantize == "int8" and calib_images is None:
        raise ValueError("quantize='int8' requires calib_images")
    names = list(dict.fromkeys(platforms))
    if not names:
        raise ValueError(f"{caller}: no platforms to export for")
    for name in names:
        require_device(name, caller)
    if quantize is None:
        return [(name, _eval_model(config, state_dict, name)) for name in names]
    qmodel = quant.quantize_ssd3d(config, state_dict, calib_images, device=names[0])
    return [(name, quant.QuantizedSSD3D(qmodel).to(name)) for name in names]


def _manifest(config, in_dtype, shape, exports, custom_ops, *, nms_impl, min_score, top_k,
              quantize, outputs, **extra) -> dict:
    return {
        "manifest_version": MANIFEST_VERSION,
        **extra,
        "config": config.to_json_dict(),
        "input": {"shape": [None, *shape, config.input_channels],
                  "dtype": str(in_dtype).removeprefix("torch.")},
        "batch_sizes": sorted({b for b, _ in exports}),
        "platforms": list(dict.fromkeys(p for _, p in exports)),
        "nms_impl": nms_impl,
        "min_score": float(min_score),
        "top_k": int(top_k),
        "torch_version": torch.__version__,
        "quantize": quantize,
        "outputs": outputs,
        "format": FORMAT,
        "custom_ops": sorted(custom_ops),
    }


def export_detector(config: SSD3DConfig, state_dict: dict, batch_sizes=(1,), *,
                    platforms=("cuda",), nms_impl: str = "xla", min_score=None, top_k=None,
                    dtype=None, quantize=None, calib_images=None):
    """Export the end-to-end detector for each batch size and platform.

    ``state_dict``: the trained inference weights (the reference schema),
    baked into each program. Each program is a ``torch.export`` of
    :class:`DetectionProgram` at a static batch, as the JAX package exports
    one function per batch size. A program is bound to the device it was
    exported on, so ``platforms`` ("cpu", "cuda"; default the card) gives one
    program per platform and batch size; "cuda" without a card raises.
    ``nms_impl`` is recorded in the manifest as given and changes nothing:
    every program runs the exact NMS (K1 on the card, its plain version on
    the CPU), as ``detect_objects`` does. ``quantize="int8"`` exports the
    post-training-quantized model (``quant.py``: BN folded, per-channel
    int8 weights, int8 convs accumulating in int32 through Q1), calibrated
    on ``calib_images`` (N, D, H, W, C) on the first platform's device.
    Returns ({(batch size, platform): serialized program}, manifest dict).
    """
    models = _platform_models(config, state_dict, platforms, "export_detector", quantize,
                              calib_images)
    min_score = config.min_score if min_score is None else min_score
    top_k = config.top_k if top_k is None else top_k
    in_dtype = _input_dtype(config, dtype)
    exports, ops = {}, set()
    for name, model in models:
        program = DetectionProgram.for_config(model, config, min_score=min_score,
                                              top_k=top_k).to(name)
        for b in sorted({int(x) for x in batch_sizes}):
            example = torch.zeros((b, *config.input_size, config.input_channels),
                                  dtype=in_dtype, device=name)
            exports[(b, name)], used = _export(program, example)
            ops |= used
    manifest = _manifest(
        config, in_dtype, config.input_size, exports, ops, nms_impl=nms_impl,
        min_score=min_score, top_k=top_k, quantize=quantize,
        outputs=["boxes (B,top_k,6) corner-frac", "labels (B,top_k)", "scores (B,top_k)",
                 "count (B,)"],
    )
    return exports, manifest


class SlidingWindowProgram(nn.Module):
    """volumes (V, D, H, W, C) -> stitched detections: the sliding-window
    detector of ``sliding_window.py`` around ``model``, the patch forward."""

    def __init__(self, model: nn.Module, run, device):
        super().__init__()
        self.model = model
        self._run = run
        self._placement = types.SimpleNamespace(device=torch.device(device))

    def forward(self, volumes: torch.Tensor) -> dict:
        return self._run(self._placement, volumes)


def export_sliding_window_detector(config: SSD3DConfig, state_dict: dict, volume_shape,
                                   volume_batches=(1,), *, overlap: float = 0.25,
                                   per_patch_k=None, platforms=("cuda",),
                                   nms_impl: str = "xla", min_score=None, top_k=None,
                                   dtype=None, quantize=None, calib_images=None):
    """Export the full-volume sliding-window detector, one program per
    ``volume_batches`` entry and platform.

    Each program holds the weights and the whole patch-tile and stitch
    program (``sliding_window.make_sliding_window_detector``), so the bundle
    serves volumes larger than the model's input. K1 runs at every chunk's
    NMS and at the stitch, whatever ``nms_impl`` says (it is recorded as
    given). ``quantize="int8"`` quantizes once, calibrated on
    ``calib_images`` of the model's (patch) input size, and passes the int8
    model as the patch forward. The rest as :func:`export_detector`.
    Returns ({(volume batch, platform): serialized program}, manifest dict).
    """
    from .sliding_window import make_sliding_window_detector

    models = _platform_models(config, state_dict, platforms, "export_sliding_window_detector",
                              quantize, calib_images)
    min_score = config.min_score if min_score is None else min_score
    top_k = config.top_k if top_k is None else top_k
    in_dtype = _input_dtype(config, dtype)
    volume_shape = tuple(int(v) for v in volume_shape)
    exports, ops = {}, set()
    for name, model in models:
        for v in sorted({int(x) for x in volume_batches}):
            run = make_sliding_window_detector(
                config, volume_shape, overlap=overlap, min_score=min_score, top_k=top_k,
                per_patch_k=per_patch_k, volume_batch=v,
                patch_forward=lambda _state, patches, _m=model: _m(patches),
            )
            example = torch.zeros((v, *volume_shape, config.input_channels), dtype=in_dtype,
                                  device=name)
            exports[(v, name)], used = _export(SlidingWindowProgram(model, run, name), example)
            ops |= used
    manifest = _manifest(
        config, in_dtype, volume_shape, exports, ops, nms_impl=nms_impl,
        min_score=min_score, top_k=top_k, quantize=quantize,
        outputs=["boxes (V,top_k,6) corner-frac of the FULL volume", "labels (V,top_k)",
                 "scores (V,top_k)", "count (V,)"],
        kind="sliding_window", volume_shape=list(volume_shape), overlap=float(overlap),
        per_patch_k=per_patch_k,
    )
    return exports, manifest


def save_bundle(path, exports: dict, manifest: dict) -> Path:
    """Write the programs and the manifest into one ``.mslx`` zip."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=2))
        for (b, platform), data in exports.items():
            zf.writestr(f"fn_b{b}_{platform}.pt2", data)
    return path


class ServingDetector:
    """Load an ``.mslx`` bundle and serve requests of any size on ``device``.

    What the bundle needs at load time: torch and this package's registered
    ops (K1-K3 and Q1, registered when this module is imported), but no
    model code and no checkpoint. (The JAX
    package's bundle needs only jaxlib; it holds StableHLO, which torch
    cannot load, and this class refuses it, naming the format.) ``device``
    defaults to the card and raises without one; the CPU must be asked for
    with ``device="cpu"``. The bundle must hold a program for the device's
    platform. Requests are chunked onto the largest exported batch size; a
    last partial chunk is padded and its padded rows dropped.
    """

    def __init__(self, path, *, device="cuda"):
        path = Path(path)
        with zipfile.ZipFile(path) as zf:
            self.manifest = json.loads(zf.read("manifest.json"))
            jax_files = [n for n in zf.namelist() if n.endswith(".bin")]
            if ("jax_version" in self.manifest or jax_files
                    or self.manifest.get("format") != FORMAT):
                raise ValueError(
                    f"{path} is not a torch.export bundle (manifest format "
                    f"{self.manifest.get('format')!r}): it looks like a JAX bundle (jax.export "
                    "StableHLO, fn_b*.bin, manifest 'jax_version'), which the PyTorch port "
                    "cannot load; export the checkpoint with mslesions3d_tpu_torch.cli.export"
                )
            platform = torch.device(device).type
            if platform not in self.manifest["platforms"]:
                raise ValueError(f"{path} has no program for {platform!r}; it holds "
                                 f"{self.manifest['platforms']}: export with --platforms "
                                 f"{platform}")
            self.device = require_device(device, "ServingDetector")
            self._fns = {
                b: torch.export.load(io.BytesIO(zf.read(f"fn_b{b}_{platform}.pt2"))).module()
                for b in self.manifest["batch_sizes"]
            }
        self.batch_sizes = sorted(self._fns)
        self.input_dtype = _input_dtype(self.config, self.manifest["input"]["dtype"])

    @property
    def config(self) -> SSD3DConfig:
        return SSD3DConfig.from_json_dict(self.manifest["config"])

    @torch.inference_mode()
    def detect(self, images: torch.Tensor) -> dict:
        """images (b, ...) on the device, b an exported batch size -> detection dict of tensors."""
        return self._fns[images.shape[0]](images)

    def predict(self, images) -> dict:
        """images: (B, D, H, W, C) array -> detection dict of numpy arrays (size B)."""
        images = np.asarray(images)
        if images.shape[0] == 0:
            return empty_detections(int(self.manifest["top_k"]))
        return route(images, self.batch_sizes, self.device, self.input_dtype, self.detect)


class RequestBatcher:
    """Coalesce concurrent predict requests into shared predict calls.

    One dispatcher thread drains a bounded queue: while one predict call is
    in flight, arriving requests accumulate, and the next call takes them
    all (up to ``max_rows``) in one concatenated batch. A predict call runs
    one program call or more: ``route`` splits its rows onto the exported
    batch sizes. ``submit(rows)``
    blocks until its rows' results are ready and returns its slice of the
    detection dict. The bounded queue gives backpressure.

    Counters, written by the dispatcher alone: ``device_calls`` (predict
    calls issued), ``requests`` and ``rows`` (those the calls carried) and
    ``queue_wait_s`` (the seconds each request spent from its ``submit`` to
    the dispatch of its call, summed).
    """

    def __init__(self, predict_fn, max_rows: int = 64, max_queue: int = 256):
        self._predict = predict_fn
        self._max_rows = max_rows
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self.device_calls = 0  # predict calls issued (each one program call or more)
        self.requests = 0
        self.rows = 0
        self.queue_wait_s = 0.0
        self._thread = threading.Thread(target=self._run, name="msl-request-batcher",
                                        daemon=True)
        self._thread.start()

    def submit(self, rows: np.ndarray) -> dict:
        done = threading.Event()
        slot: dict = {}
        self._q.put((rows, done, slot, time.perf_counter()))
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
            now = time.perf_counter()
            self.requests += len(batch)
            self.rows += stacked.shape[0]
            self.queue_wait_s += sum(now - queued for *_, queued in batch)
            try:
                self.device_calls += 1
                res = self._predict(stacked)
            except Exception as e:  # deliver to every coalesced caller
                for _, done, slot, _ in batch:
                    slot["error"] = e
                    done.set()
                continue
            off = 0
            for arr, done, slot, _ in batch:
                n = arr.shape[0]
                slot["result"] = {k: v[off:off + n] for k, v in res.items()}
                off += n
                done.set()
