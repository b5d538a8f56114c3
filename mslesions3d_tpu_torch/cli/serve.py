"""Serve detections from a .mslx bundle: no checkpoint, no model code.

Counterpart of ``mslesions3d_tpu/cli/serve.py``: it loads NIfTI volume(s),
normalizes them as training did, calls the bundle's program and writes the
detections as JSON (fractional and voxel boxes, labels, scores). The bundle
is one ``cli.export`` wrote; a JAX bundle does not load (``serving.py``).
``--device`` is the card (``cuda``, the default; it raises without one) or
``cpu``; the bundle must hold a program for it.

    python -m mslesions3d_tpu_torch.cli.serve -m model.mslx -i sub-01_image.nii.gz -o out/
    python -m mslesions3d_tpu_torch.cli.serve -m full.mslx -i vol1.nii.gz vol2.nii.gz -o out/
    python -m mslesions3d_tpu_torch.cli.serve -m model.mslx --listen 8080   # HTTP server

HTTP mode (stdlib only): POST /predict with an .npy body of shape (V, D,
H, W, C), (D, H, W, C) or (D, H, W) returns detections as JSON; GET
/healthz returns the bundle's manifest summary. Concurrent requests are
coalesced into shared predict calls (``serving.RequestBatcher``): while one
call is in flight, arriving volumes queue and ride the next call as one
concatenated batch, which runs on the bundle's batch sizes (the largest
that fits first; a bundle exported at 1 2 4 8 serves 7 rows in 3 program
calls, one at 1 8 in 7). GET /stats returns the counters since the server
started: the batcher's ``requests``, ``rows``, ``device_calls`` (predict
calls) and ``queue_wait_s`` (each request's seconds from its arrival in the
queue to the dispatch of its call, summed), and ``program_calls``,
``padded_rows``, ``staged_uploads`` and ``staged_bytes`` (``serving.route``'s
program calls, padded rows, the program calls whose float32 input was staged
through pinned memory to the card, and the host bytes so staged; these four
count every route of the process).
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model_path", required=True, help=".mslx bundle")
    p.add_argument("-i", "--inputs", nargs="*", default=None,
                   help="NIfTI volume path(s) (batch mode)")
    p.add_argument("-o", "--output_dir", default=None)
    p.add_argument("--listen", type=int, default=None, metavar="PORT",
                   help="serve over HTTP instead of batch mode (0 = any free port, printed "
                        "at startup)")
    p.add_argument("--normalize", type=int, default=1,
                   help="nonzero-mean/std normalize per volume (the training pipeline's "
                        "normalization; 0 = raw intensities)")
    p.add_argument("--device", default="cuda",
                   help="device to serve on: cuda (default; raises without a card) or cpu")
    return p


def _normalize(img: np.ndarray) -> np.ndarray:
    nz = img != 0
    if not nz.any():
        return img
    mean = img[nz].mean()
    std = img[nz].std() or 1.0
    out = img.copy()
    out[nz] = (img[nz] - mean) / std
    return out


def make_http_server(det, port: int):
    """ThreadingHTTPServer on 127.0.0.1 over a ServingDetector (stdlib only).

    POST /predict: .npy body -> JSON {volumes: [{count, boxes_frac, labels,
    scores}]}. GET /healthz: the manifest's summary. GET /stats: the
    batcher's and ``route``'s counters (module docstring). Concurrent POSTs are
    coalesced into shared predict calls by ``serving.RequestBatcher``
    (``server.batcher``); each handler gets its own rows back.
    """
    from ..serving import RequestBatcher, route

    batcher = RequestBatcher(det.predict)
    expected = tuple(det.manifest["input"]["shape"][1:4])

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                return self._send(200, {
                    "requests": batcher.requests, "rows": batcher.rows,
                    "device_calls": batcher.device_calls, "queue_wait_s": batcher.queue_wait_s,
                    "program_calls": route.program_calls, "padded_rows": route.padded_rows,
                    "staged_uploads": route.staged_uploads, "staged_bytes": route.staged_bytes,
                })
            if self.path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            m = det.manifest
            self._send(200, {
                "status": "ok", "kind": m.get("kind", "detector"),
                "input": m["input"], "batch_sizes": m["batch_sizes"],
                "top_k": m.get("top_k"), "platforms": m["platforms"],
            })

        def do_POST(self):
            if self.path != "/predict":
                return self._send(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                arr = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                if arr.ndim == 3:
                    arr = arr[None, ..., None]
                elif arr.ndim == 4:
                    arr = arr[None]
                if arr.ndim != 5 or arr.shape[1:4] != expected:
                    return self._send(400, {
                        "error": f"volume {arr.shape} does not match bundle input "
                                 f"(V, {expected}, C)"})
                res = batcher.submit(arr.astype(np.float32))
                out = []
                for i in range(arr.shape[0]):
                    k = int(res["count"][i])
                    out.append({
                        "count": k,
                        "boxes_frac": res["boxes"][i][:k].tolist(),
                        "labels": res["labels"][i][:k].tolist(),
                        "scores": res["scores"][i][:k].tolist(),
                    })
                self._send(200, {"volumes": out})
            except Exception as e:  # a malformed request must not stop the server
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.batcher = batcher  # for shutdown and observability
    return server


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data.nifti import load_nifti
    from ..serving import ServingDetector
    from ..train.state import use_ieee_float32

    det = ServingDetector(args.model_path, device=args.device)
    use_ieee_float32()
    if args.listen is not None:
        server = make_http_server(det, args.listen)
        print(f"[serve] listening on http://127.0.0.1:{server.server_port} "
              f"(POST /predict, GET /healthz, GET /stats)", flush=True)
        server.serve_forever()
        return server
    if not args.inputs or args.output_dir is None:
        raise SystemExit("batch mode needs -i volumes and -o output_dir "
                         "(or --listen PORT for HTTP mode)")
    expected = tuple(det.manifest["input"]["shape"][1:4])
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    volumes, names = [], []
    for path in args.inputs:
        img = load_nifti(path).data.astype(np.float32)
        if args.normalize:
            img = _normalize(img)
        if img.ndim == 3:
            img = img[..., None]
        if img.shape[:3] != expected:
            raise SystemExit(
                f"{path}: volume {img.shape[:3]} does not match the bundle's "
                f"input {expected} — export with the right shape "
                f"(-sw D H W for full volumes) or resample first"
            )
        volumes.append(img)
        names.append(Path(path).name.split(".")[0])

    res = det.predict(np.stack(volumes))
    vol = np.asarray(expected, np.float32)
    for i, name in enumerate(names):
        n = int(res["count"][i])
        frac = res["boxes"][i][:n]
        record = {
            "input": args.inputs[i],
            "bundle": str(args.model_path),
            "detections": [
                {
                    "box_frac": [float(x) for x in frac[j]],
                    "box_voxels": [float(x) for x in (frac[j] * np.concatenate([vol, vol]))],
                    "label": int(res["labels"][i][j]),
                    "score": float(res["scores"][i][j]),
                }
                for j in range(n)
            ],
        }
        out = out_dir / f"{name}_detections.json"
        out.write_text(json.dumps(record, indent=2))
        print(f"[serve] {name}: {n} detections -> {out}", flush=True)
    return out_dir


if __name__ == "__main__":
    main()
