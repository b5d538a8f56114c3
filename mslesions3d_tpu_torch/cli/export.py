"""Export a trained checkpoint as a serving bundle (.mslx).

Counterpart of ``mslesions3d_tpu/cli/export.py``: the end-to-end detection
function is captured with ``torch.export``, the trained weights baked in
(``serving.py``). The flags are the JAX CLI's, with ``--device`` for its
``--platform``: the card (``cuda``, the default; it raises without one) or
``cpu``. ``--platforms`` defaults to ``--device``'s.

    python -m mslesions3d_tpu_torch.cli.export -m logs/run/checkpoints/best -o model.mslx -b 1 8 32
    ... -o model.mslx --platforms cpu cuda          # programs for both
    ... -o full.mslx --sliding_window 192 224 192 -b 1 4
        # FULL-VOLUME bundle: the whole patch-tile/stitch program baked in
    ... -o q.mslx --quantize int8 --calib_npy calib.npy
        # int8 PTQ bundle (quant.py); composes with --sliding_window;
        # calib.npy is a (N, D, H, W, C) stack of PATCH-sized inputs

``--nms_impl`` is recorded in the manifest and changes nothing: every
program runs the exact NMS (K1 on the card).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model_path", required=True,
                   help="checkpoint directory (as written by training)")
    p.add_argument("-o", "--output", required=True, help="output .mslx path")
    p.add_argument("-b", "--batch_sizes", nargs="+", type=int, default=[1],
                   help="batch sizes to export (one program each)")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="devices to export for, cpu and/or cuda (default: --device)")
    p.add_argument("--nms_impl", default="xla", choices=["xla", "pallas"],
                   help="recorded in the manifest; every program runs the exact NMS")
    p.add_argument("-sw", "--sliding_window", nargs=3, type=int, default=None,
                   metavar=("D", "H", "W"),
                   help="export the FULL-VOLUME sliding-window detector for volumes of this "
                        "shape (batch sizes then count VOLUMES per request)")
    p.add_argument("--overlap", type=float, default=0.25,
                   help="sliding-window patch overlap fraction")
    p.add_argument("--per_patch_k", type=int, default=None,
                   help="sliding-window: detections kept per patch pre-stitch")
    p.add_argument("-sc", "--min_score", type=float, default=None)
    p.add_argument("-k", "--top_k", type=int, default=None)
    p.add_argument("--dtype", default=None, help="input dtype override (e.g. float32)")
    p.add_argument("--use_ema", type=int, default=1,
                   help="1 = serve the EMA average when the checkpoint has one (training "
                        "with --ema_decay > 0); 0 = raw params (mirrors cli.predict)")
    p.add_argument("--device", default="cuda",
                   help="device to export on: cuda (default; raises without a card) or cpu")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="post-training quantization: int8 = BN-fold + per-channel int8 "
                        "weights + int32-accumulated convs (quant.py); needs --calib_npy")
    p.add_argument("--calib_npy", default=None,
                   help="calibration volumes for --quantize: a .npy stack (N, D, H, W, C) of "
                        "representative PREPROCESSED inputs")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..serving import (export_detector, export_sliding_window_detector, require_device,
                           save_bundle)
    from .predict import load_predict_state

    device = require_device(args.device, "cli.export")
    platforms = args.platforms or [device.type]
    # the EMA average when the checkpoint has one, unless --use_ema 0 (cli.predict's rule)
    config, state = load_predict_state(args.model_path, "cpu", bool(args.use_ema))
    state_dict = state.state_dict()

    calib = None
    if args.quantize:
        if not args.calib_npy:
            raise SystemExit("--quantize needs --calib_npy (see --help)")
        calib = np.load(args.calib_npy)
        # calibration volumes are PATCH-sized (config.input_size) in both
        # modes: the sliding-window program runs the same patch detector
        d, h, w = config.input_size
        if calib.ndim != 5 or calib.shape[1:] != (d, h, w, config.input_channels):
            raise SystemExit(
                f"--calib_npy must be (N, {d}, {h}, {w}, "
                f"{config.input_channels}); got {calib.shape}")

    common = dict(platforms=platforms, nms_impl=args.nms_impl, min_score=args.min_score,
                  top_k=args.top_k, dtype=args.dtype, quantize=args.quantize,
                  calib_images=calib)
    if args.sliding_window:
        exports, manifest = export_sliding_window_detector(
            config, state_dict, args.sliding_window, args.batch_sizes, overlap=args.overlap,
            per_patch_k=args.per_patch_k, **common)
    else:
        exports, manifest = export_detector(config, state_dict, args.batch_sizes, **common)
    out = save_bundle(args.output, exports, manifest)
    size = Path(out).stat().st_size
    print(f"[export] wrote {out} ({size / 1e6:.2f} MB): "
          f"batch sizes {manifest['batch_sizes']}, platforms {manifest['platforms']}, "
          f"nms={manifest['nms_impl']}")
    print(json.dumps({k: v for k, v in manifest.items() if k != "config"}, indent=2))
    return out


if __name__ == "__main__":
    main()
