"""Import a reference PyTorch LSSD3D checkpoint as a port checkpoint.

Usage:
  python -m mslesions3d_tpu_torch.cli.import_torch -m ref.ckpt -o ./converted \\
      --input_size 64 64 64 [-pl "3 5 7"] [...] [--device cpu]

Counterpart of ``mslesions3d_tpu/cli/import_torch.py`` with the same flags,
except that ``--platform`` is ``--device`` (the card by default; it raises
without one). It loads the torch state_dict (Lightning .ckpt or bare) with
``train.torch_import``, puts it into a freshly initialized state of
``SSD3D(config)`` (the init keeps what the checkpoint does not supply), and
writes a checkpoint directory (``state.pt`` + ``meta.json``) that
``cli.predict`` and ``cli.eval`` read.
"""

from __future__ import annotations

import argparse

from ..models.ssd3d import SSD3D, SSD3DConfig
from ..train.checkpoints import save_checkpoint
from ..train.state import create_train_state, resolve_device
from ..train.torch_import import import_torch_checkpoint


def build_parser():
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-m", "--model_path", type=str, required=True,
                   help="torch .ckpt / .pt path")
    p.add_argument("-o", "--output_dir", type=str, required=True,
                   help="checkpoint directory to write")
    p.add_argument("--n_classes", type=int, default=2,
                   help="including background (reference n_classes+1)")
    p.add_argument("--input_channels", type=int, default=1)
    p.add_argument("--input_size", type=int, nargs=3, default=[64, 64, 64])
    p.add_argument("-pl", "--prediction_layers", type=str, default="3 5 7")
    p.add_argument("-bpl", "--boxes_per_location", type=int, default=2)
    p.add_argument("-wm", "--width_mult", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the state is built: cuda (the card; raises without one) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, "cli.import_torch")

    layers = [int(x) for x in args.prediction_layers.split()]
    config = SSD3DConfig.create(
        n_classes=args.n_classes,
        input_channels=args.input_channels,
        input_size=tuple(args.input_size),
        aspect_ratios={l: [1.0] for l in layers},
        boxes_per_location=args.boxes_per_location,
        width_mult=args.width_mult,
    )

    imported = import_torch_checkpoint(args.model_path, config)
    state_dict = {**SSD3D(config).state_dict(), **imported}
    state = create_train_state(config, seed=0, device=device, state_dict=state_dict)

    path = save_checkpoint(args.output_dir, state, config,
                           metrics={"avg_val_loss": float("nan")},
                           extra={"imported_from": args.model_path})
    n_params = sum(p.numel() for p in state.params.values())
    print(f"[import_torch] wrote {path} ({n_params:,} parameters)")
    return path


if __name__ == "__main__":
    main()
