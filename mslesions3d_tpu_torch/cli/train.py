"""Train CLI — flag surface mirrors the reference (lesions3d/train.py:27-64).

Usage:
  python -m mslesions3d_tpu_torch.cli.train -d <dataset_root> [-dn name] [...]

Counterpart of ``mslesions3d_tpu/cli/train.py`` with the same flags and
defaults, except that the JAX package's ``--platform`` is ``--device``
here: the card (``cuda``, the default; it raises without one) or ``cpu``.
Additions over the reference: --dtype bfloat16, --max_objects (GT
padding), --hard_negative_mining, --patch_size (train on patches cropped on
the device from full-resolution volumes, validated on whole volumes
through the sliding window; score with ``cli.predict -sw 1``),
--device_boxes (GT boxes by connected components on the device), and the
JAX package's --data_parallel and --spatial_shards. ``--data_parallel 1``
trains over a data mesh, one rank a card: under ``torchrun --nproc_per_node
N -m mslesions3d_tpu_torch.cli.train --data_parallel 1 ...`` each rank takes
``cuda:LOCAL_RANK`` and its rows of every global batch (``-b`` is the global
batch), rank 0 writes; without a launcher it is a world of one.
``--spatial_shards S`` (S > 1) splits each volume's depth over S ranks of a
data x spatial mesh (``torchrun --nproc_per_node N ... --spatial_shards S
[--data_parallel 1]``: the data axis is N / S with ``--data_parallel 1``,
else 1, and the world must hold the mesh); a world that does not raises. A float32
config trains in IEEE float32: TF32 is off for convolutions and matmuls
(``train.state.use_ieee_float32``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from ..data.augment import AugmentConfig
from ..data.datasets import LesionsDataModule, SyntheticDataModule
from ..models.ssd3d import SSD3DConfig
from ..parallel.multihost import initialize_multihost
from ..train.loop import Trainer, TrainerConfig
from ..train.state import resolve_device, use_ieee_float32


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-d", "--dataset_path", type=str, default="../data/artificial_dataset",
                   help="path to dataset used for training and validation")
    p.add_argument("-dn", "--dataset_name", type=str, default=None)
    p.add_argument("--channels", type=int, nargs="*", default=None,
                   help="channel subset of multi-contrast volumes (e.g. 0 for FLAIR-only)")
    p.add_argument("--device_boxes", type=int, default=0,
                   help="derive GT boxes with the on-device connected-"
                        "components labelling instead of host scipy "
                        "(synthetic dataset)")
    p.add_argument("-su", "--subject", type=str, default=None,
                   help="train on a single subject id (debugging)")
    p.add_argument("-p", "--percentage", type=float, default=1.0)
    p.add_argument("--n_classes", type=int, default=1)
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("-lr", "--learning_rate", type=float, default=0.001)
    p.add_argument("-sr", "--scheduler", type=str, default="CosineAnnealingLR",
                   choices=["CosineAnnealingLR", "cosine_annealed", "none"],
                   help="CosineAnnealingLR = reference parity (per-step, "
                        "period t_max=40, oscillates forever); cosine_annealed "
                        "= one half-cosine over t_max steps (defaults to "
                        "max_iterations) then eta_min")
    p.add_argument("--t_max", type=int, default=None,
                   help="cosine period/horizon in steps (default: 40 for "
                        "CosineAnnealingLR parity, max_iterations for "
                        "cosine_annealed)")
    p.add_argument("-th", "--threshold", type=float, default=[0.1, 0.2], nargs="+",
                   help="IoU threshold(s) for box matching (1=hard, 2=soft band)")
    p.add_argument("-pl", "--prediction_layers", type=str, default="3 5 7")
    p.add_argument("-cfg", "--base_network_config", type=str, default="mobilenet")
    p.add_argument("-sc", "--scales", type=json.loads, default="{}")
    p.add_argument("-bpl", "--boxes_per_location", type=int, default=2)
    p.add_argument("-minos", "--min_object_size", type=int, default=6)
    p.add_argument("-maxos", "--max_object_size", type=int, default=14)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("-a", "--augmentations", type=str, nargs="*",
                   default=["flip", "rotate90d", "translate"])
    p.add_argument("-ld", "--logdir", type=str, default="../logs/artificial_dataset")
    p.add_argument("-c", "--cache", type=int, default=0)
    p.add_argument("-nw", "--num_workers", type=int, default=8,
                   help="accepted for reference-CLI compatibility (host pipeline is in-process)")
    p.add_argument("-wm", "--width_mult", type=float, default=1.0)
    p.add_argument("-en", "--experiment_name", type=str, default="multiple_subjects_64")
    p.add_argument("-wb", "--use_wandb", type=int, default=0)
    p.add_argument("-me", "--max_epochs", type=int, default=None)
    p.add_argument("-mi", "--max_iterations", type=int, default=4000)
    p.add_argument("-cp", "--checkpoint", type=str, default=None,
                   help="checkpoint dir to resume from")
    p.add_argument("-v", "--verbose", type=int, default=0)
    p.add_argument("-rs", "--seed", type=int, default=970205)
    p.add_argument("-es", "--early_stopping", type=int, default=1)
    p.add_argument("-cm", "--compute_metric_every_n_epochs", type=int, default=1)
    p.add_argument("-coms", "--comments", type=str, default="")
    # dataset family: synthetic cubes (reference example()) or BIDS MS data
    # (reference train_lesions(), train.py:191-238)
    p.add_argument("-dt", "--dataset_type", type=str, default="synthetic",
                   choices=["synthetic", "lesions"])
    p.add_argument("--centers", type=str, nargs="*",
                   default=["CHUV_RIM_OK", "BASEL_INSIDER_OK"])
    p.add_argument("--input_images", type=str, nargs="*", default=["FLAIR"],
                   help="input sequences; several stack as channels")
    p.add_argument("--segmentation", type=str, default="labeled_lesions")
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--spatial_size", type=int, nargs=3, default=[250, 300, 300])
    p.add_argument("--patch_size", type=int, nargs=3, default=None,
                   help="train on random lesion-biased patches of this size, "
                        "cropped ON DEVICE from the full-resolution volumes "
                        "each step (the model/priors are built for the patch "
                        "size; validation uses a deterministic lesion-"
                        "centered crop). Pair with `predict -sw 1` for "
                        "full-volume inference")
    p.add_argument("--patch_pos_fraction", type=float, default=0.7,
                   help="fraction of patches centered on a ground-truth "
                        "lesion (the rest are uniform random crops)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="> 1 accumulates gradients over that many "
                        "micro-batches per optimizer step (activation "
                        "memory of one micro-batch; batch_size must divide). "
                        "BatchNorm statistics and hard-negative mining are "
                        "per-MICRO-batch: with --hard_negative_mining the "
                        "3:1 negative ratio is mined within each micro-batch "
                        "(tests/test_grad_accum.py pins this)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="1 = one rank a card over a data mesh (launch with torchrun "
                        "--nproc_per_node N; without it a world of one); -b is the global "
                        "batch")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="> 1 shards volume depth over that many ranks (a data x spatial "
                        "mesh; launch the world with torchrun)")
    p.add_argument("--device_data_cache", type=int, default=1,
                   help="keep the materialized dataset on the device and gather "
                        "batches there (0 = stream batches from the host)")
    p.add_argument("--grad_hist_every_n_steps", type=int, default=25,
                   help="TB gradient-histogram cadence (0 = off)")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--init_scheme", type=str, default="torch",
                   choices=["torch", "flax", "kaiming_relu"],
                   help="weight init: torch Conv3d defaults (reference parity, "
                        "measured better), flax lecun_normal, or the legacy "
                        "relu-gain kaiming override (rounds-1/2 default)")
    p.add_argument("--max_objects", type=int, default=16)
    p.add_argument("--hard_negative_mining", type=int, default=0)
    p.add_argument("--focal_gamma", type=float, default=0.0,
                   help="> 0 switches the confidence loss to softmax focal "
                        "(the reference's commented-out FocalLoss, ssd3d.py:760)")
    p.add_argument("--focal_alpha", type=float, default=0.25)
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="> 0 keeps an EMA of the weights (e.g. 0.999); "
                        "validation, checkpoint selection and predict score "
                        "the average")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to train: cuda (the card; raises without one) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device, "cli.train")
    use_ieee_float32()
    if args.data_parallel or args.spatial_shards > 1:
        # before the data module: under torchrun each rank takes its card first
        initialize_multihost(device=args.device)

    try:
        layers = [int(x) for x in args.prediction_layers.split()]
    except ValueError:
        raise SystemExit("prediction_layers must be space-separated integers, e.g. '3 5 7'")
    aspect_ratios = {l: [1.0] for l in layers}
    scales = {int(k): v for k, v in args.scales.items()}

    np.random.seed(args.seed)

    if args.dataset_type == "lesions":
        dataset = LesionsDataModule(
            data_dir=args.dataset_path,
            centers=tuple(args.centers),
            input_images=tuple(args.input_images),
            segmentation=args.segmentation,
            fold=args.fold,
            subject=args.subject,
            percentage=args.percentage,
            batch_size=args.batch_size,
            random_state=args.seed,
            cache=bool(args.cache),
            max_objects=args.max_objects,
            spatial_size=tuple(args.spatial_size),
        )
        input_channels = len(args.input_images)
    else:
        dataset = SyntheticDataModule(
            data_dir=args.dataset_path,
            dataset_name=args.dataset_name,
            n_classes=args.n_classes,
            channels=args.channels,
            device_boxes=bool(args.device_boxes),
            device=args.device,
            subject=args.subject,
            percentage=args.percentage,
            batch_size=args.batch_size,
            random_state=args.seed,
            cache=True,  # in-memory cache; args.cache kept for flag parity
            max_objects=args.max_objects,
        )
        input_channels = None  # inferred from the data (4-D = multi-contrast)
    dataset.setup("fit")
    sample_shape = dataset.get_sample(dataset.trainsubs[0])["img"].shape
    input_size = sample_shape[:3]
    if input_channels is None:
        input_channels = sample_shape[3] if len(sample_shape) == 4 else 1
    patch_training = args.patch_size is not None
    if patch_training:
        if any(p > s for p, s in zip(args.patch_size, input_size)):
            raise SystemExit(
                f"--patch_size {tuple(args.patch_size)} exceeds the volume "
                f"size {tuple(input_size)} on some axis"
            )
        print(f"[train] patch training: {tuple(args.patch_size)} patches "
              f"from {tuple(input_size)} volumes "
              f"(pos_fraction={args.patch_pos_fraction})")
        input_size = tuple(args.patch_size)
    print(f"[train] {len(dataset.trainsubs)} train / {len(dataset.testsubs)} val "
          f"subjects, input size {input_size}")

    config = SSD3DConfig.create(
        n_classes=args.n_classes + 1,
        input_channels=input_channels,
        input_size=tuple(input_size),
        lr=args.learning_rate,
        width_mult=args.width_mult,
        scheduler=args.scheduler,
        t_max=(args.t_max if args.t_max is not None
               else (args.max_iterations if args.scheduler == "cosine_annealed"
                     else 40)),
        batch_size=args.batch_size,
        comments=args.comments,
        compute_metric_every_n_epochs=args.compute_metric_every_n_epochs,
        aspect_ratios=aspect_ratios,
        scales=scales,
        alpha=args.alpha,
        threshold=args.threshold,
        min_object_size=args.min_object_size,
        max_object_size=args.max_object_size,
        base_network_config=args.base_network_config,
        boxes_per_location=args.boxes_per_location,
        focal_gamma=args.focal_gamma,
        focal_alpha=args.focal_alpha,
        dtype=args.dtype,
        init_scheme=args.init_scheme,
        ema_decay=args.ema_decay,
    )

    augment = AugmentConfig.from_names(args.augmentations)

    trainer = Trainer(TrainerConfig(
        logdir=args.logdir,
        experiment_name=args.experiment_name,
        max_epochs=args.max_epochs,
        max_steps=-1 if args.max_epochs else args.max_iterations,
        early_stopping=bool(args.early_stopping),
        compute_metric_every_n_epochs=args.compute_metric_every_n_epochs,
        seed=args.seed,
        use_wandb=bool(args.use_wandb),
        data_parallel=bool(args.data_parallel),
        spatial_shards=args.spatial_shards,
        patch_training=patch_training,
        patch_pos_fraction=args.patch_pos_fraction,
        grad_accum=args.grad_accum,
        device_data_cache=bool(args.device_data_cache),
        grad_hist_every_n_steps=args.grad_hist_every_n_steps,
        hard_negative_mining=bool(args.hard_negative_mining),
        verbose=True,
        device=args.device,
    ))
    state, result = trainer.fit(config, dataset, augment=augment, resume=args.checkpoint)
    result["config"] = dataclasses.asdict(config)
    print(f"[train] done; best avg_val_loss={result['best_val_loss']:.4f}; "
          f"best checkpoint: {result['best_checkpoint']}")
    return result


if __name__ == "__main__":
    main()
