#!/usr/bin/env python3
"""Trained check of the PyTorch port on one NVIDIA GPU: the JAX package's
4k headline recipe through the port's own CLIs.

Run from the root of a checkout:

    python3 trained_check.py              # seeds 970205, 1 and 2, one process each, at once
    python3 trained_check.py --seeds 970205 --out results/
    python3 trained_check.py --seeds 970205 1 2 970205   # a seed twice: its repeat

It generates the recipe's dataset (``mslesions3d_tpu_torch/cli/recipe.py``:
200 volumes of 64^3, objects of 6-14 voxels, 1-5 of them, seed 0) into a
temporary directory; per seed it runs ``cli.train`` with the recipe's flags
at 4000 steps, then ``cli.predict -ps validation -sc 0.0 -k 100 -si 0`` and
``cli.eval`` over the recipe's grid on two checkpoints: the campaign's
``last_ckpt`` (the newest of the top-3 by name) and ``last``. Each run is
reduced by ``cli.plots.operating_points`` (mAP and best F1 over the score
grid, per IoU). ``cli.train`` runs the float32 recipe in IEEE float32 (TF32
off, ``train.state.use_ieee_float32``), and so does all that follows it in
the process. Every worker runs with cuDNN's deterministic algorithms
(``torch.backends.cudnn.deterministic``), so a seed repeats bit for bit
and the spread over seeds is the seeds' own, not run-to-run noise; each
result records the setting. A seed given twice runs twice, its k-th
repeat written to ``seed<S>_r<k>.json``. On the served path at min_score 0.5 it also counts,
over the validation volumes, the candidates above the score (the valid
share of the K a row), K1's kept ones (held against the plain NMS), and
the kept candidates that a one-pass NMS would have dropped (suppression
chains). Results go to <out>/seed<S>.json (``--out``, by default
build/trained_check) and a summary is printed. It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from mslesions3d_tpu_torch.cli import plots, recipe

SEEDS = (970205, 1, 2)
DEVICE = "cuda"


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def served_path_stats(ckpt: Path, data: Path) -> dict:
    """The trained model's valid share (candidates above 0.5 of the K a row)
    and suppression chains on the served path, over the validation volumes:
    K1's keep mask against the plain NMS, and the kept candidates that a
    one-pass NMS (suppress by every higher valid candidate) would drop."""
    from mslesions3d_tpu_torch.cli.predict import load_predict_state
    from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
    from mslesions3d_tpu_torch.kernels.nms import greedy_nms, greedy_nms_cuda
    from mslesions3d_tpu_torch.models.ssd3d import SSD3D, model_priors
    from mslesions3d_tpu_torch.ops.boxes import pairwise_iou
    from mslesions3d_tpu_torch.ops.nms import nms_candidates
    from mslesions3d_tpu_torch.train.steps import _cast
    from torch.func import functional_call

    config, state = load_predict_state(ckpt, DEVICE)
    model = SSD3D(config).eval()
    priors = torch.from_numpy(model_priors(config)).to(DEVICE)
    dm = SyntheticDataModule(data, n_classes=1, batch_size=8)
    dm.setup("predict")
    valid_n, kept_n, chain_n, rows, k, mism = 0, 0, 0, 0, 0, 0
    per_row_valid = []
    with torch.no_grad():
        for batch in dm.predict_batches("validation"):
            x = torch.from_numpy(batch["image"]).to(DEVICE)
            locs, scores = functional_call(model, (_cast(model, state.params), state.batch_stats),
                                           (x,))
            boxes, _, valid = nms_candidates(locs, scores, priors, n_classes=config.n_classes,
                                             min_score=0.5, top_k=100)
            real = torch.from_numpy(batch["batch_mask"]).to(DEVICE)
            boxes, valid = boxes[real].contiguous(), valid[real]
            keep = greedy_nms_cuda(boxes, valid, config.max_overlap)
            plain = greedy_nms(boxes, valid, config.max_overlap)
            mism += int((keep != plain).sum())
            k = boxes.shape[1]
            for r in range(boxes.shape[0]):
                v = valid[r]
                iou = pairwise_iou(boxes[r], boxes[r])
                higher = torch.triu(torch.ones_like(iou, dtype=torch.bool), 1).T  # j < i
                over = (iou > config.max_overlap) & higher & v[None, :] & v[:, None]
                one_pass = v & ~over.any(1)
                chain_n += int((keep[r] & ~one_pass).sum())
                valid_n += int(v.sum())
                kept_n += int(keep[r].sum())
                per_row_valid.append(int(v.sum()))
                rows += 1
    return {"rows": rows, "K": k, "valid": valid_n, "valid_share": valid_n / max(rows * k, 1),
            "valid_per_row": per_row_valid, "kept": kept_n, "suppressed": valid_n - kept_n,
            "kept_by_chain": chain_n, "k1_vs_plain_mismatches": mism}


def worker(seed: int, data: Path, out: Path) -> dict:
    from mslesions3d_tpu_torch.cli import predict as predict_cli
    from mslesions3d_tpu_torch.cli import train as train_cli

    # without it a seed does not repeat on the card: cuDNN's default
    # algorithms sum in an order that varies from run to run
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    logs = out / "logs"
    t0 = time.perf_counter()
    result = train_cli.main(["-d", str(data), *recipe.TRAIN_FLAGS, "-mi", str(recipe.STEPS),
                             "-rs", str(seed), "-ld", str(logs), "-en", f"K4k_s{seed}",
                             "--device", DEVICE])
    train_s = time.perf_counter() - t0
    ckdir = Path(result["checkpoint_dir"])
    scored = {}
    # the campaign's last_ckpt (the newest of the top-3 by name) and `last`
    picks = {"campaign_last_ckpt": sorted(ckdir.glob("checkpoint-*"))[-1], "last": ckdir / "last"}
    for tag, ck in picks.items():
        preds = out / f"preds_{tag}"
        t1 = time.perf_counter()
        predict_cli.main(["-d", str(data), "-m", str(ck), "-o", str(preds),
                          *recipe.PREDICT_FLAGS, "-si", "0", "--device", DEVICE])
        predict_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        recipe.evaluate_grid(data, preds)
        eval_s = time.perf_counter() - t1
        run_dir = preds / "validation_set" / "min_score_0.0"
        scored[tag] = {"checkpoint": ck.name, **plots.operating_points(run_dir),
                       "predict_s": predict_s, "eval_s": eval_s,
                       "served_path_at_0.5": served_path_stats(ck, data)}
    hist = result["history"]
    return {"seed": seed, "train_s": train_s, "steps": int(sum(e["steps"] for e in
                                                            result["timings"]["epochs"])),
            "epochs": len(hist), "final_avg_val_loss": hist[-1]["avg_val_loss"],
            "scored": scored, "card": card(), "wall_s": time.perf_counter() - t0,
            # what cli.train left set: the float32 recipe ran without TF32
            "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                     "matmul": torch.backends.cuda.matmul.allow_tf32},
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "train_losses": [v for e in result["timings"]["epochs"] for v in e["train_losses"]]}


def run_names(seeds) -> list:
    """(seed, result name) of each run: ``seed<S>``, then ``seed<S>_r<k>``
    for the k-th repeat of a seed given again."""
    seen: dict = {}
    names = []
    for s in seeds:
        k = seen.get(s, 0)
        seen[s] = k + 1
        names.append((s, f"seed{s}" if k == 0 else f"seed{s}_r{k}"))
    return names


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    p.add_argument("--out", type=Path, default=Path("build/trained_check"))
    p.add_argument("--worker", nargs=4, metavar=("SEED", "NAME", "DATA", "OUT"), default=None,
                   help="run one seed on a generated dataset (what the parent starts)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("trained_check: no CUDA device is available; it runs on a card", file=sys.stderr)
        return 1
    if args.worker:
        seed, name = int(args.worker[0]), args.worker[1]
        data, out = Path(args.worker[2]), Path(args.worker[3])
        res = dict(worker(seed, data, out), run=name)
        (args.out / f"{name}.json").write_text(json.dumps(res, indent=1))
        print(json.dumps(res))
        return 0
    args.out.mkdir(parents=True, exist_ok=True)
    print("#", card(), torch.__version__, torch.version.cuda, flush=True)
    from mslesions3d_tpu_torch.data.generate import generate_dataset

    with tempfile.TemporaryDirectory(prefix="trained_check_") as tmp:
        data = Path(tmp) / "data"
        t0 = time.perf_counter()
        generate_dataset(data, num_processes=6, **recipe.DATA)
        print(f"# generated the dataset in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        procs, logs = {}, []
        try:
            for s, name in run_names(args.seeds):
                logs.append(open(args.out / f"{name}.log", "w"))
                procs[name] = subprocess.Popen(
                    [sys.executable, __file__, "--worker", str(s), name, str(data),
                     str(Path(tmp) / name), "--out", str(args.out)],
                    stdout=logs[-1], stderr=subprocess.STDOUT)
            rcs = {name: p.wait() for name, p in procs.items()}
        finally:
            for f in logs:
                f.close()
        print(f"# all seeds in {time.perf_counter() - t0:.1f} s (concurrent, one card); rcs {rcs}",
              flush=True)
    results = {}
    for s, name in run_names(args.seeds):
        p = args.out / f"{name}.json"
        if p.exists():
            r = results[name] = json.loads(p.read_text())
            for tag, sc in r["scored"].items():
                print(name, tag, {k: v for k, v in sc.items() if k != "served_path_at_0.5"},
                      {k: v for k, v in sc["served_path_at_0.5"].items() if k != "valid_per_row"})
            print(name, "train_s", r["train_s"], "steps", r["steps"], "wall_s", r["wall_s"],
                  "tf32", r["tf32"], "cudnn_deterministic", r["cudnn_deterministic"])
        else:
            print(name, "no result; tail of the log:")
            print((args.out / f"{name}.log").read_text()[-3000:])
    for s, name in run_names(args.seeds):  # a repeat against the seed's first run
        first = f"seed{s}"
        if name != first and name in results and first in results:
            a, b = results[first], results[name]
            same = a["train_losses"] == b["train_losses"] and all(
                a["scored"][t]["mAP@0.5"] == b["scored"][t]["mAP@0.5"] for t in a["scored"])
            print(name, "repeats", first, "bit for bit" if same else "NOT bit for bit",
                  "(training losses and mAP@0.5)")
    return 0 if all(v == 0 for v in rcs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
