"""Values of the two cells' configurations frozen bit for bit: the seeded
weights, the MobileNet reference forward, and the readings of the tiny CPU
runs of both cells (as ``test_perfbench_runs.py`` drives them). The backbone
families (``reference/mobilenet.py`` beside ``reference/convnet.py``) must
leave every one of them as it was before the lookup existed.

    python3 perfbench/tests/test_perfbench_frozen.py

prints the values as one JSON object; the test holds them against FROZEN,
which this file printed on the commit before the families, on an x86 CPU.
The weight digests are seeded draws and hold on any machine. The forward
digests and the runs' readings come from the CPU's conv kernels (oneDNN),
which may round otherwise on another instruction set or torch build: there,
or after a change to the benchmark that rightly moves a reading, print the
values on the old tree and on the new one on the same machine, compare
them, and paste the new tree's into FROZEN.

Serving readings that depend on how many calls the window made (the pooled
means over the picked calls) are left out: every other reading takes the
worst volume or the widest overlap, which repeated calls on the pool's one
batch leave as they are.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402
from perfbench.lib import data, harness, weights  # noqa: E402
from perfbench.reference import ssd3d as ref  # noqa: E402

SERVE = "serve96_batch32_fused"
TRAIN = "train64_b64_epoch"
SEEDS = (7, 2**31 + 5)
# the tiny runs of test_perfbench_runs.py, serving from a pool of one batch:
# a window that makes one call compares the same volumes as one that makes many
TINY_SERVE = {"params": {"batch": 4, "pool": 4, "batch_sizes": [1, 4], "warmup_calls": 1,
                         "ref_block": 4},
              "model": {"input_size": [32, 32, 32]}}
TINY_TRAIN = {"params": {"batch": 8}, "model": {"input_size": [32, 32, 32], "width_mult": 0.25}}
SERVE_READINGS = ("volume_mean", "volume_median", "overlap_excess", "plain_volume_mean",
                  "plain_volume_median", "plain_overlap_excess", "answer_ratio")

# printed by this file on the parent of the backbone families
FROZEN = {
    "weights": {
        "serve96_batch32_fused.init.2147483653":
            "af62f34b34ff270bb34ce973d57aa0c742be082ed64ba78db1c64769baf269cd",
        "serve96_batch32_fused.init.7":
            "1116b3899738d8044b2f0ea1c9c2698801e37bcca5f38713ddd5dc2e32c12195",
        "serve96_batch32_fused.served.2147483653":
            "350fa43407ee4a333c4e983ff70cf81de793a3a0b70dafc92f29cf1d821cfa7a",
        "serve96_batch32_fused.served.7":
            "463a47a5ae1c8fa3fa1e526f8956266ffe0754f3ea3c8944dfa0bada2864cb75",
        "train64_b64_epoch.init.2147483653":
            "2c1f14d0314df337d04a5cc3289791dc617a9991f9b8ce9a6121811ccbf5ad88",
        "train64_b64_epoch.init.7":
            "d6f6c3e1ca75e35c68104ea03198986deb8b1ade9d065fcf04a62e1c0cd73dbb",
        "train64_b64_epoch.served.2147483653":
            "966ddd896d7273e679d9defae9dfadc1a6257edc20386630c31a53a9a2f4fd53",
        "train64_b64_epoch.served.7":
            "281c4aac66dbbef0281ff442dc9f001e21bc35d769b97b1da088ebb55a92c94f",
    },
    "forward": {
        "eval.torch.bfloat16":
            "bf6cab2642410d21c758ceeff3e7d7927912e623d1bce93fdc0ed79ac876c8f2",
        "eval.torch.float32":
            "efbc8c4e822e40c35051950e17bda4b7b21f1ae500b8e832feee599ea98277f5",
        "train":
            "553bdbcfda9eadc186905ef79140dac4519360cbb81a0ec611ace19b2c676700",
    },
    "runs": {
        "serve96_batch32_fused": {
            "answer_ratio": 0.967782171623061,
            "correct": True,
            "overlap_excess": 0.0,
            "plain_overlap_excess": 0.0,
            "plain_volume_mean": 0.002086164429783821,
            "plain_volume_median": 0.0021154284477233887,
            "volume_mean": 0.0020189527422189713,
            "volume_median": 0.002044081687927246,
        },
        "train64_b64_epoch": {
            "change_median": 8.177697132944274e-06,
            "change_worst": 0.001241298836006891,
            "correct": True,
            "grad_median": 7.651798670400338e-07,
            "grad_worst": 3.6529008013279674e-06,
            "loss_step1": 6.772129032083299e-08,
            "loss_worst": 3.159234994919509e-06,
        },
        "train64_b64_epoch.double": {
            "change_median": 0.0007274400579185936,
            "change_worst": 1.0042184624263366,
            "correct": False,
            "grad_median": 1.2321329540053985e-06,
            "grad_worst": 5.806537843399635e-06,
            "loss_step1": 0.0,
            "loss_worst": 0.0023104985922235413,
        },
        "train64_b64_epoch.half": {
            "change_median": 0.014091436128877376,
            "change_worst": 0.1503769326059721,
            "correct": False,
            "grad_median": 0.21380874445486875,
            "grad_worst": 1.700188587332754,
            "loss_step1": 0.02341937956525164,
            "loss_worst": 0.0971521095574811,
        },
    },
}


def digest(tensors: dict) -> str:
    """sha256 over each tensor's name, dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def config(name: str) -> dict:
    workload = harness.load_json(harness.PERFBENCH / "workloads" / f"{name}.json")
    return harness.load_json(harness.PERFBENCH / "configs" / f"{workload['config']}.json")


def weight_digests() -> dict:
    """Both schemes of both configurations under two seeds, in the type each
    cell serves or trains in."""
    out = {}
    for cell, dtype in ((SERVE, torch.bfloat16), (TRAIN, torch.float32)):
        body = config(cell)
        gain = float(body.get("weights", {}).get("box_size_gain", 1.0))
        for scheme in ("served", "init"):
            for seed in SEEDS:
                sd = weights.make_state_dict(body["model"], seed, "cpu", scheme, dtype,
                                             box_size_gain=gain)
                out[f"{cell}.{scheme}.{seed}"] = digest(sd)
    return out


def forward_digests() -> dict:
    """The MobileNet reference at 32^3, width 0.5: eval in float32 and bf16,
    and training mode with the moved statistics."""
    cfg = {**config(SERVE)["model"], "input_size": [32, 32, 32], "width_mult": 0.5}
    sd = weights.make_state_dict(cfg, 11, "cpu", "served")
    x = data.make_volumes(3, (32, 32, 32), (1, 5), (4, 8), 12, "cpu")["image"]
    out = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            locs, logits = ref.forward(sd, cfg, x, dtype=dtype)
            out[f"eval.{dtype}"] = digest({"locs": locs, "logits": logits})
        moved = {}
        locs, logits = ref.forward(sd, cfg, x, train=True, moved=moved)
        out["train"] = digest({"locs": locs, "logits": logits, **moved})
    return out


def tiny_readings() -> dict:
    torch.set_num_threads(4)
    out = {}
    for name, seed, seconds, faults in ((SERVE, 2**31 + 17, 0.2, ()),
                                        (TRAIN, 2**31 + 23, 0.1, ()),
                                        (TRAIN, 2**31 + 29, 0.1, ("double",)),
                                        (TRAIN, 2**31 + 29, 0.1, ("half",))):
        overrides = TINY_TRAIN if name == TRAIN else TINY_SERVE
        cell = harness.make_cell(name, seed, seconds, False, device="cpu", faults=faults,
                                 overrides=overrides)
        if name == TRAIN:
            cell.config["inputs"] = {**cell.config["inputs"], "num_images": 20}
        readings = {}
        result = run.execute(cell, require_chips=False, readings=readings)
        keep = SERVE_READINGS if name == SERVE else sorted(readings)
        key = ".".join((name, *faults)) if faults else name
        out[key] = {"correct": result["correct"], **{k: readings[k] for k in keep}}
    return out


def values() -> dict:
    return {"weights": weight_digests(), "forward": forward_digests(),
            "runs": tiny_readings()}


def test_weights_unchanged():
    assert weight_digests() == FROZEN["weights"]


def test_reference_forward_unchanged():
    assert forward_digests() == FROZEN["forward"]


def test_tiny_run_readings_unchanged():
    assert tiny_readings() == FROZEN["runs"]


if __name__ == "__main__":
    print(json.dumps(values(), indent=1, sort_keys=True))
