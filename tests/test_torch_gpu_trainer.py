"""The Trainer on the card: the dataset held there, the streaming path, the CLI.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_trainer.py

A 20-image 16^3 synthetic dataset, float32, width 0.25, batch 8, no
augmentation, TF32 off. From the same epoch-0 checkpoint, the card's
``Trainer.fit`` and the CPU's give per-step losses and ``avg_val_loss``
within rtol 1e-4, the bound ``tests/test_torch_port_trainer.py`` holds the
port to against JAX over the same six steps; K1 launches once a validation
batch and once a train-metric step. The streaming path (batches through
pinned memory) and ``cli.train`` run there too.
"""

import json

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.cli import train as cli
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.kernels.nms import greedy_nms_cuda
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    create_train_state,
    load_checkpoint,
    save_checkpoint,
)

pytestmark = pytest.mark.gpu

KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=1e-3,
          threshold=(0.1, 0.2), batch_size=8, min_score=0.2)
TRAINER = dict(max_epochs=3, max_steps=-1, early_stopping=False, compute_metric_every_n_epochs=1,
               log_every_n_steps=1, grad_hist_every_n_steps=0, verbose=False)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _dataset(tmp_path):
    generate_dataset(tmp_path / "data", num_images=20, n_classes=1, image_size=(16, 16, 16),
                     object_size=(4, 8), num_objects=(1, 3), seed=0)
    return tmp_path / "data"


def _module(root):
    dm = SyntheticDataModule(root, n_classes=1, batch_size=8, max_objects=6)
    dm.setup("fit")
    return dm


def _records(logdir, key):
    with open(logdir / "metrics.jsonl") as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def test_fit_on_card_matches_cpu(tmp_path, no_tf32):
    _need_card()
    root, cfg = _dataset(tmp_path), SSD3DConfig.create(**KW)
    save_checkpoint(tmp_path / "init", create_train_state(cfg, seed=0, device="cpu"), cfg,
                    extra={"epoch": 0})
    greedy_nms_cuda.launches = 0
    states = {}
    for device in ("cuda", "cpu"):
        tcfg = TrainerConfig(logdir=str(tmp_path), experiment_name=device, device=device,
                             **TRAINER)
        states[device], _ = Trainer(tcfg).fit(cfg, _module(root), resume=str(tmp_path / "init"))
        if device == "cuda":
            # epochs 1-2: 2 validation batches, and epoch 2's 2 train-metric steps
            assert greedy_nms_cuda.launches == 4
    assert states["cuda"].device.type == "cuda" and int(states["cuda"].step) == 4
    for key in ("total_loss/training", "avg_val_loss"):
        card, host = _records(tmp_path / "cuda", key), _records(tmp_path / "cpu", key)
        assert len(card) == len(host) > 0
        np.testing.assert_allclose(card, host, rtol=1e-4, err_msg=key)
    # the card's checkpoint loads onto a CPU template, strides and all
    template = create_train_state(cfg, seed=1, device="cpu")
    _, loaded, _ = load_checkpoint(tmp_path / "cuda" / "checkpoints" / "last", template)
    for k, v in states["cuda"].params.items():
        assert torch.equal(loaded.params[k], v.cpu()) and loaded.params[k].stride() == v.stride()


def test_streaming_fit_and_cli_on_card(tmp_path, no_tf32):
    _need_card()
    root = _dataset(tmp_path)
    greedy_nms_cuda.launches = 0
    tcfg = TrainerConfig(logdir=str(tmp_path), experiment_name="stream", device="cuda",
                         device_data_cache=False, **dict(TRAINER, max_epochs=1))
    state, result = Trainer(tcfg).fit(SSD3DConfig.create(**KW), _module(root))
    assert int(state.step) == 2 and np.isfinite(result["history"][0]["avg_val_loss"])
    assert greedy_nms_cuda.launches == 3  # 2 train-metric steps, 1 validation batch
    result = cli.main(["-d", str(root), "-b", "8", "-wm", "0.25", "-mi", "4", "-a", "flip",
                       "rotate90", "-ld", str(tmp_path), "-en", "cli"])  # the card by default
    assert len(result["history"]) == 2
    assert all(np.isfinite(e["train_losses"]).all() for e in result["timings"]["epochs"])
