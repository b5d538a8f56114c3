"""Patch training, remat, the ConvNet and connected components on the card.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_patches.py

- Connected components on the card equal the CPU's: labels exactly, boxes
  and validity exactly (random masks, the snake, an empty mask), and
  ``SyntheticDataModule(device_boxes=True)`` on the card gives the host
  path's boxes.
- Patch starts from the same draws, the crops and the re-mapped boxes on
  the card equal the CPU's exactly; a patch train step with a CUDA
  generator runs and its eval step crops deterministically (the same
  starts as the CPU).
- ``remat`` on the card: the step's loss equals the plain step's within
  1e-5 relative, and the forward keeps less than half the memory for the
  backward (64^3, width 1.0, batch 8).
- The ConvNet trains on the card: finite losses with dropout drawn from a
  CUDA generator.
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.data import patches
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.ops import connected_components as cc
from mslesions3d_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from mslesions3d_tpu_torch.train.steps import _cast

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _masks():
    rng = np.random.default_rng(0)
    out = [rng.uniform(size=(24, 20, 22)) < p for p in (0.15, 0.3, 0.5)]
    snake = np.zeros((16, 16, 16), bool)
    snake[2:12, 2:4, 2:4] = snake[10:12, 2:10, 2:4] = snake[10:12, 8:10, 2:12] = True
    return out + [snake, np.zeros((8, 8, 8), bool)]


def test_connected_components_equal_the_cpu():
    _need_card()
    for mask in _masks():
        cpu = cc.connected_components_3d(torch.from_numpy(mask))
        card = cc.connected_components_3d(torch.from_numpy(mask).cuda())
        assert torch.equal(card.cpu(), cpu)
        for a, b in zip(cc.component_boxes(card, 16), cc.component_boxes(cpu, 16)):
            assert torch.equal(a.cpu(), b)


def test_device_boxes_on_the_card_equal_the_host_path(tmp_path):
    _need_card()
    generate_dataset(tmp_path / "d", num_images=4, n_classes=1, image_size=(24, 24, 24),
                     object_size=(5, 8), num_objects=(1, 3), seed=0)
    host = SyntheticDataModule(tmp_path / "d", n_classes=1)
    card = SyntheticDataModule(tmp_path / "d", n_classes=1, device_boxes=True)
    for s in host.subjects_list:
        h, d = host.get_sample(s), card.get_sample(s)
        assert sorted(h["labels"].tolist()) == sorted(d["labels"].tolist())
        np.testing.assert_allclose(np.sort(d["boxes"], axis=0), np.sort(h["boxes"], axis=0),
                                   atol=1e-6)


def _full_batch(device, b=8, vol=(40, 36, 32)):
    rng = np.random.default_rng(1)
    lo = rng.uniform(0.1, 0.6, (b, 2, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.3, (b, 2, 3))], -1).astype(np.float32)
    batch = {"image": rng.normal(size=(b, *vol, 1)).astype(np.float32), "boxes": boxes,
             "labels": np.ones((b, 2), np.int32), "box_mask": np.ones((b, 2), bool)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def test_patches_on_the_card_equal_the_cpu():
    _need_card()
    vol, patch = (40, 36, 32), (16, 16, 16)
    cpu, card = _full_batch("cpu"), _full_batch("cuda")
    draws = patches.draw_patch_params(torch.Generator().manual_seed(0), 8)
    starts = {}
    for name, b in (("cpu", cpu), ("cuda", card)):
        d = {k: v.to(name) for k, v in draws.items()}
        starts[name] = patches.patch_starts_from_draws(d, vol, patch, b["boxes"],
                                                       b["box_mask"], 0.7)
    assert torch.equal(starts["cuda"].cpu(), starts["cpu"])
    for fn in (lambda b, s: patches.crop_patches(b["image"], s, patch),
               lambda b, s: patches.boxes_to_patch(b["boxes"], b["box_mask"], s, vol, patch)[0],
               lambda b, s: patches.deterministic_patch_starts(vol, patch, b["boxes"],
                                                               b["box_mask"])):
        assert torch.equal(fn(card, starts["cuda"]).cpu(), fn(cpu, starts["cpu"]))


def test_patch_steps_run_on_the_card():
    _need_card()
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(16, 16, 16),
                             width_mult=0.25, lr=1e-3, threshold=(0.1, 0.2))
    priors = model_priors(cfg)
    state = create_train_state(cfg, device="cuda")
    batch = _full_batch("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    new, m = make_train_step(cfg, SSD3D(cfg), priors, patch_training=True,
                             with_detections=True)(state, batch, gen)
    assert np.isfinite(float(m["total_loss"])) and int(new.step) == 1
    assert int(m["aug_box_mask"].sum()) > 0
    ev = make_eval_step(cfg, SSD3D(cfg), priors, patch_training=True)(new, batch)
    ref = make_eval_step(cfg, SSD3D(cfg), priors, patch_training=True)(
        create_train_state(cfg, device="cpu", state_dict={
            k: v.cpu() for k, v in new.state_dict().items()}),
        {k: v.cpu() for k, v in batch.items()})
    assert torch.equal(ev["gt_boxes"].cpu(), ref["gt_boxes"])
    np.testing.assert_allclose(float(ev["total_loss"]), float(ref["total_loss"]), rtol=1e-4)


def test_remat_on_the_card_keeps_less_for_the_backward():
    _need_card()
    kw = dict(n_classes=2, input_channels=1, input_size=(64, 64, 64), lr=1e-3,
              threshold=(0.1, 0.2))
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.normal(size=(8, 64, 64, 64, 1)).astype(np.float32)),
             "boxes": torch.tensor([[[0.2, 0.2, 0.2, 0.5, 0.5, 0.5]]] * 8),
             "labels": torch.ones((8, 1), dtype=torch.int32),
             "box_mask": torch.ones((8, 1), dtype=torch.bool)}
    batch = {k: v.cuda() for k, v in batch.items()}
    loss, held = {}, {}
    for remat in (False, True):
        cfg = SSD3DConfig.create(**kw, remat=remat)
        state = create_train_state(cfg, seed=0, device="cuda")
        model = SSD3D(cfg).train()
        leaves = {n: p.detach().requires_grad_() for n, p in state.params.items()}
        stats = {n: t.clone() for n, t in state.batch_stats.items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        locs, _ = torch.func.functional_call(model, (_cast(model, leaves), stats),
                                             (batch["image"],))
        torch.cuda.synchronize()
        held[remat] = torch.cuda.memory_allocated() - base
        del locs
        _, m = make_train_step(cfg, SSD3D(cfg), model_priors(cfg))(state, batch)
        loss[remat] = float(m["total_loss"])
    np.testing.assert_allclose(loss[True], loss[False], rtol=1e-5)
    assert held[True] < held[False] / 2, held


def test_convnet_trains_on_the_card():
    _need_card()
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(32, 32, 32),
                             base_network_config="convnet_maxpool_double",
                             aspect_ratios={6: [1.0], 9: [1.0]}, lr=1e-3, threshold=(0.1, 0.2))
    state = create_train_state(cfg, device="cuda")
    assert state.batch_stats == {}
    step = make_train_step(cfg, SSD3D(cfg), model_priors(cfg))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = _full_batch("cuda", vol=(32, 32, 32))
    losses = []
    for _ in range(3):
        state, m = step(state, batch, gen)
        losses.append(float(m["total_loss"]))
    assert all(np.isfinite(losses))
