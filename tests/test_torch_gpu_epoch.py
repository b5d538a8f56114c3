"""The whole-epoch train program on the card: the CUDA graph against the
stepped loop.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_epoch.py

At 16^3, width 0.25, float32, TF32 off and cuDNN deterministic, batch 2
(4 with ``grad_accum=2``), 3 rows of a seeded 6-volume dataset on the card,
from one seeded generator: ``make_gathered_train_epoch`` (one gathered step
captured into a CUDA graph and replayed a row) against the gathered step
called a row, each variant bit for bit: the losses, gradient norms and
streaks of every step, the params, optimizer state, BN statistics, EMA,
``step`` and ``nonfinite_streak`` after the epoch. Variants: plain,
``grad_accum=2``, hard negative mining, flips + rot90 + zoom, patch
training on 24^3 volumes, the ConvNet's dropout. The ConvNet's max pool
(3^3 windows at stride 2, which overlap) has no deterministic backward on
CUDA (``max_pool3d_with_indices_backward_cuda`` sums with atomics; torch
raises under ``use_deterministic_algorithms``), so neither path repeats
itself bit for bit past the first backward (an H100 run: two stepped runs'
second-step losses 1.6e-7 apart, relative). For it the first step's losses
(its dropout masks and forward) are bit-equal, the generator ends where
the stepped loop leaves it, the losses and gradient norms are held within
rtol 1e-4 (the port's tolerance against the JAX package) and the params as
``tests/test_torch_gpu_train.py`` holds them. Then: a non-finite step
inside an epoch is skipped as the stepped step skips it; a second epoch
replays without capturing again and sees the generator's re-seed; a
change of batch captures again; the spans ``msl.epoch.state_in`` and
``msl.epoch.state_out`` bracket the replays inside ``msl.epoch``; a capture
that fails raises; and ``Trainer(epoch_scan=True)`` equals
``epoch_scan=False`` on the card.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mslesions3d_tpu_torch.data import augment as augment_module
from mslesions3d_tpu_torch.data.augment import AugmentConfig
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.parallel.mesh import tree_tensors
from mslesions3d_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    create_train_state,
    make_gathered_train_epoch,
    make_gathered_train_step,
)
from mslesions3d_tpu_torch.train.graphs import EPOCH_METRICS

pytestmark = pytest.mark.gpu

SMALL = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=1e-3,
             threshold=(0.1, 0.2), ema_decay=0.5, min_score=0.3)
IDX = np.array([[0, 3], [5, 1], [2, 4]])
FLIPS = AugmentConfig(flip_axes=(0, 1, 2))
CONVNET = dict(base_network_config="convnet_maxpool_double", convnet_dropout=0.5,
               aspect_ratios={4: [1.0], 6: [1.0]})
# (config overrides, step options, augmentation, volume side)
VARIANTS = {
    "plain": ({}, {}, None, 16),
    "grad_accum": ({}, dict(grad_accum=2), None, 16),
    "hard_negative_mining": ({}, dict(hard_negative_mining=True), None, 16),
    "augment": ({}, {}, AugmentConfig.from_names(["flip", "rotate90", "zoom"]), 16),
    "patch_training": ({}, dict(patch_training=True), FLIPS, 24),
    "convnet_dropout": (CONVNET, {}, FLIPS, 16),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def deterministic():
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _dataset(n=6, d=16, seed=0):
    """Seeded volumes with two painted cubes each and their boxes, on the card."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (n, d, d, d, 1)).astype(np.float32)
    boxes = np.zeros((n, 3, 6), np.float32)
    labels = np.zeros((n, 3), np.int32)
    mask = np.zeros((n, 3), bool)
    for b in range(n):
        for j in range(2):
            lo = rng.uniform(0.05, 0.5, 3)
            boxes[b, j] = np.concatenate([lo, lo + rng.uniform(0.25, 0.45, 3)]).clip(0, 1)
            labels[b, j], mask[b, j] = 1, True
            vox = (boxes[b, j] * d).astype(int)
            images[b, vox[0]:vox[3], vox[1]:vox[4], vox[2]:vox[5], 0] += 3.0
    host = {"image": images, "boxes": boxes, "labels": labels, "box_mask": mask}
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def _setup(variant):
    extra, options, augment, d = VARIANTS[variant]
    cfg = SSD3DConfig.create(**dict(SMALL, **extra))
    model, priors = SSD3D(cfg), model_priors(cfg)
    state = create_train_state(cfg, seed=3, device="cuda")
    epoch = make_gathered_train_epoch(cfg, model, priors, augment, **options)
    step = make_gathered_train_step(cfg, model, priors, augment, **options)
    return state, epoch, step, _dataset(d=d)


def _stepped(step, state, data, idx_matrix, gen):
    rows = []
    for idx in idx_matrix:
        state, m = step(state, data, idx, gen)
        rows.append(m)
    return state, {k: torch.stack([m[k] for m in rows]) for k in EPOCH_METRICS}


def _assert_equal(graphed, stepped):
    """Bit for bit, a skipped step's NaN loss included."""
    (state, m), (ref, rm) = graphed, stepped
    for key in EPOCH_METRICS:
        torch.testing.assert_close(m[key], rm[key], rtol=0, atol=0, equal_nan=True, msg=key)
    ours, theirs = tree_tensors(state), tree_tensors(ref)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _assert_close(graphed, stepped):
    """The metrics within rtol 1e-4, the params as the step tests hold them
    (``tests/test_torch_gpu_train.py``: 99.9% within 1e-5, all within 4 lr),
    ``step`` and the streak equal."""
    (state, m), (ref, rm) = graphed, stepped
    for key in EPOCH_METRICS:
        torch.testing.assert_close(m[key], rm[key], rtol=1e-4, atol=0, msg=key)
    diffs = torch.cat([(state.params[k] - p).abs().flatten() for k, p in ref.params.items()])
    assert float((diffs <= 1e-5).float().mean()) >= 0.999
    assert float(diffs.max()) <= 4 * SMALL["lr"]
    assert torch.equal(state.step, ref.step)
    assert torch.equal(state.nonfinite_streak, ref.nonfinite_streak)


def _idx(batch):
    return torch.stack([torch.from_numpy(np.random.default_rng(i).permutation(6)[:batch])
                        for i in range(3)]).cuda()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_graphed_epoch_equals_stepped_loop(variant, deterministic):
    _need_card()
    state, epoch, step, data = _setup(variant)
    idx = _idx(4 if variant == "grad_accum" else 2)
    gen = torch.Generator(device="cuda").manual_seed(11)
    graphed = epoch(state, data, idx, gen)
    after = gen.get_state()
    gen.manual_seed(11)
    stepped = _stepped(step, state, data, idx, gen)
    assert torch.equal(gen.get_state(), after)
    if variant == "convnet_dropout":  # the max pool's backward sums in any order
        for key in ("total_loss", "conf_loss", "loc_loss"):
            assert torch.equal(graphed[1][key][0], stepped[1][key][0]), key
        _assert_close(graphed, stepped)
    else:
        _assert_equal(graphed, stepped)
    assert epoch.graphed.captures == 1 and int(graphed[0].step) == 3
    # the state handed out is the caller's: a later call does not write it
    kept = [t.clone() for t in tree_tensors(graphed[0])]
    epoch(graphed[0], data, idx, gen)
    assert all(torch.equal(a, b) for a, b in zip(kept, tree_tensors(graphed[0])))


def test_nonfinite_step_is_skipped_as_stepped(deterministic):
    _need_card()
    state, epoch, step, data = _setup("plain")
    data["image"][5] = float("nan")  # row 1 of IDX gathers volume 5
    idx = torch.from_numpy(IDX).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    graphed = epoch(state, data, idx, gen)
    stepped = _stepped(step, state, data, idx, gen.manual_seed(0))
    _assert_equal(graphed, stepped)
    assert graphed[1]["nonfinite_streak"].tolist() == [0, 1, 0]
    assert not bool(torch.isfinite(graphed[1]["total_loss"][1]))
    assert int(graphed[0].opt_state.count) == 2 and int(graphed[0].step) == 3


def test_replays_see_the_reseed_and_a_new_batch_captures_again(deterministic):
    _need_card()
    state, epoch, step, data = _setup("augment")
    gen = torch.Generator(device="cuda")
    for seed in (1, 2):  # two epochs of one fit: one capture, re-seeded
        gen.manual_seed(seed)
        graphed = epoch(state, data, _idx(2), gen)
        _assert_equal(graphed, _stepped(step, state, data, _idx(2), gen.manual_seed(seed)))
        state = graphed[0]
    assert epoch.graphed.captures == 1
    gen.manual_seed(3)
    graphed = epoch(state, data, _idx(4), gen)
    assert epoch.graphed.captures == 2
    _assert_equal(graphed, _stepped(step, state, data, _idx(4), gen.manual_seed(3)))


def test_epoch_spans_bracket_the_replays(deterministic):
    """Under the profiler a call opens ``msl.epoch``, and inside it one
    ``msl.epoch.state_in`` before the replays and one
    ``msl.epoch.state_out`` after them, each launching work on the card;
    the replays open no span, and no span reaches the device's timeline."""
    _need_card()
    state, epoch, _step, data = _setup("plain")
    idx = torch.from_numpy(IDX).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = epoch(state, data, idx, gen)  # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(state, data, idx, gen)
        torch.cuda.synchronize()
    events = prof.events()
    spans = {name: [e for e in events if e.name == name]
             for name in ("msl.epoch", "msl.epoch.state_in", "msl.epoch.state_out")}
    assert {name: len(found) for name, found in spans.items()} == dict.fromkeys(spans, 1)
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation
               for e in events if e.name.startswith("msl."))
    (whole,), (state_in,), (state_out,) = spans.values()
    replays = sorted(e.time_range.start for e in events if e.name == "cudaGraphLaunch")
    assert len(replays) == len(IDX) and epoch.graphed.captures == 1
    assert whole.time_range.start <= state_in.time_range.start
    assert state_in.time_range.end <= replays[0] and replays[-1] <= state_out.time_range.start
    assert state_out.time_range.end <= whole.time_range.end
    for span in (state_in, state_out):
        assert span.device_time_total > 0
        assert any(e.device_type == DeviceType.CPU and e.name.startswith("cuda")
                   and span.time_range.start <= e.time_range.start < span.time_range.end
                   for e in events)


def test_trainer_epoch_scan_equals_stepping_on_the_card(tmp_path, deterministic):
    _need_card()
    root = tmp_path / "data"
    generate_dataset(root, num_images=10, n_classes=1, image_size=(16, 16, 16),
                     object_size=(4, 8), num_objects=(1, 3), seed=0, num_processes=1)
    out = {}
    for scan in (True, False):
        dm = SyntheticDataModule(root, n_classes=1, batch_size=4, max_objects=6)
        dm.setup("fit")
        tcfg = TrainerConfig(logdir=str(tmp_path), experiment_name=f"scan_{scan}", max_epochs=3,
                             max_steps=-1, early_stopping=False, seed=5, log_every_n_steps=1,
                             grad_hist_every_n_steps=0, verbose=False, epoch_scan=scan)
        out[scan] = Trainer(tcfg).fit(SSD3DConfig.create(**dict(SMALL, batch_size=4)), dm,
                                      AugmentConfig(flip_axes=(0, 1, 2)))
    (scanned, a), (stepped, b) = out[True], out[False]
    assert int(scanned.step) == int(stepped.step) == 6
    assert a["history"] == b["history"]
    assert [e["train_losses"] for e in a["timings"]["epochs"]] == \
        [e["train_losses"] for e in b["timings"]["epochs"]]
    assert all(torch.equal(x, y) for x, y in zip(tree_tensors(scanned), tree_tensors(stepped)))


def test_a_failed_capture_raises(monkeypatch):
    _need_card()
    state, epoch, _step, data = _setup("augment")

    def uncached(values, dtype, like):  # a copy from host memory in every step
        return torch.tensor(values, dtype=dtype, device=like.device)

    monkeypatch.setattr(augment_module, "device_constant", uncached)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with pytest.raises(RuntimeError):
        epoch(state, data, _idx(2), gen)
    assert epoch.graphed.captured is None
