"""The port's Trainer, checkpoints and train CLI against the JAX package's.

The comparison: a 20-image 16^3 synthetic dataset (16 train / 4 val),
float32, width 0.25, batch 8, no augmentation (the two frameworks draw it
differently), metrics every epoch, a loss logged every step. The JAX
trainer's initial state (``PRNGKey(seed)`` split as ``Trainer.fit`` splits
it) is saved with the JAX package's ``save_checkpoint`` at epoch 0, and the
JAX ``Trainer.fit`` resumes from it for epochs 1-3 (6 steps, epoch 2 with
train metrics through the instrumented step). The same state goes through
``from_jax_variables`` into a port checkpoint at epoch 0, and the port's
``Trainer.fit`` resumes from that. Both modules read the volumes with the
Python NIfTI loader (the JAX module's native loader is switched off for the
test), so both train on the same arrays. Held:

* each step's training loss (``metrics.jsonl``) and each epoch's
  ``avg_val_loss`` within rtol 1e-4, as ``test_three_train_steps_match_jax``
  holds three steps;
* the final params by ``assert_params_close`` (the step tests' bound);
* the history keys, the mAP keys and the checkpoint directories: the same
  epochs, ``last``, and the names' losses within their 4 printed decimals.

Patch training: both trainers on 32x32x16 volumes with 16^3 patches, the
random crop set to the deterministic one on both sides (the part the
frameworks draw differently): training and validation losses within rtol
1e-4, and each epoch's full-volume (sliding-window) and crop mAP within
1e-6; then the port's own sampler, logging ``mAP/validation_full_*``.

The rest runs the port alone: checkpoint round trip, top-k with ``last``,
a run stopped after epoch 1 and resumed equals the run straight through
(with augmentation: each epoch's generator is seeded seed + epoch), the
non-finite abort, the streaming path, the option not ported yet
(``spatial_shards``), and the
CLI: every JAX flag parses, with ``--device`` for ``--platform``, and one
``main([..., "--device", "cpu"])`` end to end.
"""

import json

import jax
import numpy as np
import pytest
import torch
from test_torch_port_predict import assert_ieee_float32, tf32_on  # noqa: F401 (a fixture)
from test_torch_port_train_step import assert_params_close

from mslesions3d_tpu.cli import train as jax_cli
from mslesions3d_tpu.data import datasets as jax_datasets
from mslesions3d_tpu.data import patches as jax_patches
from mslesions3d_tpu.data.generate import generate_dataset
from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.train import Trainer as JaxTrainer
from mslesions3d_tpu.train import TrainerConfig as JaxTrainerConfig
from mslesions3d_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from mslesions3d_tpu.train.state import create_train_state as jax_create_train_state
from mslesions3d_tpu_torch.cli import train as cli
from mslesions3d_tpu_torch.data import patches as port_patches
from mslesions3d_tpu_torch.data.augment import AugmentConfig
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.train import (
    CheckpointManager,
    Trainer,
    TrainerConfig,
    create_train_state,
    load_checkpoint,
    save_checkpoint,
)
from mslesions3d_tpu_torch.weights import from_jax_params, from_jax_variables

# torch's first CPU log of a process can come back off by up to ~1e3 float32
# ulp in one thread's block (ROADMAP.md §3, tests/probe_torch_first_log.py);
# one small single-threaded call first avoids it
torch.log(torch.ones(8))

LR = 1e-3
SEED = 970205
KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=LR,
          threshold=(0.1, 0.2), batch_size=8, min_score=0.2)
TRAINER = dict(max_epochs=4, max_steps=-1, early_stopping=False,
               compute_metric_every_n_epochs=1, seed=SEED, log_every_n_steps=1,
               grad_hist_every_n_steps=0, verbose=False)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    generate_dataset(root, num_images=20, n_classes=1, image_size=(16, 16, 16),
                     object_size=(4, 8), num_objects=(1, 3), seed=0)
    return root


def _port_module(root, **kw):
    dm = SyntheticDataModule(root, n_classes=1, batch_size=8, max_objects=6, **kw)
    dm.setup("fit")
    return dm


def _records(logdir, key):
    with open(logdir / "metrics.jsonl") as f:
        return [(r["step"], r[key]) for r in map(json.loads, f) if key in r]


@pytest.fixture(scope="module")
def fitted(dataset_root, tmp_path_factory):
    """Both trainers resumed from the same epoch-0 state; one JAX fit."""
    out = tmp_path_factory.mktemp("fit")
    jcfg, cfg = JaxConfig.create(**KW), SSD3DConfig.create(**KW)
    _, init_rng = jax.random.split(jax.random.PRNGKey(SEED))
    jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, init_rng)
    jax_save_checkpoint(out / "jax_init", jstate, jcfg, extra={"epoch": 0})
    params, stats = jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    state = create_train_state(cfg, device="cpu",
                               state_dict=from_jax_variables(params, stats, cfg))
    save_checkpoint(out / "port_init", state, cfg, extra={"epoch": 0})

    with pytest.MonkeyPatch.context() as mp:  # the JAX module reads with the Python loader
        def no_native(*args, **kwargs):
            raise OSError("native loader off for the comparison")

        mp.setattr("mslesions3d_tpu.native.load_nifti_fast", no_native)
        jdm = jax_datasets.SyntheticDataModule(dataset_root, n_classes=1, batch_size=8,
                                               max_objects=6)
        jdm.setup("fit")
        jax_state, jax_result = JaxTrainer(JaxTrainerConfig(
            logdir=str(out), experiment_name="jax", **TRAINER)).fit(
                jcfg, jdm, resume=str(out / "jax_init"))
    port_state, port_result = Trainer(TrainerConfig(
        logdir=str(out), experiment_name="port", device="cpu", **TRAINER)).fit(
            cfg, _port_module(dataset_root), resume=str(out / "port_init"))
    return dict(out=out, cfg=cfg, jax_state=jax_state, jax_result=jax_result,
                port_state=port_state, port_result=port_result)


def test_fit_losses_match_jax(fitted):
    out = fitted["out"]
    for key, n in (("total_loss/training", 6), ("avg_val_loss", 3)):
        ours, ref = _records(out / "port", key), _records(out / "jax", key)
        assert len(ours) == len(ref) == n
        assert [s for s, _ in ours] == [s for s, _ in ref]
        np.testing.assert_allclose([v for _, v in ours], [v for _, v in ref], rtol=1e-4,
                                   err_msg=key)
    assert [s for s, _ in _records(out / "port", "avg_val_loss")] == [2, 4, 6]


def test_fit_params_match_jax(fitted):
    state = fitted["port_state"]
    assert int(state.step) == int(fitted["jax_state"].step) == 6
    ref = from_jax_params(jax.device_get(fitted["jax_state"].params), fitted["cfg"])
    assert_params_close(state.params, ref, bias_lr=2 * LR)


def test_fit_history_and_checkpoints_match_jax(fitted):
    ours, ref = fitted["port_result"]["history"], fitted["jax_result"]["history"]
    assert [h["epoch"] for h in ours] == [h["epoch"] for h in ref] == [1, 2, 3]
    assert [sorted(h) for h in ours] == [sorted(h) for h in ref]
    assert "mAP/training_IoU_0.1" in ours[1] and "mAP/validation_IoU_0.5" in ours[0]
    assert "hp_metric/parameter_sizes" in ours[1] and "hp_metric/lr" in ours[2]
    np.testing.assert_allclose([h["hp_metric/lr"] for h in ours],
                               [h["hp_metric/lr"] for h in ref], rtol=1e-6)

    def names(which):
        return sorted(p.name for p in (fitted["out"] / which / "checkpoints").iterdir())

    ours, ref = names("port"), names("jax")
    assert len(ours) == len(ref) == 4 and ours[-1] == ref[-1] == "last"
    for a, b in zip(ours[:-1], ref[:-1]):
        assert a.split("-avg")[0] == b.split("-avg")[0]  # the same epochs
        assert float(a.split("=")[-1]) == pytest.approx(float(b.split("=")[-1]), abs=1.5e-4)
    meta = json.loads((fitted["out"] / "port" / "checkpoints" / "last" / "meta.json").read_text())
    assert meta["step"] == 6 and meta["extra"] == {"epoch": 3}
    assert SSD3DConfig.from_json_dict(meta["config"]) == fitted["cfg"]


# ---------------------------------------------------------------- patch training
# power-of-two sides: a box corner k / side times the side is exact in
# float32, so the JAX step's fused multiply-add in the patch remap (one
# rounding, where the port rounds twice) gives the same boxes; on other
# sides the two differ by an ulp, which can flip a tie in prior matching
# on these grid-aligned synthetic boxes
PATCH_VOLUME = (32, 32, 16)


@pytest.fixture(scope="module")
def patch_fitted(tmp_path_factory):
    """Both trainers with ``patch_training`` on 32x32x16 volumes (16^3
    patches), resumed from the same epoch-0 state. The random crop is the
    one part the two frameworks draw differently, so on both sides the
    train step's sampler is set to the deterministic crop (monkeypatched,
    nothing in either package changes); the rest (the train steps on the
    crops, the validation loss on the deterministic crops and the
    full-volume validation through the sliding window) is deterministic."""
    out = tmp_path_factory.mktemp("patch_fit")
    root = out / "data"
    generate_dataset(root, num_images=12, n_classes=1, image_size=PATCH_VOLUME,
                     object_size=(4, 8), num_objects=(1, 3), seed=2)
    jcfg, cfg = JaxConfig.create(**KW), SSD3DConfig.create(**KW)
    _, init_rng = jax.random.split(jax.random.PRNGKey(SEED))
    jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, init_rng)
    jax_save_checkpoint(out / "jax_init", jstate, jcfg, extra={"epoch": 0})
    params, stats = jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    state = create_train_state(cfg, device="cpu",
                               state_dict=from_jax_variables(params, stats, cfg))
    save_checkpoint(out / "port_init", state, cfg, extra={"epoch": 0})
    trainer = dict(TRAINER, patch_training=True)

    with pytest.MonkeyPatch.context() as mp:
        def no_native(*args, **kwargs):
            raise OSError("native loader off for the comparison")

        mp.setattr("mslesions3d_tpu.native.load_nifti_fast", no_native)
        mp.setattr("mslesions3d_tpu.data.patches.sample_patch_starts",
                   lambda rng, vol, patch, boxes, mask, pos: jax_patches
                   .deterministic_patch_starts(vol, patch, boxes, mask))
        mp.setattr("mslesions3d_tpu_torch.train.steps.sample_patch_starts",
                   lambda gen, vol, patch, boxes, mask, pos: port_patches
                   .deterministic_patch_starts(vol, patch, boxes, mask))
        jdm = jax_datasets.SyntheticDataModule(root, n_classes=1, batch_size=8, max_objects=6)
        jdm.setup("fit")
        jax_state, jax_result = JaxTrainer(JaxTrainerConfig(
            logdir=str(out), experiment_name="jax", **trainer)).fit(
                jcfg, jdm, resume=str(out / "jax_init"))
        port_state, port_result = Trainer(TrainerConfig(
            logdir=str(out), experiment_name="port", device="cpu", **trainer)).fit(
                cfg, _port_module(root), resume=str(out / "port_init"))
    return dict(out=out, root=root, jax_result=jax_result, port_result=port_result)


def test_patch_fit_matches_jax(patch_fitted):
    out = patch_fitted["out"]
    for key, n in (("total_loss/training", 3), ("avg_val_loss", 3)):
        ours, ref = _records(out / "port", key), _records(out / "jax", key)
        assert len(ours) == len(ref) == n
        np.testing.assert_allclose([v for _, v in ours], [v for _, v in ref], rtol=1e-4,
                                   err_msg=key)
    ours, ref = patch_fitted["port_result"]["history"], patch_fitted["jax_result"]["history"]
    assert [sorted(h) for h in ours] == [sorted(h) for h in ref]
    for key in ("mAP/validation_full_IoU_0.1", "mAP/validation_full_IoU_0.5",
                "recall/validation_full_IoU_0.1", "mAP/validation_IoU_0.1"):
        np.testing.assert_allclose([h[key] for h in ours], [h[key] for h in ref], atol=1e-6,
                                   err_msg=key)


def test_patch_fit_draws_crops_and_scores_whole_volumes(patch_fitted, tmp_path, capsys):
    """With its own sampler the port's patch training runs, and its metric
    epochs log the full-volume mAP of the sliding window."""
    state, result = Trainer(TrainerConfig(
        logdir=str(tmp_path), experiment_name="patch", device="cpu",
        **dict(TRAINER, max_epochs=2, patch_training=True, patch_pos_fraction=1.0,
               verbose=True))).fit(
            SSD3DConfig.create(**KW), _port_module(patch_fitted["root"]),
            augment=AugmentConfig.from_names(["flip"]))
    assert int(state.step) == 2
    assert all("mAP/validation_full_IoU_0.1" in h for h in result["history"])
    assert "[sliding_window] 9 patches of (16, 16, 16) over (32, 32, 16)" in capsys.readouterr().out


# ---------------------------------------------------------------- port alone
def _state(ema=0.5):
    cfg = SSD3DConfig.create(**dict(KW, ema_decay=ema))
    return cfg, create_train_state(cfg, seed=3, device="cpu")


def test_checkpoint_round_trip(tmp_path):
    cfg, state = _state()
    state = state.replace(step=state.step + 7, nonfinite_streak=state.nonfinite_streak + 2)
    state = state.replace(params={k: v + 0.25 for k, v in state.params.items()})
    save_checkpoint(tmp_path / "c", state, cfg, {"avg_val_loss": 1.5}, extra={"epoch": 4})
    _, template = _state()
    config, loaded, meta = load_checkpoint(tmp_path / "c", state_template=template)
    assert config == cfg and meta["metrics"] == {"avg_val_loss": 1.5}
    assert meta["extra"] == {"epoch": 4} and meta["step"] == 7
    assert int(loaded.step) == 7 and int(loaded.nonfinite_streak) == 2
    for name in ("params", "batch_stats", "ema_params"):
        for k, v in getattr(state, name).items():
            assert torch.equal(getattr(loaded, name)[k], v), (name, k)
    for k, v in loaded.params.items():  # the saved strides are kept
        assert v.stride() == state.params[k].stride(), k
    _, raw, _ = load_checkpoint(tmp_path / "c")
    assert set(raw) == {"step", "params", "batch_stats", "opt_state", "ema_params",
                        "nonfinite_streak"}
    # an EMA checkpoint resumed without EMA drops the stale average
    _, no_ema = _state(ema=0.0)
    with pytest.warns(UserWarning, match="dropping the stale EMA"):
        assert load_checkpoint(tmp_path / "c", state_template=no_ema)[1].ema_params is None


def test_checkpoint_manager_keeps_top_k_and_last(tmp_path):
    cfg, state = _state(ema=0.0)
    manager = CheckpointManager(tmp_path, save_top_k=2)
    for epoch, loss in enumerate((3.0, 1.0, 2.0, 4.0)):
        manager.save(state.replace(step=state.step + epoch), cfg, {"avg_val_loss": loss}, epoch)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["checkpoint-epoch=001-avg_val_loss=1.0000",
                     "checkpoint-epoch=002-avg_val_loss=2.0000", "last"]
    assert manager.best.name == names[0] and manager.latest.name == names[1]
    assert json.loads((tmp_path / "last" / "meta.json").read_text())["extra"] == {"epoch": 3}
    assert CheckpointManager(tmp_path, save_top_k=2).best.name == names[0]  # index restored


def _fit(root, logdir, name, resume=None, **kw):
    cfg = SSD3DConfig.create(**KW)
    tcfg = TrainerConfig(logdir=str(logdir), experiment_name=name, device="cpu",
                         **{**TRAINER, **kw})
    return Trainer(tcfg).fit(cfg, _port_module(root), resume=resume,
                             augment=AugmentConfig.from_names(["flip", "rotate90"]))


def test_stopped_and_resumed_equals_straight_through(dataset_root, tmp_path):
    straight, _ = _fit(dataset_root, tmp_path, "straight", max_epochs=3)
    _fit(dataset_root, tmp_path, "first", max_epochs=1)
    resumed, result = _fit(dataset_root, tmp_path, "second", max_epochs=3,
                           resume=str(tmp_path / "first" / "checkpoints" / "last"))
    assert [h["epoch"] for h in result["history"]] == [1, 2]
    assert int(resumed.step) == int(straight.step) == 6
    for name in ("params", "batch_stats"):
        for k, v in getattr(straight, name).items():
            torch.testing.assert_close(getattr(resumed, name)[k], v, rtol=0, atol=0)


def test_nonfinite_streak_aborts(dataset_root, tmp_path):
    dm = _port_module(dataset_root)
    for s in dm.subjects_list:
        dm.get_sample(s)["img"][:] = np.nan  # the cached volumes
    tcfg = TrainerConfig(logdir=str(tmp_path), experiment_name="nan", device="cpu",
                         max_nonfinite_streak=3, **TRAINER)
    with pytest.raises(FloatingPointError, match="3 consecutive non-finite losses"):
        Trainer(tcfg).fit(SSD3DConfig.create(**KW), dm)


def test_streaming_path_trains(dataset_root, tmp_path):
    state, result = _fit(dataset_root, tmp_path, "stream", max_epochs=2,
                         device_data_cache=False)
    assert int(state.step) == 4 and len(result["history"]) == 2
    assert all(np.isfinite(h["avg_val_loss"]) for h in result["history"])
    assert "mAP/validation_IoU_0.1" in result["history"][1]


# data_parallel and spatial sharding are ported (tests/test_torch_port_parallel.py,
# tests/test_torch_port_spatial.py); spatial sharding in a world that cannot
# hold the mesh raises rather than training unsharded
@pytest.mark.parametrize("option", [pytest.param(dict(spatial_shards=2), id="option1")])
def test_options_not_ported_raise(option, tmp_path):
    tcfg = TrainerConfig(logdir=str(tmp_path), device="cpu", **option)
    with pytest.raises(ValueError, match="spatial_shards=2 does not divide the 1 ranks"):
        Trainer(tcfg).fit(SSD3DConfig.create(**KW), None)


def test_fit_wants_a_card_unless_asked_for_the_cpu(dataset_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainerConfig(logdir=str(tmp_path))).fit(SSD3DConfig.create(**KW),
                                                         _port_module(dataset_root))
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["-d", str(dataset_root), "-ld", str(tmp_path)])


def _options(parser):
    return {opt: (a.dest, a.default, a.nargs, a.type, a.choices)
            for a in parser._actions for opt in a.option_strings if opt not in ("-h", "--help")}


def test_parser_takes_every_jax_flag():
    ours, ref = _options(cli.build_parser()), _options(jax_cli.build_parser())
    ref.pop("--platform")
    device = ours.pop("--device")
    assert device[:2] == ("device", "cuda")
    assert ours == ref


def test_cli_train_end_to_end(dataset_root, tmp_path, tf32_on):
    result = cli.main(["-d", str(dataset_root), "-b", "8", "-wm", "0.25", "-lr", "0.003",
                       "-th", "0.1", "0.2", "-bpl", "3", "--alpha", "2", "-a", "flip",
                       "rotate90", "zoom", "-sr", "cosine_annealed", "--hard_negative_mining",
                       "1", "-es", "0", "-mi", "4", "-ld", str(tmp_path), "-en", "cli",
                       "--device", "cpu"])
    hist = result["history"]
    assert len(hist) == 2 and all(np.isfinite(h["avg_val_loss"]) for h in hist)
    assert "mAP/validation_IoU_0.1" in hist[0] and "mAP/training_IoU_0.1" in hist[0]
    assert result["config"]["boxes_per_location"] == 3 and result["config"]["t_max"] == 4
    ckpts = sorted(p.name for p in (tmp_path / "cli" / "checkpoints").iterdir())
    assert len(ckpts) == 3 and ckpts[-1] == "last"
    assert_ieee_float32()  # a float32 config trains without TF32
