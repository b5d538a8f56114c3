"""The port's whole-epoch train program against the JAX package's and the
port's stepped loop, and ``Trainer(epoch_scan=...)`` on the CPU.

* ``make_gathered_train_epoch`` against the JAX package's (its
  ``lax.scan`` of the epoch) at 16^3, width 0.25, float32, 3 rows of
  micro-batches of 8 from a seeded 24-volume dataset (batch 8, and 16 with
  ``grad_accum=2``), identity augmentation, weights
  from the JAX init through ``weights.from_jax_variables``: plain, with
  ``grad_accum=2`` and with hard negative mining. The stacked losses and
  gradient norms within rtol 1e-4 (``tests/test_torch_port_trainer.py``'s
  tolerance), the final params and EMA by ``assert_params_close``, the step
  and streak equal. Micro-batches of 8, as in ``tests/test_torch_port_train_step.py``:
  at batch 2 the deepest BNs normalise 2 values a channel, and by the third
  step the two frameworks' float32 gradient norms stand 40% apart (2% of
  the params more than 1e-5 apart) while their losses still agree.
* The port's epoch against the port's stepped loop from one seeded
  generator, bit for bit, at batch 2 (3 rows of a 6-volume dataset): flips,
  rot90 and zoom; patch training on 24^3 volumes with ``grad_accum=2``; the
  ConvNet's dropout.
* ``Trainer(epoch_scan=True)`` against ``epoch_scan=False`` (flips and
  rot90, train metrics every other epoch, gradient histograms every step,
  and once with ``max_steps`` cutting a scanned epoch): equal histories,
  ``metrics.jsonl`` records and params, and no gradient histogram logged in
  a scanned epoch, as the JAX ``Trainer`` logs none in its scanned epoch on
  the same run (``MetricsLogger.log_histograms`` counted by monkeypatch:
  without tensorboardX it writes nothing).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_step import _batch, assert_params_close

from mslesions3d_tpu.data import datasets as jax_datasets
from mslesions3d_tpu.data.generate import generate_dataset
from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.train import Trainer as JaxTrainer
from mslesions3d_tpu.train import TrainerConfig as JaxTrainerConfig
from mslesions3d_tpu.train import steps as jax_steps
from mslesions3d_tpu.train.logging import MetricsLogger as JaxMetricsLogger
from mslesions3d_tpu.train.state import create_train_state as jax_create_train_state
from mslesions3d_tpu_torch.data.augment import AugmentConfig
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.parallel.mesh import tree_tensors
from mslesions3d_tpu_torch.train import (
    MetricsLogger,
    Trainer,
    TrainerConfig,
    create_train_state,
    make_gathered_train_epoch,
    make_gathered_train_step,
)
from mslesions3d_tpu_torch.train.graphs import EPOCH_METRICS
from mslesions3d_tpu_torch.weights import from_jax_params, from_jax_variables

# torch's first CPU log of a process can come back off by up to ~1e3 float32
# ulp in one thread's block (ROADMAP.md §3, tests/probe_torch_first_log.py);
# one small single-threaded call first avoids it
torch.log(torch.ones(8))

LR = 1e-3
KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=LR,
          threshold=(0.1, 0.2), ema_decay=0.5, min_score=0.3)
IDX = np.array([[0, 3], [5, 1], [2, 4]], np.int32)  # 3 rows of batch 2


def _dataset(n=6, d=16, seed=0):
    batch = _batch(batch=n, seed=seed, d=d)
    return {k: v for k, v in batch.items() if k != "batch_mask"}


def _on_cpu(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def jax_pair():
    jcfg, cfg = JaxConfig.create(**KW), SSD3DConfig.create(**KW)
    jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, jax.random.PRNGKey(0))
    params, stats = jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    state = create_train_state(cfg, device="cpu",
                               state_dict=from_jax_variables(params, stats, cfg))
    return dict(jcfg=jcfg, cfg=cfg, jstate=jstate, state=state, priors=model_priors(cfg))


@pytest.mark.parametrize("options", [{}, {"grad_accum": 2}, {"hard_negative_mining": True}],
                         ids=["plain", "grad_accum", "hard_negative_mining"])
def test_epoch_matches_jax(jax_pair, options):
    p, data = jax_pair, _dataset(n=24)
    b = 8 * options.get("grad_accum", 1)
    idx = np.stack([np.random.default_rng(i).permutation(24)[:b] for i in range(3)])
    jepoch = jax_steps.make_gathered_train_epoch(p["jcfg"], JaxSSD3D(p["jcfg"]), p["priors"],
                                                 donate=False, **options)
    jnew, jm = jepoch(p["jstate"], {k: jnp.asarray(v) for k, v in data.items()},
                      jnp.asarray(idx, jnp.int32), jax.random.PRNGKey(1))
    epoch = make_gathered_train_epoch(p["cfg"], SSD3D(p["cfg"]), p["priors"], **options)
    new, m = epoch(p["state"], _on_cpu(data), torch.from_numpy(idx))
    assert set(m) == set(EPOCH_METRICS) == set(jm)
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm"):
        assert m[key].shape == (3,) and m[key].dtype == torch.float32
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_array_equal(m["nonfinite_streak"].numpy(),
                                  np.asarray(jm["nonfinite_streak"]))
    assert m["nonfinite_streak"].dtype == torch.int32
    assert int(new.step) == int(jnew.step) == 3 and int(new.opt_state.count) == 3
    assert_params_close(new.params, from_jax_params(jax.device_get(jnew.params), p["cfg"]))
    assert_params_close(new.ema_params,
                        from_jax_params(jax.device_get(jnew.ema_params), p["cfg"]))
    assert int(p["state"].step) == 0  # the old state is left as it was


CONVNET = dict(base_network_config="convnet_maxpool_double", convnet_dropout=0.5,
               aspect_ratios={4: [1.0], 6: [1.0]})
STEPPED_CASES = {
    "augment": (dict(), dict(augment=AugmentConfig.from_names(["flip", "rotate90", "zoom"])), 16),
    "patch_training": (dict(), dict(patch_training=True, grad_accum=2), 24),
    "convnet_dropout": (CONVNET, dict(augment=AugmentConfig(flip_axes=(0, 1, 2))), 16),
}


@pytest.mark.parametrize("case", list(STEPPED_CASES))
def test_epoch_equals_stepped_loop(case):
    extra, options, d = STEPPED_CASES[case]
    cfg = SSD3DConfig.create(**dict(KW, **extra))
    model, priors = SSD3D(cfg), model_priors(cfg)
    state = create_train_state(cfg, seed=3, device="cpu")
    data = _on_cpu(_dataset(d=d))
    augment = options.pop("augment", None)
    epoch = make_gathered_train_epoch(cfg, model, priors, augment, **options)
    step = make_gathered_train_step(cfg, model, priors, augment, **options)

    gen = torch.Generator().manual_seed(11)
    new, m = epoch(state, data, torch.from_numpy(IDX), gen)
    after_epoch = gen.get_state()
    gen.manual_seed(11)
    ref, rows = state, []
    for idx in IDX:
        ref, rm = step(ref, data, torch.from_numpy(idx), gen)
        rows.append(rm)
    assert torch.equal(gen.get_state(), after_epoch)  # the same draws, in the same order
    for key in EPOCH_METRICS:
        assert torch.equal(m[key], torch.stack([r[key] for r in rows])), key
    ours, theirs = tree_tensors(new), tree_tensors(ref)
    assert len(ours) == len(theirs)
    assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
    assert int(new.step) == 3


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    generate_dataset(root, num_images=10, n_classes=1, image_size=(16, 16, 16),
                     object_size=(4, 8), num_objects=(1, 3), seed=0)
    return root


FIT_KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=LR,
              threshold=(0.1, 0.2), batch_size=4, min_score=0.2)
TRAINER = dict(max_epochs=3, max_steps=-1, early_stopping=False, compute_metric_every_n_epochs=1,
               seed=5, log_every_n_steps=1, grad_hist_every_n_steps=1, verbose=False)


@pytest.fixture
def histogram_steps(monkeypatch):
    """The steps at which each logger class is asked for gradient histograms."""
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(MetricsLogger, "log_histograms",
                        lambda self, tree, step, prefix="epoch/": calls["port"].append(step))
    monkeypatch.setattr(JaxMetricsLogger, "log_histograms",
                        lambda self, tree, step, prefix="epoch/": calls["jax"].append(step))
    return calls


def _records(logdir):
    with open(logdir / "metrics.jsonl") as f:
        return [{k: v for k, v in r.items() if k != "time"} for r in map(json.loads, f)]


def _port_fit(root, out, scan, **trainer):
    dm = SyntheticDataModule(root, n_classes=1, batch_size=4, max_objects=6)
    dm.setup("fit")
    name = f"scan_{scan}"
    augment = AugmentConfig(flip_axes=(0, 1, 2), rot90_planes=((1, 2),))
    state, result = Trainer(TrainerConfig(logdir=str(out), experiment_name=name, device="cpu",
                                          epoch_scan=scan, **trainer)).fit(
        SSD3DConfig.create(**FIT_KW), dm, augment)
    return state, result, _records(out / name)


@pytest.mark.parametrize("limits", [dict(), dict(max_epochs=None, max_steps=3)],
                         ids=["three_epochs", "max_steps_in_a_scanned_epoch"])
def test_trainer_epoch_scan_equals_stepping(dataset_root, tmp_path, histogram_steps, limits):
    trainer = dict(TRAINER, **limits)
    scanned, scan_result, scan_records = _port_fit(dataset_root, tmp_path, True, **trainer)
    scan_hist = list(histogram_steps["port"])
    histogram_steps["port"].clear()
    stepped, step_result, step_records = _port_fit(dataset_root, tmp_path, False, **trainer)
    # 8 training volumes, batch 4: two steps an epoch; epoch 1 logs no train
    # metrics, so it is the scanned one
    n_steps = 6 if not limits else 3
    assert int(scanned.step) == int(stepped.step) == n_steps
    assert scan_result["history"] == step_result["history"]
    assert scan_records == step_records
    assert sum("total_loss/training" in r for r in scan_records) == n_steps
    assert all(torch.equal(a, b) for a, b in zip(tree_tensors(scanned), tree_tensors(stepped)))
    assert [e["scanned"] for e in scan_result["timings"]["epochs"]] == [False, True, False][:len(
        scan_result["history"])]
    assert not any(e["scanned"] for e in step_result["timings"]["epochs"])
    assert histogram_steps["port"] == list(range(n_steps))
    assert scan_hist == [s for s in range(n_steps) if s not in (2, 3)]


def test_no_histograms_in_jax_scanned_epoch(dataset_root, tmp_path, histogram_steps):
    """The JAX ``Trainer`` on the same run logs its histograms at the steps
    the port's scanned run does."""
    _port_fit(dataset_root, tmp_path, True, **TRAINER)
    jdm = jax_datasets.SyntheticDataModule(dataset_root, n_classes=1, batch_size=4,
                                           max_objects=6)
    jdm.setup("fit")
    JaxTrainer(JaxTrainerConfig(logdir=str(tmp_path), experiment_name="jax", **TRAINER)).fit(
        JaxConfig.create(**FIT_KW), jdm)
    assert histogram_steps["jax"] == histogram_steps["port"] == [0, 1, 4, 5]
