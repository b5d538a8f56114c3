"""The port's small tools against the JAX package's: the host prefetch,
the reference-checkpoint import (library and CLI), the LR finder, the
prior-box wireframes, the dataset box statistics, the metric-file readers,
and every tool's flags. Inputs come from numpy seeds and seeded synthetic
datasets at 16^3 with width 0.25.
"""

import importlib.util
import json
import re
import shlex
import sys
import threading
import time
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mslesions3d_tpu.cli import import_torch as jax_import_cli
from mslesions3d_tpu.cli import model_insight as jax_insight
from mslesions3d_tpu.cli import plots as jax_plots
from mslesions3d_tpu.cli import stats_objects as jax_stats
from mslesions3d_tpu.cli import tune_lr as jax_tune
from mslesions3d_tpu.data import datasets as jax_datasets
from mslesions3d_tpu.data.generate import generate_dataset
from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
from mslesions3d_tpu.train.state import create_train_state as jax_create_train_state
from mslesions3d_tpu.train.torch_import import convert_torch_state_dict as jax_convert
from mslesions3d_tpu.utils.prefetch import prefetch as jax_prefetch
from mslesions3d_tpu_torch.cli import (import_torch, model_insight, plots, recipe, stats_objects,
                                       tune_lr)
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.data.nifti import load_nifti
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig
from mslesions3d_tpu_torch.train import create_train_state, load_checkpoint, save_checkpoint
from mslesions3d_tpu_torch.train.torch_import import convert_torch_state_dict
from mslesions3d_tpu_torch.utils.prefetch import prefetch
from mslesions3d_tpu_torch.weights import from_jax_variables
from test_torch_port_eval import jax_main_parser, options
from test_torch_port_predict import assert_ieee_float32, tf32_on  # noqa: F401 (a fixture)
from test_torch_port_forward import randomized_variables

# torch's first CPU log of a process can come back off by up to ~1e3 float32
# ulp in one thread's block (ROADMAP.md §3, tests/probe_torch_first_log.py);
# one small single-threaded call first avoids it
torch.log(torch.ones(8))

REPO = Path(__file__).resolve().parents[1]
SIZE = (16, 16, 16)
TINY = dict(n_classes=2, input_channels=1, input_size=SIZE, width_mult=0.25)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    generate_dataset(root, num_images=12, n_classes=1, image_size=SIZE, object_size=(4, 8),
                     num_objects=(1, 3), seed=0)
    return root


@pytest.fixture
def python_loader(monkeypatch):
    """The JAX datamodules read with the Python NIfTI loader, as the port's do."""
    def no_native(*args, **kwargs):
        raise OSError("native loader off for the comparison")

    monkeypatch.setattr("mslesions3d_tpu.native.load_nifti_fast", no_native)


# ------------------------------------------------------------------ prefetch
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_keeps_order(depth):
    items = [np.full(3, i) for i in range(20)]
    ours = list(prefetch(iter(items), depth))
    ref = list(jax_prefetch(iter(items), depth))
    assert [int(x[0]) for x in ours] == [int(x[0]) for x in ref] == list(range(20))
    assert all(a is b for a, b in zip(ours, items))  # the items themselves, not copies


def test_prefetch_runs_ahead_on_a_thread():
    produced = []

    def gen():
        for i in range(4):
            produced.append((i, threading.get_ident()))
            yield i

    it = prefetch(gen(), 2)
    assert next(it) == 0
    deadline = time.time() + 5
    while len(produced) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 3  # items 1 and 2 were made before they were asked for
    assert {t for _, t in produced} != {threading.get_ident()}
    assert list(it) == [1, 2, 3]


@pytest.mark.parametrize("fn", [prefetch, jax_prefetch], ids=["port", "jax"])
def test_prefetch_reraises_the_producers_error(fn):
    def gen():
        yield 1
        yield 2
        raise ValueError("bad volume")

    it = fn(gen(), 2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="bad volume"):
        next(it)


@pytest.mark.parametrize("depth", [0, -1])
def test_prefetch_off_returns_the_iterable(depth):
    gen = (i for i in range(3))
    assert prefetch(gen, depth) is gen
    assert list(prefetch([1, 2, 3], depth)) == list(jax_prefetch([1, 2, 3], depth)) == [1, 2, 3]
    assert threading.active_count() >= 1


# ------------------------------------------------------------------ torch import
def _reference_state_dict(config, seed=0):
    """A state_dict in the reference schema, from randomized JAX variables."""
    _, params, stats = randomized_variables(config, seed=seed)
    return params, stats, from_jax_variables(params, stats, SSD3DConfig.create(**config))


IMPORT_CFG = dict(n_classes=2, input_channels=1, input_size=(32, 32, 32), width_mult=0.25)


def test_convert_matches_jax():
    params, stats, sd = _reference_state_dict(IMPORT_CFG)
    cfg = SSD3DConfig.create(**IMPORT_CFG)
    ours = convert_torch_state_dict(sd, cfg)
    jp, js = jax_convert({k: v.numpy() for k, v in sd.items()}, JaxConfig.create(**IMPORT_CFG))
    ref = from_jax_variables(jp, js, cfg)
    assert sorted(ours) == sorted(k for k in ref if not k.endswith("num_batches_tracked"))
    for k, v in ours.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)


def test_convert_ignores_extra_entries_and_checks_the_schema():
    _, _, sd = _reference_state_dict(IMPORT_CFG)
    cfg = SSD3DConfig.create(**IMPORT_CFG)
    ours = convert_torch_state_dict({**sd, "loss.priors": torch.zeros(3)}, cfg)
    assert "loss.priors" not in ours
    short = {k: v for k, v in sd.items() if k != "pred_convs.cl_convs.1.bias"}
    with pytest.raises(KeyError, match="cl_convs.1.bias"):
        convert_torch_state_dict(short, cfg)
    bad = {**sd, "base.features.1.conv1.weight": torch.zeros(3, 1, 3, 3, 3)}
    with pytest.raises(ValueError, match="conv1.weight"):
        convert_torch_state_dict(bad, cfg)


def test_rescale_factors_length_mismatch_keeps_the_init():
    """width 0.5: the reference's rescale_factors has int(int(C*wm)*wm)
    entries; both imports warn and keep their own initialization."""
    kw = {**IMPORT_CFG, "width_mult": 0.5}
    _, _, sd = _reference_state_dict(kw)
    n = sd["rescale_factors"].numel()
    sd["rescale_factors"] = torch.full((1, int(n * 0.5), 1, 1, 1), 3.0)
    cfg = SSD3DConfig.create(**kw)
    with pytest.warns(UserWarning, match="rescale_factors length"):
        ours = convert_torch_state_dict(sd, cfg)
    with pytest.warns(UserWarning, match="rescale_factors length"):
        jp, _ = jax_convert({k: v.numpy() for k, v in sd.items()}, JaxConfig.create(**kw))
    assert "rescale_factors" not in ours and "rescale_factors" not in jp
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ok = convert_torch_state_dict({**sd, "rescale_factors": torch.full((n,), 3.0)}, cfg)
    assert ok["rescale_factors"].shape == (1, n, 1, 1, 1)


def test_import_cli_matches_jax(tmp_path):
    """A Lightning-style .ckpt through both CLIs: the same weights and BN
    statistics in both checkpoints, and the same config."""
    cfg_kw = dict(n_classes=2, input_channels=1, input_size=(32, 32, 32), width_mult=0.25,
                  aspect_ratios={3: [1.0], 5: [1.0], 7: [1.0]}, boxes_per_location=3)
    _, _, sd = _reference_state_dict(cfg_kw, seed=2)
    torch.save({"state_dict": sd, "epoch": 7}, tmp_path / "ref.ckpt")
    flags = ["-m", str(tmp_path / "ref.ckpt"), "--input_size", "32", "32", "32", "-bpl", "3",
             "-wm", "0.25"]
    jax_import_cli.main([*flags, "-o", str(tmp_path / "jax")])
    import_torch.main([*flags, "-o", str(tmp_path / "port"), "--device", "cpu"])
    jcfg, jpayload, _ = jax_load_checkpoint(tmp_path / "jax")
    cfg, payload, meta = load_checkpoint(tmp_path / "port")
    assert cfg.to_json_dict() == jcfg.to_json_dict()
    assert meta["extra"]["imported_from"] == str(tmp_path / "ref.ckpt")
    ref = from_jax_variables(jpayload["params"], jpayload["batch_stats"], cfg)
    for k, v in {**payload["params"], **payload["batch_stats"]}.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
        torch.testing.assert_close(v, sd[k].to(v.dtype), rtol=0, atol=0)


def test_import_cli_wants_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        import_torch.main(["-m", str(tmp_path / "x.ckpt"), "-o", str(tmp_path / "o")])


# ------------------------------------------------------------------ lr_find
def test_lr_find_matches_jax(dataset_root, python_loader):
    """Plain SGD from JAX's initial weights over the same batches: the
    losses within rtol 1e-4 while the lr is small, the same stop and the
    same suggestion. 16^3, width 0.25, batch 4, 12 steps from 1e-5 to 1."""
    kw = dict(n_classes=2, input_channels=1, input_size=SIZE, width_mult=0.25,
              threshold=[0.1, 0.2])
    jcfg, cfg = JaxConfig.create(**kw), SSD3DConfig.create(**kw)
    jdm = jax_datasets.SyntheticDataModule(dataset_root, n_classes=1, batch_size=4, cache=True)
    jdm.setup("fit")
    dm = SyntheticDataModule(dataset_root, n_classes=1, batch_size=4, cache=True)
    dm.setup("fit")
    sweep = dict(lr_min=1e-5, lr_max=1.0, n_steps=12)
    ref_s, ref_h = jax_tune.lr_find(jcfg, jdm, **sweep)
    jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, jax.random.PRNGKey(0))
    sd = from_jax_variables(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
                            cfg)
    ours_s, ours_h = tune_lr.lr_find(cfg, dm, **sweep, device="cpu", state_dict=sd)
    assert len(ours_h) == len(ref_h)
    assert [h["lr"] for h in ours_h] == [h["lr"] for h in ref_h]
    first = [h for h in ref_h if h["lr"] <= 1e-2]
    assert len(first) >= 6
    np.testing.assert_allclose([h["loss"] for h in ours_h[:len(first)]],
                               [h["loss"] for h in first], rtol=1e-4)
    assert ours_s == ref_s


def test_tune_lr_cli(dataset_root, tmp_path, tf32_on):
    out = tmp_path / "lr.json"
    suggestion = tune_lr.main(["-d", str(dataset_root), "-b", "4", "-wm", "0.25", "-n", "8",
                               "-o", str(out), "--device", "cpu"])
    assert_ieee_float32()
    data = json.loads(out.read_text())
    assert data["suggestion"] == suggestion and 1e-6 <= suggestion <= 1.0
    assert len(data["history"]) >= 3


def test_tune_lr_wants_a_card_unless_asked_for_the_cpu(dataset_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tune_lr.main(["-d", str(dataset_root)])


# ------------------------------------------------------------------ model insight
@pytest.mark.parametrize("kw", [
    dict(input_size=(64, 64, 64)),
    dict(input_size=(32, 40, 48), boxes_per_location=3, width_mult=0.5),
    dict(input_size=(96, 96, 96), aspect_ratios={3: [1.0, 2.0], 5: [1.0]}),
], ids=["64", "non_cube_bpl3", "96_two_ratios"])
def test_prior_boxes_equal_jax(tmp_path, kw):
    """The wireframes are equal voxel for voxel: both packages clip the
    same float32 corners and truncate them to voxels."""
    jax_paths = jax_insight.save_prior_boxes(JaxConfig.create(**kw), tmp_path / "jax")
    ours = model_insight.save_prior_boxes(SSD3DConfig.create(**kw), tmp_path / "port")
    assert [p.name for p in ours] == [p.name for p in jax_paths]
    for a, b in zip(ours, jax_paths):
        np.testing.assert_array_equal(load_nifti(a).data, load_nifti(b).data)
        assert load_nifti(a).data.max() > 0


def test_model_insight_cli(tmp_path):
    cfg = SSD3DConfig.create(input_size=SIZE, width_mult=0.25, boxes_per_location=3)
    state = create_train_state(cfg, device="cpu")
    ckpt = save_checkpoint(tmp_path / "ckpt", state, cfg)
    paths = model_insight.main(["priors", "-cp", str(ckpt), "-o", str(tmp_path / "priors")])
    assert sorted(p.name for p in paths) == [f"prior_boxes_layer_{l}.nii.gz" for l in (3, 5, 7)]
    pytest.importorskip("matplotlib")
    model_insight.main(["histograms", "-cp", str(ckpt), "-o", str(tmp_path / "hist")])
    pngs = sorted(p.name for p in (tmp_path / "hist").glob("hist_*.png"))
    assert len(pngs) == len(state.params)
    assert "hist_base_features_0_0_weight.png" in pngs
    with pytest.raises(SystemExit, match="--checkpoint"):
        model_insight.main(["histograms"])


# ------------------------------------------------------------------ stats, plots
def test_box_stats_equal_jax(dataset_root, python_loader):
    jdm = jax_datasets.SyntheticDataModule(dataset_root, n_classes=1, cache=False)
    jdm.setup("fit")
    dm = SyntheticDataModule(dataset_root, n_classes=1, cache=False)
    dm.setup("fit")
    ours, ref = stats_objects.collect_box_stats(dm), jax_stats.collect_box_stats(jdm)
    assert ours == ref and len(ours["volume"]) >= len(dm.trainsubs)


def _metric_files(directory):
    rng = np.random.default_rng(0)
    directory.mkdir(parents=True, exist_ok=True)
    for iou in (0.1, 0.5):
        for sc in (0.1, 0.3, 0.7):
            data = {k: float(rng.uniform()) for k in ("mAP", "precision", "recall")}
            data["f1_score"] = {"1": 0.5, "2": 0.25} if sc == 0.7 else float(rng.uniform())
            data["found_boxes_volumes_per_class"] = (
                {"1": list(rng.uniform(0, 1e-3, 4)), "2": [1e-4]} if iou == 0.5
                else list(rng.uniform(0, 1e-3, 3)))
            data["not_found_boxes_volumes_per_class"] = list(rng.uniform(0, 1e-3, 2))
            name = f"metrics_(min_IoU={iou}_min_score={sc}).json"
            (directory / name).write_text(json.dumps(data))
    (directory / "metrics_other.json").write_text("{}")
    (directory / "aa_metrics_per_subject_(min_IoU=0.5).json").write_text("{}")
    return directory


def test_metric_grid_and_volume_lists_equal_jax(tmp_path):
    d = _metric_files(tmp_path / "m")
    ours, ref = plots.load_metric_grid(d), jax_plots.load_metric_grid(d)
    assert ours == ref and sorted(ours) == ["f1_score", "mAP", "precision", "recall"]
    assert len(ours["mAP"]) == 6 and len(ours["f1_score"]) == 4
    for path in sorted(d.glob("metrics_(*.json")):
        data = json.loads(path.read_text())
        assert plots._volume_lists(data) == jax_plots._volume_lists(data)
    assert plots._volume_lists({}) == jax_plots._volume_lists({}) == ([], [])


def _quality_stats():
    spec = importlib.util.spec_from_file_location("quality_stats",
                                                  REPO / "tools" / "quality_stats.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_reduced_alike(ours, ref):
    """tools/quality_stats.py rounds the maxima to 4 digits; the port keeps them."""
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert (ours[key] if key.endswith("_at_score") else round(ours[key], 4)) == value, key


def test_operating_points_reduce_as_quality_stats(tmp_path):
    d = _metric_files(tmp_path / "m")
    ours = plots.operating_points(d)
    _assert_reduced_alike(ours, _quality_stats().reduce_run(d))
    assert ours["best_f1@0.5_at_score"] in (0.1, 0.3, 0.7) and len(ours) == 8


@pytest.mark.parametrize("run", sorted(p.name for p in (REPO / "quality_artifacts" / "seeds_4k")
                                       .iterdir() if p.is_dir()))
def test_operating_points_of_the_jax_runs(run):
    """The JAX package's committed 4k seeds reduce alike through both."""
    d = REPO / "quality_artifacts" / "seeds_4k" / run
    _assert_reduced_alike(plots.operating_points(d), _quality_stats().reduce_run(d))


def test_recipe_is_the_campaigns():
    """cli/recipe.py against tools/quality_r5_campaign.sh and the dataset
    command of quality_artifacts/README.md."""
    campaign = (REPO / "tools" / "quality_r5_campaign.sh").read_text()
    flags = shlex.split(re.search(r'^RECIPE="(.*)"$', campaign, re.M)[1])
    assert flags[:2] == ["-d", "$DATA"] and flags[-2:] == ["-ld", "$LOGS"]
    assert flags[2:-2] == recipe.TRAIN_FLAGS
    assert f"-mi {recipe.STEPS}" in campaign
    predict = shlex.split(re.search(r"cli\.predict (.*?)\|\|", campaign, re.S)[1]
                          .replace("\\\n", " "))
    assert " ".join(recipe.PREDICT_FLAGS) in " ".join(predict)
    ious = re.search(r"for iou in ([\d. ]+);", campaign)[1].split()
    scores = re.search(r"for sc in ([\d. ]+);", campaign)[1].split()
    assert recipe.EVAL_GRID == tuple((float(i), float(s)) for i in ious for s in scores)
    readme = " ".join((REPO / "quality_artifacts" / "README.md").read_text().split())
    d = recipe.DATA
    assert (f"--num_images {d['num_images']} --image_size {' '.join(map(str, d['image_size']))} "
            f"--object_size {' '.join(map(str, d['object_size']))} --num_objects "
            f"{' '.join(map(str, d['num_objects']))} --random_seed {d['seed']}") in readme


def test_evaluate_grid_writes_every_point(dataset_root, tmp_path):
    """cli.eval at the recipe's ten points on a predict run of the port."""
    from mslesions3d_tpu_torch.cli import predict

    ckpt = save_checkpoint(tmp_path / "ckpt", create_train_state(SSD3DConfig.create(**TINY),
                                                                  device="cpu"),
                           SSD3DConfig.create(**TINY), {"avg_val_loss": 1.0})
    predict.main(["-d", str(dataset_root), "-m", str(ckpt), "-o", str(tmp_path / "p"),
                  *recipe.PREDICT_FLAGS, "-si", "0", "--device", "cpu"])
    recipe.evaluate_grid(dataset_root, tmp_path / "p")
    run = tmp_path / "p" / "validation_set" / "min_score_0.0"
    assert len(list(plots.metric_files(run))) == len(recipe.EVAL_GRID) == 10
    points = plots.operating_points(run)
    assert sorted(points) == sorted(f"{m}@{iou}{s}" for m in ("mAP", "best_f1")
                                    for iou in (0.1, 0.5) for s in ("", "_at_score"))


def test_plots_cli(tmp_path):
    for pkg in ("matplotlib", "seaborn", "pandas", "scipy"):
        pytest.importorskip(pkg)
    d = _metric_files(tmp_path / "m")
    plots.main(["-pd", str(d), "-o", str(tmp_path / "out")])
    names = sorted(p.name for p in (tmp_path / "out").glob("*.png"))
    assert names == ["boxplot_found_volumes.png", "heatmap_f1_score.png", "heatmap_mAP.png",
                     "heatmap_precision.png", "heatmap_recall.png"]
    with pytest.raises(SystemExit, match="no metrics"):
        plots.main(["-pd", str(tmp_path / "empty")])


def test_stats_objects_cli(dataset_root, tmp_path):
    pytest.importorskip("matplotlib")
    stats = stats_objects.main(["-d", str(dataset_root), "-o", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.glob("*.png")) == [
        f"boxes_{k}.png" for k in sorted(stats)]


@pytest.mark.parametrize("call", [
    lambda tmp: model_insight.parameter_histograms(tmp, tmp),
    lambda tmp: stats_objects.main(["-d", str(tmp)]),
    lambda tmp: plots.plot_metric({"mAP": {(0.1, 0.1): 0.5}}, "mAP", tmp),
], ids=["histograms", "stats_objects", "plots"])
def test_plotting_without_matplotlib_names_it(call, tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="'matplotlib' package"):
        call(tmp_path)


# ------------------------------------------------------------------ flags
@pytest.mark.parametrize("ours,ref_main,dropped", [
    (tune_lr.build_parser, jax_tune.main, "--device"),
    (import_torch.build_parser, jax_import_cli.main, "--device"),
    (model_insight.build_parser, jax_insight.main, None),
    (stats_objects.build_parser, jax_stats.main, None),
    (plots.build_parser, jax_plots.main, None),
], ids=["tune_lr", "import_torch", "model_insight", "stats_objects", "plots"])
def test_parsers_take_every_jax_flag(ours, ref_main, dropped, monkeypatch):
    """The JAX CLIs' --platform is --device where the tool runs a model;
    model_insight runs none and takes neither."""
    ref = options(jax_main_parser(ref_main, monkeypatch))
    ref.pop("--platform", None)
    mine = options(ours())
    if dropped:
        assert mine.pop(dropped)[:2] == ("device", "cuda")
    assert mine == ref
    positional = [a.dest for a in ours()._actions if not a.option_strings]
    assert positional == [a.dest for a in jax_main_parser(ref_main, monkeypatch)._actions
                          if not a.option_strings]


def test_ssd3d_schema_is_the_reference_one():
    """Importing needs no renaming: the model's state_dict keys are the
    reference's (stem ``.0`` / ``.1``, blocks ``conv1``/``bn1``/``conv2``/``bn2``,
    heads by ascending layer)."""
    keys = list(SSD3D(SSD3DConfig.create(**IMPORT_CFG)).state_dict())
    assert "base.features.0.0.weight" in keys and "base.features.7.bn2.running_var" in keys
    assert "pred_convs.cl_convs.2.bias" in keys and "rescale_factors" in keys
