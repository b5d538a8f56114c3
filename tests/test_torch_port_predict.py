"""The port's predict CLI against the JAX package's.

- ``save_subject_predictions`` of both packages on the same numpy boxes,
  labels and scores: the CSV and JSON byte for byte, the NIfTI arrays
  equal, the ``_origspace`` pair included (a BIDS sample with recorded
  ``transform_meta``).
- End to end: JAX ``cli.predict.main`` on a JAX checkpoint against the
  port's ``cli.predict.main --device cpu`` on the same weights (carried by
  ``weights.from_jax_variables`` into a port checkpoint), over the train
  subjects of a seeded 32^3 synthetic dataset at width 0.25. As in
  ``tests/test_torch_port_slice.py``, the classification heads' kernels are
  scaled on both sides, and a guard asserts that every decision the saved
  detections hang on is further than the forward's tolerance (1e-4) from
  its threshold, so equal counts are a real comparison. Two cases:
  * "strict": x10, weights of seed 3, ``-sc 0.0 -k 2`` (K = 20 candidates
    of the 146 priors). All K + 1 top scores are more than 1e-4 apart, so
    the detections must come in the same order.
  * "recipe": the slice test's x30, weights of seed 1 and the recipe's
    ``-k 100`` (K = all 146 priors) at ``-sc 0.5``, which leaves 68-70
    detections a subject. The scores crowd (neighbours as close as 6e-7),
    so near-tied detections may swap places: within a run of scores less
    than 1e-4 apart the detections are matched as a set. The guard: every
    score is more than 1e-4 from min_score, the top_k cut falls between
    scores more than 1e-4 apart, and no pair of valid candidates has an
    IoU within 1e-3 of max_overlap (these random weights overlap none, so
    the NMS suppresses nothing; tests/test_torch_port_nms.py covers it).
  Per subject the counts are equal and the boxes and scores within 1e-4;
  the ``aa_metrics_per_subject`` files agree within the same tolerance.
- Sliding window: a 16^3 checkpoint on 24x28x20 volumes, JAX's ``-sw 1``
  against the port's ``-sw 1`` and ``-sw 1 -vb 4``, matched as above
  (the strict case's weights, x10, at ``-sc 0.5 -k 100``: no cut falls on a
  near tie, see tests/test_torch_port_sliding_window.py); the port's
  ``-vb 4`` files byte-equal to its ``-sw 1`` files, and so are its
  ``-sw 1 --sw_data_parallel 1`` files, over the one CPU and with the
  visible devices set to two CPU shards.
- The parser takes every JAX flag (``--platform`` is ``--device``), a
  volume of another size than
  the checkpoint's input says to run ``-sw 1``, and the CLI wants a card
  unless given ``--device cpu``.
"""

import csv
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mslesions3d_tpu.cli import predict as jax_predict
from mslesions3d_tpu.data.generate import generate_dataset
from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from mslesions3d_tpu.train.state import create_train_state as jax_create_train_state
from mslesions3d_tpu_torch.cli import predict
from mslesions3d_tpu_torch.data.datasets import LesionsDataModule, SyntheticDataModule
from mslesions3d_tpu_torch.data.nifti import load_nifti
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.ops.boxes import pairwise_iou
from mslesions3d_tpu_torch.ops.nms import nms_candidates
from mslesions3d_tpu_torch.train import create_train_state, save_checkpoint
from mslesions3d_tpu_torch.train.steps import _cast
from mslesions3d_tpu_torch.weights import from_jax_variables
from test_lesions_datamodule import make_bids_tree
from test_torch_port_forward import INPUT, randomized_variables

CONFIG = dict(n_classes=2, input_channels=1, input_size=INPUT, width_mult=0.25,
              min_score=0.5, max_overlap=0.5, top_k=2)
TOL = 1e-4  # the forward's tolerance (test_torch_port_forward.py)
IOU_MARGIN = 1e-3  # an IoU of boxes 1e-4 apart moves by a few 1e-4 at these sizes
CASES = {
    "strict": dict(cls_scale=10.0, seed=3, min_score=0.0, top_k=2),
    "recipe": dict(cls_scale=30.0, seed=1, min_score=0.5, top_k=100),
}


def _options(parser):
    return {opt: (a.dest, a.default, a.nargs, a.type, a.choices)
            for a in parser._actions for opt in a.option_strings if opt not in ("-h", "--help")}


def _detections(rng, n, image_shape):
    lo = rng.uniform(0.0, 0.7, size=(n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.02, 0.3, size=(n, 3))], -1)
    boxes[0] = (-0.05, 0.1, 0.2, 0.4, 1.1, 0.5)  # outside [0, 1]: clipped in the voxel box
    labels = rng.integers(0, 3, size=n)
    scores = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    scores[:4] = (0.5, 1e-7, 0.0, 0.999999)
    return boxes.astype(np.float32), labels, scores


def _write_both(tmp_path, subject, image_shape, boxes, labels, scores, **kw):
    out = {}
    for name, fn in (("jax", jax_predict.save_subject_predictions),
                     ("port", predict.save_subject_predictions)):
        out[name] = tmp_path / name
        fn(out[name], subject, image_shape, boxes, labels, scores, **kw)
    return out


def _assert_same_files(dirs, expected):
    jax_dir, port_dir = dirs["jax"], dirs["port"]
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir()) == sorted(expected)
    for name in names:
        a, b = jax_dir / name, port_dir / name
        if name.endswith(".nii.gz"):
            ja, pa = load_nifti(a), load_nifti(b)
            np.testing.assert_array_equal(pa.data, ja.data)
            np.testing.assert_array_equal(pa.affine, ja.affine)
        else:
            assert b.read_bytes() == a.read_bytes(), name


@pytest.mark.parametrize("n,min_score", [(12, 0.5), (30, 0.0), (5, 1.1), (0, 0.5)])
def test_subject_files_equal_jax(tmp_path, n, min_score):
    """(5, 1.1): nothing passes, an empty JSON and wireframe; (0, ...): a
    subject with no detection at all, the CSV's header alone."""
    rng = np.random.default_rng(n)
    shape = (24, 28, 20)
    boxes, labels, scores = _detections(rng, max(n, 4), shape)
    boxes, labels, scores = boxes[:n], labels[:n], scores[:n]
    affine = np.diag([1.5, 1.0, 2.0, 1.0])
    dirs = _write_both(tmp_path, "0007", shape, boxes, labels, scores, affine=affine,
                       min_score=min_score)
    _assert_same_files(dirs, [f"sub-0007_preds.{e}" for e in ("csv", "json", "nii.gz")])
    # pandas' frame, read back: the table the reference's consumers read
    with open(dirs["port"] / "sub-0007_preds.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "label_id", "score"] and len(rows) == n + 1


def test_scores_csv_is_what_pandas_writes(tmp_path):
    pd = pytest.importorskip("pandas")
    values = [0.0, 1.0, 0.5, 1e-7, 1e-5, 0.1, 1 / 3, 123456.789, 1e16, 2.5e-300,
              float(np.float32(0.7)), float(np.nextafter(np.float32(1), np.float32(0)))]
    table = [(j + 1, v) for j, v in enumerate(values)]
    predict.write_scores_csv(tmp_path / "ours.csv", table)
    pd.DataFrame(table, columns=["label_id", "score"]).to_csv(tmp_path / "pandas.csv")
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_origspace_files_equal_jax(tmp_path):
    """A BIDS sample with recorded transform_meta (orientation, spacing,
    foreground crop, pad) gets the original-space JSON and wireframe too."""
    root = make_bids_tree(tmp_path / "bids", subjects=("001", "002", "003"))
    dm = LesionsDataModule(data_dir=root, centers=("CHUV_RIM_OK",), batch_size=1,
                           spatial_size=(40, 44, 44))
    dm.setup("predict")
    subject = dm.subjects_list[0]
    sample = dm.get_sample(subject)
    assert sample["transform_meta"] and sample["orig_shape"] is not None
    shape = sample["img"].shape[:3]
    rng = np.random.default_rng(3)
    boxes, labels, scores = _detections(rng, 10, shape)
    labels[:] = 1
    boxes[1] = (0.5, 0.5, 0.5, 0.5, 0.6, 0.6)  # degenerate in the original grid
    dirs = _write_both(tmp_path, subject, shape, boxes, labels, scores,
                       affine=sample["affine"], min_score=0.3,
                       transform_meta=sample["transform_meta"],
                       orig_shape=sample["orig_shape"], orig_affine=sample["orig_affine"])
    stem = f"sub-{predict.subject_id(subject)}_preds"
    _assert_same_files(dirs, [f"{stem}.csv", f"{stem}.json", f"{stem}.nii.gz",
                              f"{stem}_origspace.json", f"{stem}_origspace.nii.gz"])


# ------------------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    data = tmp_path_factory.mktemp("predict_data") / "data"
    generate_dataset(data, num_images=8, n_classes=1, image_size=INPUT, object_size=(6, 12),
                     num_objects=(1, 3), seed=4)
    return data


@pytest.fixture(scope="module", params=sorted(CASES))
def predicted(request, dataset, tmp_path_factory):
    """One set of weights, JAX's and the port's predict CLIs on ``dataset``."""
    case = CASES[request.param]
    tmp = tmp_path_factory.mktemp(f"predict_{request.param}")
    data = dataset
    _, params, batch_stats = randomized_variables(CONFIG, seed=case["seed"])
    for name, head in params["heads"].items():
        if name.startswith("cls_"):
            head["kernel"] = head["kernel"] * np.float32(case["cls_scale"])
    jcfg, cfg = JaxConfig.create(**CONFIG), SSD3DConfig.create(**CONFIG)
    jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree_util.tree_map(np.asarray, params),
                            batch_stats=jax.tree_util.tree_map(np.asarray, batch_stats))
    jax_ckpt = jax_save_checkpoint(tmp / "jax_ckpt", jstate, jcfg, {"avg_val_loss": 1.0})
    state = create_train_state(cfg, device="cpu",
                               state_dict=from_jax_variables(params, batch_stats, cfg))
    port_ckpt = save_checkpoint(tmp / "port_ckpt", state, cfg, {"avg_val_loss": 1.0})

    args = ["-d", str(data), "-ps", "train", "-sc", str(case["min_score"]),
            "-k", str(case["top_k"])]
    with pytest.MonkeyPatch.context() as mp:  # the JAX module reads with the Python loader
        def no_native(*a, **k):
            raise OSError("native loader off for the comparison")

        mp.setattr("mslesions3d_tpu.native.load_nifti_fast", no_native)
        assert jax_predict.main([*args, "-m", str(jax_ckpt), "-o", str(tmp / "jax")]) == 0
    assert predict.main([*args, "-m", str(port_ckpt), "-o", str(tmp / "port"),
                         "--device", "cpu"]) == 0
    sub = Path("train_set") / f"min_score_{float(case['min_score'])}"
    return {"jax": tmp / "jax" / sub, "port": tmp / "port" / sub, "data": data, "cfg": cfg,
            "state": state, "out": tmp, "name": request.param, **case}


def test_guard_scores_are_separated(predicted):
    """Every decision the saved detections hang on is further than the
    tolerance from its threshold (the module docstring lists them)."""
    cfg, state, top_k = predicted["cfg"], predicted["state"], predicted["top_k"]
    min_score = predicted["min_score"]
    dm = SyntheticDataModule(predicted["data"], n_classes=1, batch_size=8)
    dm.setup("predict")
    model = SSD3D(cfg).eval()
    batch = next(dm.predict_batches("train"))
    with torch.no_grad():
        locs, scores = torch.func.functional_call(
            model, (_cast(model, state.params), state.batch_stats),
            (torch.from_numpy(batch["image"]),))
    probs = torch.softmax(scores, -1)[..., 1].numpy()[batch["batch_mask"]]
    n_priors = model_priors(cfg).shape[0]
    k = min(10 * top_k, n_priors)
    boxes, cand, valid = nms_candidates(locs, scores, torch.from_numpy(model_priors(cfg)),
                                        n_classes=2, min_score=min_score, top_k=top_k)
    counts = []
    for row, b, v in zip(probs, boxes[batch["batch_mask"]], valid[batch["batch_mask"]]):
        top = np.sort(row)[::-1][: k + 1]
        if predicted["name"] == "strict":  # the order is a real comparison too
            assert np.abs(np.diff(top)).min() > TOL
        elif k < n_priors:  # the candidate cut
            assert top[k - 1] - top[k] > TOL
        assert np.abs(top[:k] - min_score).min() > TOL
        iou = pairwise_iou(b[v], b[v]).numpy()
        off = ~np.eye(len(iou), dtype=bool)
        assert np.abs(iou[off] - cfg.max_overlap).min() > IOU_MARGIN
        assert not (iou[off] > cfg.max_overlap).any()  # nothing to suppress
        n_valid = int(v.sum())
        if n_valid > top_k:  # the top_k cut
            assert top[top_k - 1] - top[top_k] > TOL
        counts.append(min(n_valid, top_k))
    if predicted["name"] == "recipe":
        assert min(counts) < max(counts) < top_k  # counts that differ, under the cut


def _tie_runs(scores):
    """Index runs of a descending score list whose neighbours are <= TOL apart."""
    runs, start = [], 0
    for i in range(1, len(scores) + 1):
        if i == len(scores) or scores[i - 1] - scores[i] > TOL:
            runs.append(range(start, i))
            start = i
    return runs


def _same_detection(a, b):
    (af, av, al, as_), (bf, bv, bl, bs) = a, b
    return (np.abs(np.subtract(af, bf)).max() <= TOL and al == bl and abs(as_ - bs) <= TOL
            and np.abs(np.subtract(av, bv)).max() <= 1)  # voxel corners: a truncation apart


def test_predict_detections_match_jax(predicted):
    jax_dir, port_dir = predicted["jax"], predicted["port"]
    subjects = sorted(p.name for p in jax_dir.glob("sub-*_preds.json"))
    assert len(subjects) == 6
    assert subjects == sorted(p.name for p in port_dir.glob("sub-*_preds.json"))
    for name in subjects:
        ref, ours = (json.loads((d / name).read_text()) for d in (jax_dir, port_dir))
        assert list(ours) == list(ref), name  # the same ids: equal counts
        assert 0 < len(ref) <= predicted["top_k"]
        ids = list(ref)
        runs = _tie_runs([ref[i][3] for i in ids])
        if predicted["name"] == "strict":
            assert len(runs) == len(ids)
        for run in runs:  # within a run of near-tied scores, matched as a set
            left = [ours[ids[i]] for i in run]
            for i in run:
                match = [j for j, o in enumerate(left) if _same_detection(o, ref[ids[i]])]
                assert match, (name, ids[i])
                left.pop(match[0])
        stem = name.removesuffix(".json")
        ref_csv, our_csv = (np.loadtxt(d / f"{stem}.csv", delimiter=",", skiprows=1, ndmin=2)
                            for d in (jax_dir, port_dir))
        np.testing.assert_array_equal(our_csv[:, :2], ref_csv[:, :2])
        np.testing.assert_allclose(np.sort(our_csv[:, 2]), np.sort(ref_csv[:, 2]), atol=TOL)
        assert (port_dir / f"{stem}.nii.gz").exists()


def _assert_tree_close(ours, ref, path=""):
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref), path
        for k in ref:
            _assert_tree_close(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_tree_close(a, b, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert abs(ours - ref) <= TOL, (path, ours, ref)
    else:
        assert ours == ref, path


@pytest.mark.parametrize("iou", [0.5, 0.1])
def test_per_subject_metrics_match_jax(predicted, iou):
    name = f"aa_metrics_per_subject_(min_IoU={iou}).json"
    ref, ours = (json.loads((predicted[k] / name).read_text()) for k in ("jax", "port"))
    assert len(ref) == 6
    _assert_tree_close(ours, ref)


def test_checkpoint_copied_beside_predictions(predicted):
    copied = predicted["out"] / "port" / "port_ckpt"
    assert (copied / "state.pt").exists() and (copied / "meta.json").exists()


def test_prefetch_off_gives_the_same_files(predicted, tmp_path):
    args = ["-d", str(predicted["data"]), "-ps", "train", "-sc", str(predicted["min_score"]),
            "-k", str(predicted["top_k"]), "-m", str(predicted["out"] / "port_ckpt"),
            "-o", str(tmp_path), "--device", "cpu", "--prefetch", "0", "-si", "0"]
    predict.main(args)
    out = tmp_path / predicted["port"].relative_to(predicted["out"] / "port")
    assert not list(out.glob("*.nii.gz"))
    for p in predicted["port"].glob("sub-*_preds.json"):
        assert (out / p.name).read_bytes() == p.read_bytes()


def test_input_size_mismatch_exits(predicted, tmp_path):
    cfg = SSD3DConfig.create(**{**CONFIG, "input_size": (24, 24, 24)})
    state = create_train_state(cfg, device="cpu")
    dm = SyntheticDataModule(predicted["data"], n_classes=1, batch_size=1)
    dm.setup("predict")
    with pytest.raises(SystemExit, match="sliding-window inference: predict -sw 1"):
        predict.predict_dataset(dm, state, cfg, "train", output_dir=tmp_path)


@pytest.fixture
def tf32_on():
    """TF32 on for cuDNN and cuBLAS, as torch starts; restored afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def assert_ieee_float32():
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_predict_scores_float32_without_tf32(predicted, tmp_path, tf32_on):
    """A float32 checkpoint is scored in IEEE float32, as it was trained."""
    predict.main(["-d", str(predicted["data"]), "-ps", "train", "-m",
                  str(predicted["out"] / "port_ckpt"), "-o", str(tmp_path), "-si", "0",
                  "--device", "cpu"])
    assert_ieee_float32()


# ------------------------------------------------------------------ sliding window
SW_VOLUME = (24, 28, 20)
SW_CONFIG = dict(CONFIG, input_size=(16, 16, 16))
SW_ARGS = ["-ps", "train", "-sc", "0.5", "-k", "100", "-sw", "1"]


@pytest.fixture(scope="module")
def sw_predicted(tmp_path_factory):
    """A 16^3 checkpoint (weights of seed 3, classification heads x10) scored
    on 24x28x20 volumes through the sliding window by both CLIs: JAX's
    ``-sw 1``, the port's ``-sw 1`` and ``-sw 1 -vb 4`` (6 subjects: one
    stack of 4 and a padded stack of 2)."""
    tmp = tmp_path_factory.mktemp("predict_sw")
    data = tmp / "data"
    generate_dataset(data, num_images=8, n_classes=1, image_size=SW_VOLUME, object_size=(4, 8),
                     num_objects=(1, 3), seed=6)
    _, params, batch_stats = randomized_variables(SW_CONFIG, seed=3)
    for name, head in params["heads"].items():
        if name.startswith("cls_"):
            head["kernel"] = head["kernel"] * np.float32(10.0)
    jcfg, cfg = JaxConfig.create(**SW_CONFIG), SSD3DConfig.create(**SW_CONFIG)
    jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree_util.tree_map(np.asarray, params),
                            batch_stats=jax.tree_util.tree_map(np.asarray, batch_stats))
    jax_ckpt = jax_save_checkpoint(tmp / "jax_ckpt", jstate, jcfg, {"avg_val_loss": 1.0})
    state = create_train_state(cfg, device="cpu",
                               state_dict=from_jax_variables(params, batch_stats, cfg))
    port_ckpt = save_checkpoint(tmp / "port_ckpt", state, cfg, {"avg_val_loss": 1.0})
    args = ["-d", str(data), *SW_ARGS]
    with pytest.MonkeyPatch.context() as mp:
        def no_native(*a, **k):
            raise OSError("native loader off for the comparison")

        mp.setattr("mslesions3d_tpu.native.load_nifti_fast", no_native)
        assert jax_predict.main([*args, "-m", str(jax_ckpt), "-o", str(tmp / "jax")]) == 0
    runs = (("port", [], None), ("port_vb", ["-vb", "4"], None),
            ("port_dp", ["--sw_data_parallel", "1"], None),
            ("port_dp_two", ["--sw_data_parallel", "1"], ("cpu", "cpu")))
    for name, extra, devices in runs:
        with pytest.MonkeyPatch.context() as mp:
            if devices is not None:
                mp.setattr(predict, "visible_devices", lambda device: devices)
            assert predict.main([*args, *extra, "-m", str(port_ckpt), "-o", str(tmp / name),
                                 "--device", "cpu"]) == 0
    sub = Path("train_set") / "min_score_0.5"
    return {name: tmp / name / sub for name in ("jax", *(r[0] for r in runs))}


@pytest.mark.parametrize("mode", ["port", "port_vb"])
def test_sliding_window_predictions_match_jax(sw_predicted, mode):
    """Per subject: the same ids (equal counts), each detection matched
    within 1e-4 (near-tied scores as a set, as above), the CSVs' ids equal
    and scores within 1e-4, and both metric files within 1e-4. The files
    are not byte-equal: the two frameworks' float32 forwards differ in the
    last bits, which the JSON's printed floats show."""
    jax_dir, port_dir = sw_predicted["jax"], sw_predicted[mode]
    subjects = sorted(p.name for p in jax_dir.glob("sub-*_preds.json"))
    assert len(subjects) == 6
    assert subjects == sorted(p.name for p in port_dir.glob("sub-*_preds.json"))
    for name in subjects:
        ref, ours = (json.loads((d / name).read_text()) for d in (jax_dir, port_dir))
        assert list(ours) == list(ref), name
        assert 0 < len(ref) < 100
        ids = list(ref)
        for run in _tie_runs([ref[i][3] for i in ids]):
            left = [ours[ids[i]] for i in run]
            for i in run:
                match = [j for j, o in enumerate(left) if _same_detection(o, ref[ids[i]])]
                assert match, (name, ids[i])
                left.pop(match[0])
        stem = name.removesuffix(".json")
        ref_csv, our_csv = (np.loadtxt(d / f"{stem}.csv", delimiter=",", skiprows=1, ndmin=2)
                            for d in (jax_dir, port_dir))
        np.testing.assert_array_equal(our_csv[:, :2], ref_csv[:, :2])
        np.testing.assert_allclose(our_csv[:, 2], ref_csv[:, 2], atol=TOL)
    for iou in (0.5, 0.1):
        metrics = f"aa_metrics_per_subject_(min_IoU={iou}).json"
        _assert_tree_close(*(json.loads((d / metrics).read_text())
                             for d in (port_dir, jax_dir)))


def test_volume_batch_files_equal_single_volumes(sw_predicted):
    """``-vb 4`` (a full stack and a padded one) writes the files of
    ``-sw 1`` byte for byte: a volume's detections do not depend on the
    volumes it shares device batches with."""
    single, stacked = sw_predicted["port"], sw_predicted["port_vb"]
    names = sorted(p.name for p in single.iterdir() if p.suffix in (".json", ".csv"))
    assert len(names) == 14
    assert names == sorted(p.name for p in stacked.iterdir() if p.suffix in (".json", ".csv"))
    for name in names:
        assert (stacked / name).read_bytes() == (single / name).read_bytes(), name


@pytest.mark.parametrize("mode", ["port_dp", "port_dp_two"])
def test_sw_data_parallel_files_equal_unsharded(sw_predicted, mode):
    """``--sw_data_parallel 1`` writes the files of ``-sw 1`` byte for byte,
    over the one visible CPU and over two CPU shards of every chunk."""
    single, sharded = sw_predicted["port"], sw_predicted[mode]
    names = sorted(p.name for p in single.iterdir() if p.suffix in (".json", ".csv"))
    assert len(names) == 14
    assert names == sorted(p.name for p in sharded.iterdir() if p.suffix in (".json", ".csv"))
    for name in names:
        assert (sharded / name).read_bytes() == (single / name).read_bytes(), name


# ------------------------------------------------------------------ flags
def test_parser_takes_every_jax_flag():
    ours, ref = _options(predict.build_parser()), _options(jax_predict.build_parser())
    assert ref.pop("--platform")[1] is None
    assert ours.pop("--device")[:2] == ("device", "cuda")
    assert ours == ref


def test_predict_wants_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict.main(["-m", str(tmp_path / "none"), "-o", str(tmp_path)])
