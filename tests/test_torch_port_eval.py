"""The port's eval CLI against the JAX package's, on the same prediction
directory: a seeded 24^3 synthetic dataset (one class, and two), predicted
by the port's ``cli.predict --device cpu`` at min_score 0.0 with random
weights of width 0.25, then scored by both packages' ``cli.eval`` over IoU
{0.1, 0.5} x min_score {0.0, 0.1, 0.3, 0.5}. Both are host numpy over the
same JSON files, so the metric files are equal byte for byte.
"""

import argparse
import json
import shutil

import numpy as np
import pytest

from mslesions3d_tpu.cli import eval as jax_eval
from mslesions3d_tpu_torch.cli import eval as port_eval
from mslesions3d_tpu_torch.cli import predict
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.train import create_train_state, save_checkpoint

SIZE = (24, 24, 24)


class _Parsed(Exception):
    pass


def jax_main_parser(main, monkeypatch):
    """The parser a JAX CLI's ``main`` builds (stopped at parse_args)."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return seen["parser"]


def options(parser):
    return {opt: (a.dest, a.default, a.nargs, a.type, a.choices)
            for a in parser._actions for opt in a.option_strings if opt not in ("-h", "--help")}


@pytest.fixture(scope="module", params=[1, 2], ids=["one_class", "two_classes"])
def prediction_dir(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"eval{n}")
    data = tmp / "data"
    generate_dataset(data, num_images=10, n_classes=n, image_size=SIZE, object_size=(6, 10),
                     num_objects=(1, 3), seed=n)
    cfg = SSD3DConfig.create(n_classes=n + 1, input_channels=1, input_size=SIZE,
                             width_mult=0.25, top_k=10)
    ckpt = save_checkpoint(tmp / "ckpt", create_train_state(cfg, seed=n, device="cpu"), cfg)
    predict.main(["-d", str(data), "-m", str(ckpt), "-o", str(tmp / "preds"), "-ps", "all",
                  "-sc", "0.0", "-k", "10", "-c", str(n), "-si", "0", "--device", "cpu"])
    return {"data": data, "preds": tmp / "preds", "n": n}


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("subset", ["train", "validation"])
def test_metric_files_equal_jax(prediction_dir, tmp_path, subset):
    dirs = {k: _copy(prediction_dir["preds"], tmp_path / k) for k in ("jax", "port")}
    n = str(prediction_dir["n"])
    for iou in (0.1, 0.5):
        for sc in (0.0, 0.1, 0.3, 0.5):
            for k, mod in (("jax", jax_eval), ("port", port_eval)):
                mod.main(["-d", str(prediction_dir["data"]), "-pd", str(dirs[k]), "-ps", subset,
                          "-sc", str(sc), "-iou", str(iou), "-c", n])
    written = {k: sorted((d / f"{subset}_set" / "min_score_0.0").glob("metrics_*.json"))
               for k, d in dirs.items()}
    assert len(written["jax"]) == 8
    assert [p.name for p in written["port"]] == [p.name for p in written["jax"]]
    for ours, ref in zip(written["port"], written["jax"]):
        assert ours.read_bytes() == ref.read_bytes(), ours.name
        data = json.loads(ours.read_text())
        assert {"mAP", "precision", "recall", "f1_score"} <= set(data)


def test_evaluate_returns_the_written_metrics(prediction_dir, tmp_path):
    pd = _copy(prediction_dir["preds"], tmp_path / "p")
    n = prediction_dir["n"]
    kw = dict(predict_subset="validation", n_classes=n, confidence_threshold=0.2, min_iou=0.1)
    ours = port_eval.evaluate(pd, prediction_dir["data"], **kw)
    ref = jax_eval.evaluate(pd, prediction_dir["data"], **kw)
    assert json.dumps(ours) == json.dumps(ref)
    path = pd / "validation_set" / "min_score_0.0" / "metrics_(min_IoU=0.1_min_score=0.2).json"
    assert json.loads(path.read_text()) == ours


@pytest.mark.parametrize("threshold", [0.0, 0.25, 0.9])
def test_retrieve_boxes_equal_jax(prediction_dir, threshold):
    run = prediction_dir["preds"] / "train_set" / "min_score_0.0"
    for path in sorted(run.glob("sub-*_preds.json")):
        subject = path.name.removeprefix("sub-").removesuffix("_preds.json")
        ours = port_eval.retrieve_boxes(run, subject, threshold)
        ref = jax_eval.retrieve_boxes(run, subject, threshold)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_min_score_0_run_is_required(prediction_dir, tmp_path):
    for mod in (jax_eval, port_eval):
        with pytest.raises(FileNotFoundError, match="min_score=0.0"):
            mod.evaluate(tmp_path / "nothing", prediction_dir["data"], n_classes=prediction_dir["n"])


def test_parser_takes_every_jax_flag(monkeypatch):
    ref = options(jax_main_parser(jax_eval.main, monkeypatch))
    assert options(port_eval.build_parser()) == ref
