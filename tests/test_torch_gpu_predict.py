"""The predict CLI on the card, with K1 held against the plain NMS.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_predict.py

A 6-image 32^3 synthetic dataset and a width-0.25 model of random weights
from seed 0, float32, TF32 off. ``predict_dataset`` on the card launches K1
once a predict batch (batch 1: once a subject), and every subject's
detections equal the plain NMS's on the locs and scores the card's forward
gave (taken by a forward hook), array for array. ``cli.predict --device
cuda`` writes every per-subject file and both per-subject metric files.
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.cli import predict
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.kernels.nms import greedy_nms, greedy_nms_cuda
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.ops.nms import detections_to_lists, nms_candidates, select_detections
from mslesions3d_tpu_torch.train import create_train_state, save_checkpoint

pytestmark = pytest.mark.gpu

CFG = dict(n_classes=2, input_channels=1, input_size=(32, 32, 32), width_mult=0.25, top_k=10)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _setup(tmp_path):
    generate_dataset(tmp_path / "data", num_images=6, n_classes=1, image_size=CFG["input_size"],
                     object_size=(6, 12), num_objects=(1, 3), seed=5)
    cfg = SSD3DConfig.create(**CFG)
    ckpt = save_checkpoint(tmp_path / "ckpt", create_train_state(cfg, seed=0, device="cpu"), cfg)
    return tmp_path / "data", ckpt


@pytest.mark.parametrize("min_score", [0.0, 0.5])
def test_predict_dataset_k1_equals_plain_nms(tmp_path, no_tf32, min_score):
    _need_card()
    data, ckpt = _setup(tmp_path)
    config, state = predict.load_predict_state(ckpt, "cuda")
    dm = SyntheticDataModule(data, n_classes=1, batch_size=1)
    dm.setup("predict")
    outs = []
    handle = torch.nn.modules.module.register_module_forward_hook(
        lambda m, args, out: outs.append(tuple(t.detach() for t in out))
        if isinstance(m, SSD3D) else None)
    greedy_nms_cuda.launches = 0
    try:
        results, gt = predict.predict_dataset(dm, state, config, "all", min_score=min_score,
                                              top_k=10, output_dir=tmp_path / "out")
    finally:
        handle.remove()
    assert greedy_nms_cuda.launches == len(outs) == len(dm.subjects_list) == 6
    priors = torch.from_numpy(model_priors(config)).cuda()
    kw = dict(n_classes=config.n_classes, top_k=10)
    for subj, (locs, scores) in zip(dm.subjects_list, outs):
        boxes, cscores, valid = nms_candidates(locs, scores, priors, min_score=min_score, **kw)
        plain = select_detections(boxes, cscores, greedy_nms(boxes, valid, config.max_overlap),
                                  **kw)
        for ours, ref in zip(results[subj], detections_to_lists(plain)):
            np.testing.assert_array_equal(ours, ref[0])
        assert (tmp_path / "out" / f"sub-{subj}_preds.json").exists()


def test_predict_cli_on_the_card(tmp_path, no_tf32):
    _need_card()
    data, ckpt = _setup(tmp_path)
    greedy_nms_cuda.launches = 0
    assert predict.main(["-d", str(data), "-m", str(ckpt), "-o", str(tmp_path / "p"),
                         "-ps", "validation", "-sc", "0.0", "-k", "10",
                         "--device", "cuda"]) == 0
    out = tmp_path / "p" / "validation_set" / "min_score_0.0"
    subjects = sorted(p.name for p in out.glob("sub-*_preds.json"))
    assert len(subjects) == greedy_nms_cuda.launches > 0
    for name in subjects:
        stem = name.removesuffix(".json")
        assert (out / f"{stem}.csv").exists() and (out / f"{stem}.nii.gz").exists()
    for iou in (0.5, 0.1):
        assert (out / f"aa_metrics_per_subject_(min_IoU={iou}).json").exists()
