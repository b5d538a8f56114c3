"""The PyTorch port against the JAX package: box geometry, priors, config,
and the port's rules (no JAX import, entry points default to the card).

Inputs are made with numpy from a seed and go through both packages.
"""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.models import model_priors as jax_model_priors
from mslesions3d_tpu.models.priors import priors_per_feature_map as jax_priors_per_map
from mslesions3d_tpu.ops import boxes as jax_boxes
from mslesions3d_tpu_torch.models.priors import priors_per_feature_map
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig, model_priors
from mslesions3d_tpu_torch.ops import boxes

REPO = Path(__file__).resolve().parents[1]


def _center_boxes(rng, shape):
    centers = rng.uniform(0.2, 0.8, size=(*shape, 3))
    sizes = rng.uniform(0.02, 0.3, size=(*shape, 3))
    return np.concatenate([centers, sizes], -1).astype(np.float32)


def _corner_boxes(rng, shape):
    lo = rng.uniform(0.0, 0.7, size=(*shape, 3))
    hi = lo + rng.uniform(0.01, 0.3, size=(*shape, 3))
    return np.concatenate([lo, hi], -1).astype(np.float32)


def _box_cases():
    rng = np.random.default_rng(0)
    cwhd, priors = _center_boxes(rng, (4, 50)), _center_boxes(rng, (50,))
    offsets = rng.normal(0, 1, size=(4, 50, 6)).astype(np.float32)
    a, b = _corner_boxes(rng, (3, 40)), _corner_boxes(rng, (3, 30))
    return {
        "center_to_corner": ((cwhd,), {}),
        "corner_to_center": ((a,), {}),
        "encode_boxes": ((cwhd, priors), {}),
        "decode_boxes": ((offsets, priors), {}),
        "box_volume": ((a,), {}),
        "pairwise_intersection": ((a, b), {}),
        "pairwise_iou": ((a, b), {}),
    }


@pytest.mark.parametrize("name", list(_box_cases()))
def test_box_function_matches_jax(name):
    """rtol 1e-6: both sides run the same float32 elementwise formula, so
    they agree to an ulp or two (exp/log may round differently by one ulp);
    atol 1e-7 covers log-ratios that land near 0."""
    args, _ = _box_cases()[name]
    ours = getattr(boxes, name)(*(torch.from_numpy(a) for a in args))
    ref = getattr(jax_boxes, name)(*(jnp.asarray(a) for a in args))
    assert tuple(ours.shape) == tuple(ref.shape)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("width", [1.0, 0.25])
@pytest.mark.parametrize("size,expected", [(32, 146), (64, 1168), (96, 3942)])
def test_priors_equal_jax(size, expected, width):
    kw = dict(input_size=(size,) * 3, width_mult=width)
    ours = model_priors(SSD3DConfig.create(**kw))
    ref = jax_model_priors(JaxConfig.create(**kw))
    assert ours.shape == (expected, 6)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_priors_per_feature_map_equal_jax():
    """Non-cube maps exercise the swapped-center quirk."""
    dims = {3: (6, 4, 5), 5: (3, 2, 3)}
    scales = {3: 0.1, 5: 0.3}
    ratios = {3: [1.0, 2.0], 5: [1.0]}
    ours = priors_per_feature_map(dims, scales, ratios, boxes_per_location=3)
    ref = jax_priors_per_map(dims, scales, ratios, boxes_per_location=3)
    assert sorted(ours) == sorted(ref)
    for layer in ref:
        np.testing.assert_array_equal(ours[layer], ref[layer])


CONFIGS = {
    "default": {},
    "headline": dict(input_size=(96, 96, 96), dtype="bfloat16", min_score=0.5, top_k=100),
    "custom": dict(input_size=(48, 64, 64), threshold=(0.1, 0.2), width_mult=0.5,
                   aspect_ratios={3: (1.0, 2.0), 5: (1.0,)}, scales={3: 0.1, 5: 0.25},
                   boxes_per_location=3, use_pallas=True, remat=True, comments="x"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_json_round_trips_with_jax(name):
    kw = CONFIGS[name]
    jax_cfg, ours = JaxConfig.create(**kw), SSD3DConfig.create(**kw)
    jax_json = json.loads(json.dumps(jax_cfg.to_json_dict()))
    assert ours.to_json_dict() == jax_cfg.to_json_dict()
    assert SSD3DConfig.from_json_dict(jax_json) == ours
    assert JaxConfig.from_json_dict(json.loads(json.dumps(ours.to_json_dict()))) == jax_cfg
    assert ours.feature_layers == jax_cfg.feature_layers
    assert ours.scales_dict == jax_cfg.scales_dict
    assert ours.compute_dtype == (torch.bfloat16 if ours.dtype == "bfloat16" else torch.float32)


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sklearn", "msgpack", "mslesions3d_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    scripts = [REPO / "chip_smoke.py", REPO / "trained_check.py"]
    files = sorted((REPO / "mslesions3d_tpu_torch").rglob("*.py")) + scripts
    assert len(files) > 10
    scanned = {str(f.relative_to(REPO / "mslesions3d_tpu_torch")) for f in files[:-2]}
    assert {"data/nifti.py", "data/generate.py", "data/boxes_from_seg.py", "data/transforms.py",
            "data/datasets.py", "data/prefetch.py", "train/checkpoints.py", "train/logging.py",
            "train/loop.py", "cli/train.py", "utils/prefetch.py", "cli/predict.py",
            "cli/eval.py", "train/torch_import.py", "cli/import_torch.py", "cli/tune_lr.py",
            "cli/model_insight.py", "cli/stats_objects.py", "cli/plots.py",
            "cli/recipe.py", "data/patches.py", "sliding_window.py",
            "ops/connected_components.py", "models/convnet.py", "models/layers.py",
            "serving.py", "quant.py", "kernels/qconv.py", "cli/export.py",
            "cli/serve.py"} <= scanned
    offenders = {
        str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files
    }
    assert {f: bad for f, bad in offenders.items() if bad} == {}


OPTIONAL = {"matplotlib", "seaborn", "pandas"}


def test_port_imports_plotting_packages_only_where_it_draws():
    """The card's machine has no matplotlib, seaborn or pandas: no module
    of the port imports them at its top level."""
    files = sorted((REPO / "mslesions3d_tpu_torch").rglob("*.py"))
    top = {}
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        names = set()
        for node in tree.body:
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names.add(node.module.split(".")[0])
        top[str(f.relative_to(REPO))] = sorted(names & OPTIONAL)
    assert {f: bad for f, bad in top.items() if bad} == {}


def test_detector_defaults_to_the_card():
    from mslesions3d_tpu_torch.serving import Detector

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the behaviour without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(SSD3DConfig.create(input_size=(32, 32, 32)))
    from mslesions3d_tpu_torch.cli import export as export_cli

    with pytest.raises(RuntimeError, match="no CUDA device"):  # before the checkpoint is read
        export_cli.main(["-m", "no_checkpoint", "-o", "no_bundle.mslx"])


def test_serving_entry_points_default_to_the_card():
    """ServingDetector and the export and serve CLIs take ``cuda`` unless
    asked for the CPU (the behaviour without a card is held in
    tests/test_torch_port_cli_serving.py and test_torch_port_serving_bundle.py)."""
    import inspect

    from mslesions3d_tpu_torch import quant
    from mslesions3d_tpu_torch.cli import export as export_cli
    from mslesions3d_tpu_torch.cli import serve as serve_cli
    from mslesions3d_tpu_torch.serving import (ServingDetector, export_detector,
                                               export_sliding_window_detector)

    for fn in (ServingDetector, quant.quantize_ssd3d, quant.make_quantized_detection_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for fn in (export_detector, export_sliding_window_detector):
        assert inspect.signature(fn).parameters["platforms"].default == ("cuda",), fn
    for cli in (export_cli, serve_cli):
        argv = ["-m", "x", "-o", "y"] if cli is export_cli else ["-m", "x"]
        assert cli.build_parser().parse_args(argv).device == "cuda"


def test_pallas_flags_keep_the_state_dict():
    """use_pallas / use_pallas_tail change the compute path only: the model
    builds with each flag and has the same state_dict keys and shapes."""
    from mslesions3d_tpu_torch.models.ssd3d import SSD3D

    def schema(**flags):
        model = SSD3D(SSD3DConfig.create(input_size=(32, 32, 32), **flags))
        return {k: tuple(v.shape) for k, v in model.state_dict().items()}

    plain = schema()
    for flags in ({"use_pallas": True}, {"use_pallas_tail": True},
                  {"use_pallas": True, "use_pallas_tail": True}):
        assert schema(**flags) == plain
