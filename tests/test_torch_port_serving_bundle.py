"""The port's ``.mslx`` bundles against its live paths and against the JAX package's bundles.

The same randomised JAX variables (``randomized_variables``, BN statistics
perturbed) are carried to the port with ``from_jax_variables``; the JAX
package exports and serves its bundle on the CPU (``tests/test_serving.py``
does the same), the port exports ``torch.export`` programs on the CPU, where
K1-K3 are registered ops running their plain versions.

- The port's bundle, loaded on the CPU, equals the port's live
  ``Detector.predict`` bit for bit at batch sizes (1, 2) with requests of 0,
  1, 3 and 5 rows, on the default path and with ``use_pallas`` +
  ``use_pallas_tail`` (32^3 at width 1.0, where both kernels run). No op
  changes its rounding under export.
- The port's bundle agrees with the JAX bundle on the same weights and
  requests: counts and labels equal, boxes and scores within 1e-4;
  detections whose scores lie within 1e-4 of each other are matched as a
  set. The classification heads are scaled (x30, x10 for the sliding
  window) so the scores spread; random weights crowd them.
- The sliding-window bundle (24x28x20 volumes, 16^3 patches, volume batch 1
  and 2) equals the port's live sliding window bit for bit and agrees with
  the JAX sliding-window bundle as above.
- A JAX bundle, and a bundle without a program for the asked device, raise;
  the manifest has the JAX package's keys, ``jax_version`` replaced by
  ``torch_version``, plus ``format`` and ``custom_ops``.
"""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from mslesions3d_tpu import serving as jax_serving
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu_torch import serving
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.sliding_window import make_sliding_window_detector
from mslesions3d_tpu_torch.train import create_train_state
from mslesions3d_tpu_torch.weights import from_jax_variables
from test_torch_port_forward import INPUT, randomized_variables

TOL = 1e-4  # boxes and scores against the JAX bundle, and the near-tie width
BATCHES = (1, 2)
CONFIGS = {
    "default": dict(width_mult=0.25),
    "fused": dict(width_mult=1.0, use_pallas=True, use_pallas_tail=True),
}
VOL = (24, 28, 20)
SW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25,
          min_score=0.5, top_k=100)


def scaled_variables(config, factor, seed=0):
    _, params, stats = randomized_variables(config, seed=seed)
    for name, head in params["heads"].items():
        if name.startswith("cls_"):
            head["kernel"] = head["kernel"] * np.float32(factor)
    return params, stats


def jax_bundle(tmp_path, export, *args, **kw):
    exports, manifest = export(*args, nms_impl="xla", dtype="float32", **kw)
    return jax_serving.save_bundle(tmp_path / "jax.mslx", exports, manifest)


def port_bundle(tmp_path, export, *args, **kw):
    exports, manifest = export(*args, platforms=["cpu"], **kw)
    return serving.save_bundle(tmp_path / "port.mslx", exports, manifest)


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def bundles(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    config = dict(n_classes=2, input_channels=1, input_size=INPUT, min_score=0.5,
                  max_overlap=0.5, top_k=3, **CONFIGS[request.param])
    params, stats = scaled_variables(config, 30.0)
    cfg = SSD3DConfig.create(**config)
    state_dict = from_jax_variables(params, stats, cfg)
    port_path = port_bundle(tmp, serving.export_detector, cfg, state_dict, BATCHES)
    jax_path = jax_bundle(tmp, jax_serving.export_detector, JaxConfig.create(**config),
                          {"params": params, "batch_stats": stats}, BATCHES)
    return {
        "name": request.param, "port_path": port_path, "jax_path": jax_path,
        "served": serving.ServingDetector(port_path, device="cpu"),
        "jax": jax_serving.ServingDetector(jax_path),
        "live": serving.Detector(cfg, state_dict, device="cpu", batch_sizes=BATCHES),
        "x": np.random.default_rng(5).normal(size=(5, *INPUT, 1)).astype(np.float32),
    }


def assert_same_arrays(ours: dict, ref: dict):
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def assert_detections_match(ours: dict, ref: dict, tol: float = TOL):
    """Equal counts; per row, within runs of scores <= tol apart the
    detections match as a set (label equal, box and score within tol); the
    padding past the count is zero in both."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    np.testing.assert_array_equal(ours["count"], ref["count"])
    for v in range(ref["count"].shape[0]):
        n = int(ref["count"][v])
        scores = ref["scores"][v][:n]
        start = 0
        for i in range(1, n + 1):
            if i < n and scores[i - 1] - scores[i] <= tol:
                continue
            left = list(range(start, i))
            for r in range(start, i):
                match = [j for j in left if ours["labels"][v][j] == ref["labels"][v][r]
                         and abs(ours["scores"][v][j] - ref["scores"][v][r]) <= tol
                         and np.abs(ours["boxes"][v][j] - ref["boxes"][v][r]).max() <= tol]
                assert match, (v, r)
                left.remove(match[0])
            start = i
        for k in ("boxes", "labels", "scores"):
            assert not np.asarray(ours[k][v][n:]).any()


@pytest.mark.parametrize("rows", [0, 1, 3, 5])
def test_bundle_equals_live_detector(bundles, rows):
    """Routed as the live Detector routes (3 = 2 + 1, 5 = 2 + 2 + 1): every
    array equal, dtypes and shapes included."""
    x = bundles["x"][:rows]
    served = bundles["served"].predict(x)
    assert_same_arrays(served, bundles["live"].predict(x))
    if rows:
        assert served["count"].min() > 0


def test_bundle_matches_jax_bundle(bundles):
    ours = bundles["served"].predict(bundles["x"])
    ref = bundles["jax"].predict(bundles["x"])
    assert ref["count"].min() > 0
    assert_detections_match(ours, ref)


def test_bundle_runs_the_registered_ops(bundles):
    manifest = bundles["served"].manifest
    want = {"msl::greedy_nms"}
    if bundles["name"] == "fused":
        want |= {"msl::fused_depthwise_bn_relu", "msl::fused_tail"}
    assert set(manifest["custom_ops"]) == want
    with zipfile.ZipFile(bundles["port_path"]) as zf:
        assert sorted(zf.namelist()) == ["fn_b1_cpu.pt2", "fn_b2_cpu.pt2", "manifest.json"]


def test_manifest_has_the_jax_keys(bundles):
    ours = bundles["served"].manifest
    ref = bundles["jax"].manifest
    assert set(ours) == (set(ref) - {"jax_version"}) | {"torch_version", "format", "custom_ops"}
    assert ours["format"] == "torch.export" and ours["torch_version"] == torch.__version__
    for key in ("manifest_version", "input", "batch_sizes", "nms_impl", "min_score", "top_k",
                "quantize", "outputs"):
        assert ours[key] == ref[key], key
    assert ours["platforms"] == ["cpu"] and ref["platforms"] == ["cpu"]
    assert SSD3DConfig.from_json_dict(ours["config"]) == bundles["served"].config
    assert bundles["served"].config == SSD3DConfig.from_json_dict(ref["config"])


def test_jax_bundle_raises_naming_the_format(bundles):
    with pytest.raises(ValueError, match="JAX bundle.*jax.export StableHLO"):
        serving.ServingDetector(bundles["jax_path"], device="cpu")


def test_bundle_without_the_devices_program_raises(bundles, tmp_path):
    with pytest.raises(ValueError, match="has no program for 'cuda'"):
        serving.ServingDetector(bundles["port_path"], device="cuda")
    # the same programs, the manifest claiming another platform
    moved = tmp_path / "cuda_only.mslx"
    with zipfile.ZipFile(bundles["port_path"]) as src, zipfile.ZipFile(moved, "w") as dst:
        manifest = json.loads(src.read("manifest.json"))
        manifest["platforms"] = ["cuda"]
        dst.writestr("manifest.json", json.dumps(manifest))
    with pytest.raises(ValueError, match="has no program for 'cpu'"):
        serving.ServingDetector(moved, device="cpu")


def test_export_raises_without_a_card_unless_asked_for_the_cpu(bundles):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the behaviour without one")
    cfg = bundles["served"].config
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.export_detector(cfg, bundles["live"].model.state_dict(), (1,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.export_detector(cfg, bundles["live"].model.state_dict(), (1,),
                                platforms=["cpu", "cuda"])


def test_export_checks_quantize_before_tracing(bundles):
    cfg = bundles["served"].config
    with pytest.raises(ValueError, match="calib_images"):
        serving.export_detector(cfg, {}, (1,), quantize="int8", platforms=["cpu"])
    with pytest.raises(ValueError, match="unknown quantize mode"):
        serving.export_detector(cfg, {}, (1,), quantize="int4", platforms=["cpu"])


@pytest.fixture(scope="module")
def sw_bundles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sw")
    params, stats = scaled_variables(SW, 10.0, seed=3)
    cfg = SSD3DConfig.create(**SW)
    state_dict = from_jax_variables(params, stats, cfg)
    port_path = port_bundle(tmp, serving.export_sliding_window_detector, cfg, state_dict, VOL,
                            BATCHES)
    jax_path = jax_bundle(tmp, jax_serving.export_sliding_window_detector,
                          JaxConfig.create(**SW), {"params": params, "batch_stats": stats}, VOL,
                          BATCHES)
    return {
        "cfg": cfg, "state": create_train_state(cfg, device="cpu", state_dict=state_dict),
        "served": serving.ServingDetector(port_path, device="cpu"),
        "jax": jax_serving.ServingDetector(jax_path),
        "volumes": np.random.default_rng(0).normal(size=(3, *VOL, 1)).astype(np.float32),
    }


def test_sliding_window_bundle_equals_live_sliding_window(sw_bundles):
    """3 volumes over programs of 2 and 1 volumes: each volume's detections
    equal a live single-volume call's, array for array."""
    served = sw_bundles["served"].predict(sw_bundles["volumes"])
    run = make_sliding_window_detector(sw_bundles["cfg"], VOL)
    for i, vol in enumerate(sw_bundles["volumes"]):
        live = {k: v.numpy()[0] for k, v in run(sw_bundles["state"], vol).items()}
        assert_same_arrays({k: v[i] for k, v in served.items()}, live)
        assert live["count"] > 0


def test_sliding_window_bundle_matches_jax_bundle(sw_bundles):
    ours = sw_bundles["served"].predict(sw_bundles["volumes"])
    ref = sw_bundles["jax"].predict(sw_bundles["volumes"])
    assert ref["count"].min() > 0
    assert_detections_match(ours, ref)
    manifest = sw_bundles["served"].manifest
    assert manifest["kind"] == "sliding_window" and manifest["volume_shape"] == list(VOL)
    assert set(manifest) == ((set(sw_bundles["jax"].manifest) - {"jax_version"})
                             | {"torch_version", "format", "custom_ops"})


def test_empty_request_is_shaped_from_the_manifest(sw_bundles):
    out = sw_bundles["served"].predict(np.zeros((0, *VOL, 1), np.float32))
    assert {k: v.shape for k, v in out.items()} == {
        "boxes": (0, 100, 6), "labels": (0, 100), "scores": (0, 100), "count": (0,)}


def test_serialized_program_loads_from_bytes(bundles):
    """A program is a plain ``torch.export`` archive: it loads from its bytes
    once the port's kernel modules have registered the ops."""
    with zipfile.ZipFile(bundles["port_path"]) as zf:
        program = torch.export.load(io.BytesIO(zf.read("fn_b1_cpu.pt2")))
    x = torch.from_numpy(bundles["x"][:1])
    with torch.inference_mode():
        out = {k: v.numpy() for k, v in program.module()(x).items()}
    assert_same_arrays(out, bundles["live"].predict(bundles["x"][:1]))
