"""The slice as a whole: JAX ``detect(SSD3D.apply(x))`` against the port's
``Detector(device="cpu")`` with the same weights, and request coalescing.

The classification heads' kernels are scaled by 30 on both sides so the
class scores spread over (0, 1); a guard asserts that the candidate scores,
and their distance to ``min_score``, are separated by more than the forward
tolerance, so equal top-k order and equal counts are a real comparison.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.models import model_priors as jax_model_priors
from mslesions3d_tpu.models.ssd3d import detect as jax_detect
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.serving import Detector, RequestBatcher
from mslesions3d_tpu_torch.weights import from_jax_variables
from test_torch_port_forward import INPUT, randomized_variables

CONFIG = dict(n_classes=2, input_channels=1, input_size=INPUT, width_mult=0.25,
              min_score=0.5, max_overlap=0.5, top_k=3)
TOL = 1e-4  # the forward's tolerance (test_torch_port_forward.py)


@pytest.fixture(scope="module")
def both():
    jax_model, params, batch_stats = randomized_variables(CONFIG, seed=0)
    for name, head in params["heads"].items():
        if name.startswith("cls_"):
            head["kernel"] = head["kernel"] * np.float32(30.0)
    x = np.random.default_rng(5).normal(size=(3, *INPUT, 1)).astype(np.float32)
    jax_cfg = JaxConfig.create(**CONFIG)
    locs, scores = jax_model.apply({"params": params, "batch_stats": batch_stats},
                                   jnp.asarray(x), train=False)
    ref = jax_detect(jax_cfg, locs, scores, jax_model_priors(jax_cfg))
    cfg = SSD3DConfig.create(**CONFIG)
    detector = Detector(cfg, from_jax_variables(params, batch_stats, cfg), device="cpu",
                        batch_sizes=(1, 2))
    probs = np.asarray(jax.nn.softmax(scores, -1))[..., 1]
    return {"x": x, "ref": jax.device_get(ref), "probs": probs, "detector": detector}


def test_guard_scores_are_separated(both):
    k = min(10 * CONFIG["top_k"], both["probs"].shape[1])
    for row in both["probs"]:
        top = np.sort(row)[::-1][: k + 1]
        assert np.abs(np.diff(top)).min() > TOL
        assert np.abs(row - CONFIG["min_score"]).min() > TOL


def test_detector_matches_jax_detect(both):
    """count and labels equal; boxes and scores within the forward's tolerance."""
    ref = both["ref"]
    ours = both["detector"].predict(both["x"])  # routed as chunks of 2 + 1
    assert int(ref["count"].min()) > 0
    assert {k: v.shape for k, v in ours.items()} == {k: ref[k].shape for k in ours}
    np.testing.assert_array_equal(ours["count"], ref["count"])
    np.testing.assert_array_equal(ours["labels"], ref["labels"])
    np.testing.assert_allclose(ours["scores"], ref["scores"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours["boxes"], ref["boxes"], rtol=TOL, atol=TOL)


def test_request_batcher_serves_detector(both):
    detector, x = both["detector"], both["x"]
    whole = detector.predict(x)
    batcher = RequestBatcher(detector.predict, max_rows=8)
    try:
        with ThreadPoolExecutor(max_workers=3) as ex:
            parts = list(ex.map(lambda i: batcher.submit(x[i:i + 1]), range(3)))
    finally:
        batcher.close()
    # the batcher may group the rows into other batches than `whole` did,
    # and CPU convolutions round differently by batch size: floats to 1e-6
    for i, part in enumerate(parts):
        for key in ("count", "labels"):
            np.testing.assert_array_equal(part[key], whole[key][i:i + 1])
        for key in ("scores", "boxes"):
            np.testing.assert_allclose(part[key], whole[key][i:i + 1], rtol=1e-6, atol=1e-6)
    assert 1 <= batcher.device_calls <= 3
    empty = detector.predict(x[:0])
    assert empty["boxes"].shape == (0, CONFIG["top_k"], 6) and empty["count"].shape == (0,)


def test_request_batcher_coalesces():
    """Requests that arrive while a call is in flight share the next call."""
    release = threading.Event()
    calls = []

    def predict(images):
        calls.append(images.shape[0])
        if len(calls) == 1:
            release.wait(timeout=10)
        return {"rows": images[:, 0].copy()}

    batcher = RequestBatcher(predict, max_rows=64)
    n = 6

    def submit(i):
        if i > 0:
            time.sleep(0.2)  # request 0 reaches the dispatcher first
        return batcher.submit(np.full((2, 1), i, np.float32))["rows"]

    # the first call returns once every other request has queued behind it
    timer = threading.Timer(1.0, release.set)
    timer.start()
    try:
        with ThreadPoolExecutor(max_workers=n) as ex:
            results = list(ex.map(submit, range(n)))
    finally:
        timer.cancel()
        batcher.close()
    for i, rows in enumerate(results):
        np.testing.assert_array_equal(rows, [i, i])
    assert batcher.device_calls == len(calls) == 2  # the 5 waiting requests went as one
    assert calls == [2, 10]
