"""The port's ``cli.export`` and ``cli.serve`` against the JAX package's, on the CPU.

- ``cli.export`` reads a port checkpoint and serves the EMA average unless
  ``--use_ema 0`` (``tests/test_serving.py``'s checks); the raw-param bundle
  equals the live ``Detector`` on the checkpoint's params bit for bit.
- ``cli.serve`` batch mode: NIfTI volumes in, ``{name}_detections.json``
  out, equal to the JAX ``cli.serve`` on the same weights and files (the
  JAX variables carried across by ``from_jax_variables``): floats within
  1e-4, everything else equal; detections whose scores lie within 1e-4 of
  each other match as a set. The classification heads are scaled x30 so
  the scores spread.
- The HTTP server (``make_http_server``): /healthz, /stats, /predict with 3-D, 4-D
  and 5-D bodies equal to a direct ``predict``, 400 for a wrong shape and a
  malformed body, and concurrent clients coalesced into fewer device calls
  than requests (``tests/test_serving.py``'s checks).
- Every CLI runs with ``--device cpu``; without it they want a card and
  raise here.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mslesions3d_tpu import serving as jax_serving
from mslesions3d_tpu.cli import serve as jax_serve_cli
from mslesions3d_tpu.data.nifti import save_nifti
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu_torch.cli import export as export_cli
from mslesions3d_tpu_torch.cli import serve as serve_cli
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.serving import Detector, ServingDetector, export_detector, save_bundle
from mslesions3d_tpu_torch.train import create_train_state, save_checkpoint
from mslesions3d_tpu_torch.weights import from_jax_variables
from test_torch_port_forward import INPUT
from test_torch_port_serving_bundle import scaled_variables

TOL = 1e-4
CONFIG = dict(n_classes=2, input_channels=1, input_size=INPUT, width_mult=0.25, min_score=0.5,
              max_overlap=0.5, top_k=3)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint whose EMA average differs from its params."""
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = SSD3DConfig.create(**{**CONFIG, "min_score": 0.0, "top_k": 4}, ema_decay=0.99)
    state = create_train_state(cfg, seed=1, device="cpu")
    state = state.replace(ema_params={k: v + 0.05 for k, v in state.ema_params.items()})
    return cfg, state, save_checkpoint(tmp / "ckpt", state, cfg, {"avg_val_loss": 1.0},
                                       extra={"epoch": 0})


def test_export_cli_serves_the_ema_unless_told(checkpoint, tmp_path):
    cfg, state, ckpt = checkpoint
    images = np.random.default_rng(0).normal(size=(2, *INPUT, 1)).astype(np.float32)
    outs = {}
    for flag in ("0", "1"):
        out = export_cli.main(["-m", str(ckpt), "-o", str(tmp_path / f"m{flag}.mslx"),
                               "-b", "1", "2", "--device", "cpu", "--use_ema", flag])
        det = ServingDetector(out, device="cpu")
        assert det.batch_sizes == [1, 2] and det.manifest["platforms"] == ["cpu"]
        outs[flag] = det.predict(images)
    assert not np.allclose(outs["0"]["scores"], outs["1"]["scores"])
    for flag, params in (("0", state.params), ("1", state.ema_params)):
        live = Detector(cfg, state.replace(params=params).state_dict(), device="cpu",
                        batch_sizes=(1, 2)).predict(images)
        for k in live:
            np.testing.assert_array_equal(outs[flag][k], live[k])


def test_export_cli_checks_the_calibration_shape(checkpoint, tmp_path):
    _, _, ckpt = checkpoint
    bad = tmp_path / "calib.npy"
    np.save(bad, np.zeros((2, 16, 16, 16, 1), np.float32))
    argv = ["-m", str(ckpt), "-o", str(tmp_path / "q.mslx"), "--device", "cpu",
            "--quantize", "int8"]
    with pytest.raises(SystemExit, match="--quantize needs --calib_npy"):
        export_cli.main(argv)
    with pytest.raises(SystemExit, match=r"--calib_npy must be \(N, 32, 32, 32, 1\)"):
        export_cli.main(argv + ["--calib_npy", str(bad)])


def test_export_cli_int8_sliding_window(checkpoint, tmp_path):
    _, _, ckpt = checkpoint
    calib = tmp_path / "calib.npy"
    np.save(calib, np.random.default_rng(1).normal(size=(2, *INPUT, 1)).astype(np.float32))
    out = export_cli.main(["-m", str(ckpt), "-o", str(tmp_path / "qsw.mslx"), "--device", "cpu",
                           "--quantize", "int8", "--calib_npy", str(calib),
                           "-sw", "40", "32", "32", "--per_patch_k", "8"])
    det = ServingDetector(out, device="cpu")
    m = det.manifest
    assert (m["quantize"], m["kind"], m["volume_shape"], m["per_patch_k"]) == (
        "int8", "sliding_window", [40, 32, 32], 8)
    res = det.predict(np.zeros((1, 40, 32, 32, 1), np.float32))
    assert res["boxes"].shape == (1, 4, 6)


def test_clis_want_a_card_unless_asked_for_the_cpu(checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the behaviour without one")
    _, _, ckpt = checkpoint
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["-m", str(ckpt), "-o", str(tmp_path / "m.mslx")])
    out = export_cli.main(["-m", str(ckpt), "-o", str(tmp_path / "m.mslx"), "--device", "cpu"])
    with pytest.raises(ValueError, match="has no program for 'cuda'"):
        serve_cli.main(["-m", str(out), "--listen", "0"])
    # a bundle that claims a card's program: loading it wants the card
    both = tmp_path / "both.mslx"
    with zipfile.ZipFile(out) as src, zipfile.ZipFile(both, "w") as dst:
        for name in src.namelist():
            dst.writestr(name, src.read(name))
        manifest = json.loads(src.read("manifest.json"))
    with zipfile.ZipFile(both, "a") as dst:
        manifest["platforms"] = ["cpu", "cuda"]
        dst.writestr("manifest.json", json.dumps(manifest))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingDetector(both)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["-m", str(both), "--listen", "0"])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The same weights as a JAX bundle and a port bundle, and NIfTI inputs."""
    tmp = tmp_path_factory.mktemp("served")
    params, stats = scaled_variables(CONFIG, 30.0)
    cfg = SSD3DConfig.create(**CONFIG)
    exports, manifest = jax_serving.export_detector(
        JaxConfig.create(**CONFIG), {"params": params, "batch_stats": stats}, (2,),
        nms_impl="xla", dtype="float32")
    jax_path = jax_serving.save_bundle(tmp / "jax.mslx", exports, manifest)
    exports, manifest = export_detector(cfg, from_jax_variables(params, stats, cfg), (1, 2),
                                        platforms=["cpu"])
    port_path = save_bundle(tmp / "port.mslx", exports, manifest)
    rng = np.random.default_rng(2)
    paths = []
    for i in range(3):  # nonzero background and zero voxels: the normalization matters
        img = rng.normal(2.0, 3.0, INPUT).astype(np.float32)
        img[:4] = 0.0
        paths.append(str(tmp / f"vol{i}.nii.gz"))
        save_nifti(paths[-1], img)
    return {"tmp": tmp, "jax": jax_path, "port": port_path, "paths": paths}


def test_serve_cli_json_equals_jax(served):
    tmp = served["tmp"]
    jax_out = jax_serve_cli.main(["-m", str(served["jax"]), "-i", *served["paths"],
                                  "-o", str(tmp / "jax_out")])
    port_out = serve_cli.main(["-m", str(served["port"]), "-i", *served["paths"],
                               "-o", str(tmp / "port_out"), "--device", "cpu"])
    counts = []
    for path in served["paths"]:
        name = path.split("/")[-1].split(".")[0] + "_detections.json"
        ref = json.loads((jax_out / name).read_text())
        ours = json.loads((port_out / name).read_text())
        assert ours["input"] == ref["input"]
        assert len(ours["detections"]) == len(ref["detections"])
        counts.append(len(ref["detections"]))
        left = list(ours["detections"])
        for r in ref["detections"]:  # near ties as a set, floats within TOL
            match = [o for o in left if o["label"] == r["label"] and set(o) == set(r)
                     and abs(o["score"] - r["score"]) <= TOL
                     and np.abs(np.subtract(o["box_frac"], r["box_frac"])).max() <= TOL
                     and np.abs(np.subtract(o["box_voxels"], r["box_voxels"])).max()
                     <= TOL * max(INPUT)]
            assert match, (name, r)
            left.remove(match[0])
    assert min(counts) > 0


def test_serve_cli_checks_the_volume_shape(served, tmp_path):
    odd = tmp_path / "odd.nii.gz"
    save_nifti(str(odd), np.zeros((16, 32, 32), np.float32))
    with pytest.raises(SystemExit, match="does not match the bundle's input"):
        serve_cli.main(["-m", str(served["port"]), "-i", str(odd), "-o", str(tmp_path),
                        "--device", "cpu"])
    with pytest.raises(SystemExit, match="batch mode needs"):
        serve_cli.main(["-m", str(served["port"]), "--device", "cpu"])


def _post(base, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


@pytest.fixture()
def http(served):
    det = ServingDetector(served["port"], device="cpu")
    server = serve_cli.make_http_server(det, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield det, server, f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.batcher.close()


def test_http_healthz_and_predict(http):
    det, _, base = http
    health = json.loads(urllib.request.urlopen(f"{base}/healthz").read())
    assert health["status"] == "ok" and health["batch_sizes"] == [1, 2]
    assert health["platforms"] == ["cpu"] and health["kind"] == "detector"
    vols = np.random.default_rng(7).normal(size=(2, *INPUT, 1)).astype(np.float32)
    # each body against a direct predict of the same rows (CPU convolutions
    # round by batch size, so a row is compared at its own request's batch)
    bodies = {"5-D": (vols, vols), "4-D": (vols[1], vols[1:]), "3-D": (vols[0, ..., 0], vols[:1])}
    for name, (body, rows) in bodies.items():
        ref = det.predict(rows)
        res = _post(base, body)["volumes"]
        assert len(res) == len(rows), name
        for i, v in enumerate(res):
            assert v["count"] == int(ref["count"][i]) > 0
            np.testing.assert_array_equal(np.asarray(v["boxes_frac"], np.float32),
                                          ref["boxes"][i][: v["count"]])
            np.testing.assert_array_equal(np.asarray(v["scores"], np.float32),
                                          ref["scores"][i][: v["count"]])
            assert v["labels"] == ref["labels"][i][: v["count"]].tolist()


def test_http_stats_counts_requests_rows_and_program_calls(http):
    """GET /stats: the batcher's counters since the server started, and
    ``route``'s program calls, padded rows and staged uploads and bytes
    (counted over the process; a CPU bundle stages nothing)."""
    from mslesions3d_tpu_torch.serving import route

    _, _, base = http
    stats = json.loads(urllib.request.urlopen(f"{base}/stats").read())
    assert {k: stats[k] for k in ("requests", "rows", "device_calls", "queue_wait_s")} == {
        "requests": 0, "rows": 0, "device_calls": 0, "queue_wait_s": 0.0}
    counters = ("program_calls", "padded_rows", "staged_uploads", "staged_bytes")
    assert [stats[k] for k in counters] == [getattr(route, k) for k in counters]
    vols = np.random.default_rng(8).normal(size=(3, *INPUT, 1)).astype(np.float32)
    _post(base, vols)  # 3 rows on the bundle's sizes 1 and 2: two program calls
    _post(base, vols[0])
    after = json.loads(urllib.request.urlopen(f"{base}/stats").read())
    assert (after["requests"], after["rows"], after["device_calls"]) == (2, 4, 2)
    assert after["queue_wait_s"] >= 0.0
    assert after["program_calls"] - stats["program_calls"] == 3
    assert after["padded_rows"] == stats["padded_rows"]
    assert [after[k] for k in counters[2:]] == [stats[k] for k in counters[2:]]


def test_http_refuses_bad_bodies_and_stays_up(http):
    _, _, base = http
    for data in (b"junk", None):
        if data is None:
            buf = io.BytesIO()
            np.save(buf, np.zeros((1, 16, 32, 32, 1), np.float32))
            data = buf.getvalue()
        req = urllib.request.Request(f"{base}/predict", data=data, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req)
        assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{base}/nothing")
    assert err.value.code == 404
    assert json.loads(urllib.request.urlopen(f"{base}/healthz").read())["status"] == "ok"


def test_http_concurrent_requests_coalesce(served):
    det = ServingDetector(served["port"], device="cpu")
    real_predict = det.predict
    calls = []

    def slow_predict(images):
        calls.append(images.shape[0])
        time.sleep(0.25)  # hold the dispatcher so the others pile up
        return real_predict(images)

    det.predict = slow_predict
    server = serve_cli.make_http_server(det, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_port}"
    n = 8
    vols = np.random.default_rng(3).normal(size=(n, *INPUT, 1)).astype(np.float32)
    ref = {i: real_predict(vols[i:i + 1]) for i in range(n)}
    try:
        with ThreadPoolExecutor(max_workers=n) as ex:
            results = list(ex.map(lambda i: (i, _post(base, vols[i:i + 1])), range(n)))
        for i, res in results:
            (v,) = res["volumes"]
            assert v["count"] == int(ref[i]["count"][0])
            # another batch than ref's may hold the row: CPU convolutions
            # round by batch size, so within 1e-6
            np.testing.assert_allclose(v["boxes_frac"], ref[i]["boxes"][0][: v["count"]],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(v["scores"], ref[i]["scores"][0][: v["count"]],
                                       rtol=1e-6, atol=1e-6)
        assert sum(calls) == n
        assert len(calls) < n, f"{len(calls)} device calls for {n} concurrent clients"
        assert server.batcher.device_calls == len(calls)
    finally:
        server.shutdown()
        server.batcher.close()


def test_parsers_take_the_jax_flags():
    from mslesions3d_tpu.cli import export as jax_export_cli

    for ours, ref, swapped in ((export_cli, jax_export_cli, {"--platform"}),
                               (serve_cli, jax_serve_cli, {"--platform"})):
        flags = {o for a in ref.build_parser()._actions for o in a.option_strings}
        mine = {o for a in ours.build_parser()._actions for o in a.option_strings}
        assert flags - swapped <= mine and "--device" in mine
