"""Tensor parallelism on the card: K2 on channel slices, and two gloo ranks
sharing the card against one.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tensor_parallel.py

* K2 on each rank's channel slice of a seeded layer-3 activation (8, 128,
  12, 12, 12) at n_model 2 and 4 (64 and 32 channels: ``plan_depthwise``
  takes cs = min(64, C), so 32 is a tile no whole layer gives it), in bf16
  and float32: bit-equal to its plain version on the slice, and to the
  whole activation's K2 on those channels.
* Two ranks spawned on ``cuda:0`` form a 1 x 1 x 2 data x spatial x model
  mesh under gloo (NCCL refuses two ranks on one card) and run
  ``make_tensor_parallel_forward`` at 32^3, width 1.0, float32 (TF32 off),
  with ``use_pallas`` and ``use_pallas_tail``: each launches K2 once on its
  64 channels of layer 3 and K3 on all 128 as the unsharded forward does
  (in float32 one launch a block, ``plan_tail``), and the locs and scores
  equal the unsharded forward's within 1e-4 (cuDNN may pick other
  algorithms for a conv of half the output channels).
"""

import socket
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.kernels.depthwise import (
    depthwise_bn_relu,
    fold_bn,
    fused_depthwise_bn_relu_cuda,
)
from mslesions3d_tpu_torch.kernels.tail import fused_tail_cuda
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig
from mslesions3d_tpu_torch.parallel import (
    initialize_multihost,
    make_mesh_3d,
    make_tensor_parallel_forward,
)

pytestmark = pytest.mark.gpu

SHAPE = (8, 128, 12, 12, 12)
KW = dict(n_classes=2, input_channels=1, input_size=(32, 32, 32), width_mult=1.0,
          use_pallas=True, use_pallas_tail=True)


def _operands(dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    dw = (torch.randn((3, 3, 3, 128), generator=gen, device="cuda") * 0.2).to(dtype)
    gamma, beta = fold_bn(torch.rand(128, generator=gen, device="cuda") + 0.5,
                          torch.randn(128, generator=gen, device="cuda") * 0.1,
                          torch.randn(128, generator=gen, device="cuda") * 0.1,
                          torch.rand(128, generator=gen, device="cuda") + 0.5, 1e-5)
    return x, dw, gamma, beta


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k2_on_channel_slices(n_model, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, dw, gamma, beta = _operands(dtype)
    c = 128 // n_model
    with torch.no_grad():
        whole = fused_depthwise_bn_relu_cuda(x, dw, gamma, beta)
        for m in range(n_model):
            part = slice(m * c, (m + 1) * c)
            xs = x[:, part].contiguous(memory_format=torch.channels_last_3d)
            fused_depthwise_bn_relu_cuda.launches = 0
            ours = fused_depthwise_bn_relu_cuda(xs, dw[..., part].contiguous(), gamma[part],
                                                beta[part])
            assert fused_depthwise_bn_relu_cuda.launches == 1 and ours.shape[1] == c
            plain = depthwise_bn_relu(xs, dw[..., part].contiguous(), gamma[part], beta[part])
            assert torch.equal(ours, plain)
            assert torch.equal(ours, whole[:, part])


def _rank(rank: int, port: int, out: str) -> None:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda:0",
                         timeout_s=240)
    mesh = make_mesh_3d(1, 1, 2, device="cuda:0")
    model = SSD3D(SSD3DConfig.create(**KW), generator=torch.Generator().manual_seed(1))
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
    fused_depthwise_bn_relu_cuda.launches = fused_tail_cuda.launches = 0
    locs, scores = make_tensor_parallel_forward(model, mesh)(model.state_dict(), x)
    torch.cuda.synchronize()
    torch.save({"locs": locs.cpu(), "scores": scores.cpu(),
                "launches": (fused_depthwise_bn_relu_cuda.launches, fused_tail_cuda.launches)},
               Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def test_two_ranks_forward_on_a_model_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(_rank, args=(port, tmp), nprocs=2, join=True,
                                              start_method="spawn")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    model = SSD3D(SSD3DConfig.create(**KW), generator=torch.Generator().manual_seed(1))
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
    fused_depthwise_bn_relu_cuda.launches = fused_tail_cuda.launches = 0
    with torch.no_grad():
        ref = [t.cpu() for t in model.cuda().eval()(torch.from_numpy(x).cuda())]
    launches = (fused_depthwise_bn_relu_cuda.launches, fused_tail_cuda.launches)
    assert launches[0] == 1 and launches[1] >= 1
    for r in ranks:
        assert r["launches"] == launches
        for key, value in zip(("locs", "scores"), ref):
            torch.testing.assert_close(r[key], value, rtol=1e-4, atol=1e-4)
