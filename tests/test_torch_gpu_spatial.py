"""Spatial sharding on the card: two gloo ranks sharing it, against one.

Marked ``gpu``: the test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_spatial.py

Two ranks spawned on ``cuda:0`` form a 1 x 2 data x spatial mesh under gloo
(NCCL refuses two ranks on one card). Each takes its depth slab (6 planes of
12) of a seeded (2, 128, 12, 12, 12) activation and, inside
``parallel.data_parallel(mesh)``: a 3^3 conv at stride 1 and at stride 2
(``models.layers.conv3d``: the haloed slab, depth padding 0) equals its
planes of the unsharded ``F.conv3d`` within 1e-5 (float32, TF32 off: cuDNN
may pick another algorithm for the slab); K2 on the haloed slab (8 planes),
its middle planes kept, launches once and equals its planes of the
unsharded K2 bit for bit, in float32 and bf16; ``gather_depth`` returns the
whole activation.
"""

import socket
import tempfile
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from mslesions3d_tpu_torch.kernels.depthwise import fold_bn, fused_depthwise_bn_relu_cuda
from mslesions3d_tpu_torch.models.layers import conv3d
from mslesions3d_tpu_torch.parallel import (
    data_parallel,
    gather_depth,
    halo,
    initialize_multihost,
    make_mesh_2d,
)

pytestmark = pytest.mark.gpu

SHAPE = (2, 128, 12, 12, 12)


def _operands(dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    convs = {s: torch.nn.Conv3d(128, 64, 3, stride=s, padding=1, bias=True).cuda()
             for s in (1, 2)}
    for conv in convs.values():
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, device="cuda") * 0.05)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen, device="cuda") * 0.05)
    dw = (torch.randn((3, 3, 3, 128), generator=gen, device="cuda") * 0.2).to(dtype)
    gamma, beta = fold_bn(torch.rand(128, generator=gen, device="cuda") + 0.5,
                          torch.randn(128, generator=gen, device="cuda") * 0.1,
                          torch.randn(128, generator=gen, device="cuda") * 0.1,
                          torch.rand(128, generator=gen, device="cuda") + 0.5, 1e-5)
    return x, convs, dw, gamma, beta


def _rank(rank: int, port: int, out: str) -> None:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda:0",
                         timeout_s=240)
    mesh = make_mesh_2d(1, 2, device="cuda:0")
    results = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            x, convs, dw, gamma, beta = _operands(dtype)
            slab = x[:, :, 6 * rank:6 * rank + 6]
            with data_parallel(mesh):
                convs_out = {s: conv3d(conv, slab).cpu()
                             for s, conv in convs.items()} if dtype == torch.float32 else {}
                fused_depthwise_bn_relu_cuda.launches = 0
                haloed = halo(slab, mesh.spatial, 1, 1)
                k2 = fused_depthwise_bn_relu_cuda(
                    haloed.contiguous(memory_format=torch.channels_last_3d), dw, gamma, beta)
                launches = fused_depthwise_bn_relu_cuda.launches
                whole = gather_depth(slab, mesh.spatial)
            torch.cuda.synchronize()
            results[str(dtype)] = {"convs": convs_out, "k2": k2[:, :, 1:-1].cpu(),
                                   "haloed": tuple(haloed.shape), "launches": launches,
                                   "gathered_equal": bool(torch.equal(whole, x))}
    torch.save(results, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def test_two_ranks_halo_conv_and_k2_on_a_slab():
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
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            x, convs, dw, gamma, beta = _operands(dtype)
            ref = fused_depthwise_bn_relu_cuda(x, dw, gamma, beta).cpu()
            conv_ref = {s: F.conv3d(x.float(), conv.weight, conv.bias, s, 1).cpu()
                        for s, conv in convs.items()}
            for rank, results in enumerate(ranks):
                r = results[str(dtype)]
                assert r["haloed"] == (2, 128, 8, 12, 12)
                assert r["launches"] == 1
                assert r["gathered_equal"]
                assert torch.equal(r["k2"], ref[:, :, 6 * rank:6 * rank + 6])
                for s, out in r["convs"].items():
                    planes = slice(6 * rank // s, 6 * (rank + 1) // s)
                    torch.testing.assert_close(out, conv_ref[s][:, :, planes], rtol=1e-5,
                                               atol=1e-5)
