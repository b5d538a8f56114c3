"""Weights from the seed: a state dict in the reference repository's schema,
made on the device in one draw over every entry in the schema's order.

Two schemes:

* ``init``: the reference repository's start of training (torch's default
  conv init, U(+-1/sqrt(fan_in)) weights and biases; the rescale factors at
  20; each kind of the backbone family at its ``init`` value).
* ``served``: a stand-in for trained weights, under which activations keep
  their scale through the tower and the heads give logits of a few units:
  convs U(+-sqrt(6/fan_in)) (variance 2 / fan_in), biases U(+-1/sqrt(fan_in)),
  each kind of the family at its ``served`` value (``reference/mobilenet.py``:
  BatchNorm weight U(0.8, 1.2), bias U(-0.1, 0.1), running mean U(-0.1,
  0.1) and variance U(0.8, 1.25); ``reference/convnet.py``: PReLU slopes
  U(0.15, 0.25)).

Conv weights are stored in ``conv_dtype`` (the type they are served in);
the rest in float32, counters as int64. ``box_size_gain`` adds SIZE_VARIANCE x
ln(gain) to the loc heads' size biases, so that every decoded box is about
``gain`` times its prior's side.
"""

from __future__ import annotations

import math

import torch

from ..reference import boxes as bx
from ..reference import ssd3d


def make_state_dict(cfg: dict, seed: int, device, scheme: str, conv_dtype=torch.float32,
                    box_size_gain: float = 1.0) -> dict:
    specs = ssd3d.param_specs(cfg)
    kinds = ssd3d.family(cfg).KINDS
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, start = {}, 0
    for (name, shape, kind, fan_in), n in zip(specs, sizes):
        v = u[start:start + n].view(shape)
        start += n
        if kind in ("conv_w", "conv_b"):
            gain = math.sqrt(6.0) if scheme == "served" and kind == "conv_w" else 1.0
            a = gain / math.sqrt(fan_in)
            w = (2.0 * v - 1.0) * a
            if kind == "conv_b" and ".loc_convs." in name:
                w = w.view(-1, 6)
                w[:, 3:] += bx.SIZE_VARIANCE * math.log(box_size_gain)
                w = w.view(shape)
            out[name] = w.to(conv_dtype)
        elif kind == "rescale":
            out[name] = torch.full(shape, 20.0, device=device)
        else:
            init, served, role = kinds[kind]
            value = served if scheme == "served" else init
            if role == "counter":
                out[name] = torch.full(shape, value, dtype=torch.long, device=device)
            elif isinstance(value, tuple):
                lo, hi = value
                out[name] = lo + (hi - lo) * v
            else:
                out[name] = torch.full(shape, value, device=device)
    return out
