"""Frozen work count of SSD3D on the ConvNet tower.

Plain Python on the layer plan of the plain reference
(``reference/convnet.py``: each block a 3^3 conv, padding 1, at its stride;
a max-pool k3, s2, p1; the tower cut after the last feature layer) and its
heads (``reference/ssd3d.py``: a 3^3 loc conv of 6 outputs a box and a 3^3
class conv of ``n_classes`` a box on each feature layer). Nothing here
imports the program. At 2 FLOP a multiply-add, and counting the convs only
(the norm, dropout, PReLU, pool and bias adds are elementwise), the
convnet_maxpool_double tower is 32.16 GFLOP a volume at 64^3 and its heads
with 3 boxes a location 0.85: 33.01 in all.
"""

from __future__ import annotations

import math

from perfbench.reference import ssd3d

TAPS = 27  # a 3^3 kernel


def forward_flops(cfg: dict) -> tuple[float, float]:
    """(tower FLOPs, heads FLOPs) of one volume's forward."""
    dims = [int(d) for d in cfg["input_size"]]
    tower, maps = 0, {}
    for i, (kind, cin, cout, stride) in enumerate(ssd3d.tower_plan(cfg)):
        dims = [(d - 1) // s + 1 for d, s in zip(dims, stride)]  # k3, padding 1
        voxels = math.prod(dims)
        if kind == "conv":
            tower += voxels * cout * cin * TAPS
        maps[i] = (voxels, cout)
    per_box = 6 + int(cfg["n_classes"])
    heads = 0
    for layer in ssd3d.feature_layers(cfg):
        voxels, channels = maps[layer]
        heads += voxels * channels * ssd3d.boxes_per_map(cfg, layer) * per_box * TAPS
    return 2.0 * tower, 2.0 * heads
