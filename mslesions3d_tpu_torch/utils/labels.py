"""Class-name <-> id maps and a distinct color palette.

The port's own copy of ``mslesions3d_tpu/utils/labels.py``: background = 0,
classes start at 1.
"""

voc_labels = ("lesion",)
label_map = {k: v + 1 for v, k in enumerate(voc_labels)}
label_map["background"] = 0
rev_label_map = {v: k for k, v in label_map.items()}

distinct_colors = [
    "#e6194b", "#3cb44b", "#ffe119", "#0082c8", "#f58231", "#911eb4",
    "#46f0f0", "#f032e6", "#d2f53c", "#fabebe", "#008080", "#000080",
    "#aa6e28", "#fffac8", "#800000", "#aaffc3", "#808000", "#ffd8b1",
    "#e6beff", "#808080", "#FFFFFF", "#B99E43", "#A4B943", "#7AB943",
    "#43B969", "#43B993", "#43B9B9", "#4399B9", "#4375B9", "#4358B9",
    "#4A43B9", "#7A43B9", "#A743B9",
]
label_color_map = {k: distinct_colors[i] for i, k in enumerate(label_map.keys())}
