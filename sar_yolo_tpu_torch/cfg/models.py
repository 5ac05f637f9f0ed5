"""The model configurations this package serves, as plain dicts.

Each dict is exactly what `yaml.safe_load` gives for the JAX package's file of
the same name under `sar_yolo_tpu/cfg/models/` (`v13/yolov13-JDE.yaml`,
`v13/yolov13-JDE_P24.yaml`, `v8/yolov8.yaml`, `11/yolo11.yaml`,
`11/yolo11-JDE.yaml`, `v12/yolov12.yaml`, `test/tinyjde.yaml`,
`test/tinydet.yaml`), so the graph dialect and the channel arithmetic of
`nn/tasks.py` apply unchanged. The fork's yolo11.yaml has nc 1 (persons);
yolov8 and yolov12 keep COCO's 80. They are Python
rather than YAML because the serving machine has no YAML parser. Note that
YAML reads the `None` of `nn.Upsample` as the string "None".
"""

from __future__ import annotations

import copy
import re

_SCALES = {"n": [0.5, 0.25, 1024], "s": [0.5, 0.5, 1024],
           "l": [1.0, 1.0, 512], "x": [1.0, 1.5, 512]}

_JDE_BACKBONE = [
    [-1, 1, "Conv", [64, 3, 2]],  # 0-P1/2
    [-1, 1, "Conv", [128, 3, 2, 1, 2]],  # 1-P2/4
    [-1, 2, "DSC3k2", [256, False, 0.25]],
    [-1, 1, "Conv", [256, 3, 2, 1, 4]],  # 3-P3/8
    [-1, 2, "DSC3k2", [512, False, 0.25]],
    [-1, 1, "DSConv", [512, 3, 2]],  # 5-P4/16
    [-1, 4, "A2C2f", [512, True, 4]],
    [-1, 1, "DSConv", [1024, 3, 2]],  # 7-P5/32
    [-1, 4, "A2C2f", [1024, True, 1]],  # 8
]

_UP = ["None", 2, "nearest"]

_SCALES_V8 = {"n": [0.33, 0.25, 1024], "s": [0.33, 0.5, 1024], "m": [0.67, 0.75, 768],
              "l": [1.0, 1.0, 512], "x": [1.0, 1.25, 512]}
_SCALES_V11 = {"n": [0.5, 0.25, 1024], "s": [0.5, 0.5, 1024], "m": [0.5, 1.0, 512],
               "l": [1.0, 1.0, 512], "x": [1.0, 1.5, 512]}

_V11_BACKBONE = [
    [-1, 1, "Conv", [64, 3, 2]],  # 0-P1/2
    [-1, 1, "Conv", [128, 3, 2]],  # 1-P2/4
    [-1, 2, "C3k2", [256, False, 0.25]],
    [-1, 1, "Conv", [256, 3, 2]],  # 3-P3/8
    [-1, 2, "C3k2", [512, False, 0.25]],
    [-1, 1, "Conv", [512, 3, 2]],  # 5-P4/16
    [-1, 2, "C3k2", [512, True]],
    [-1, 1, "Conv", [1024, 3, 2]],  # 7-P5/32
    [-1, 2, "C3k2", [1024, True]],
    [-1, 1, "SPPF", [1024, 5]],  # 9
    [-1, 2, "C2PSA", [1024]],  # 10
]


def _v11_head(last: list) -> list:
    return [
        [-1, 1, "nn.Upsample", _UP],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 2, "C3k2", [512, False]],  # 13
        [-1, 1, "nn.Upsample", _UP],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 2, "C3k2", [256, False]],  # 16 (P3/8-small)
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 13], 1, "Concat", [1]],
        [-1, 2, "C3k2", [512, False]],  # 19 (P4/16-medium)
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 2, "C3k2", [1024, True]],  # 22 (P5/32-large)
        last,
    ]


MODELS = {
    "yolov13-JDE.yaml": {
        "nc": 1,
        "state_classes": 6,
        "scales": _SCALES,
        "backbone": _JDE_BACKBONE,
        "head": [
            [[4, 6, 8], 2, "HyperACE", [512, 8, True, True, 0.5, 1, "both"]],  # 9
            [-1, 1, "nn.Upsample", _UP],  # 10
            [9, 1, "DownsampleConv", []],  # 11
            [[6, 9], 1, "FullPAD_Tunnel", []],  # 12
            [[4, 10], 1, "FullPAD_Tunnel", []],  # 13
            [[8, 11], 1, "FullPAD_Tunnel", []],  # 14
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 12], 1, "Concat", [1]],
            [-1, 2, "DSC3k2", [512, True]],  # 17
            [[-1, 9], 1, "FullPAD_Tunnel", []],  # 18
            [17, 1, "nn.Upsample", _UP],
            [[-1, 13], 1, "Concat", [1]],
            [-1, 2, "DSC3k2", [256, True]],  # 21
            [10, 1, "Conv", [256, 1, 1]],  # 22
            [[21, 22], 1, "FullPAD_Tunnel", []],  # 23
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 18], 1, "Concat", [1]],
            [-1, 2, "DSC3k2", [512, True]],  # 26
            [[-1, 9], 1, "FullPAD_Tunnel", []],  # 27
            [26, 1, "Conv", [512, 3, 2]],
            [[-1, 14], 1, "Concat", [1]],
            [-1, 2, "DSC3k2", [1024, True]],  # 30
            [[-1, 11], 1, "FullPAD_Tunnel", []],  # 31
            [[23, 27, 31], 1, "JDE", ["nc", 256, 6]],
        ],
    },
    "yolov13-JDE_P24.yaml": {
        "nc": 1,
        "state_classes": 6,
        "scales": _SCALES,
        "backbone": _JDE_BACKBONE,
        "head": [
            [[2, 4, 6, 8], 2, "HyperACE", [512, 8, True, True, 0.5, 1, "both"]],  # 9
            [-1, 1, "nn.Upsample", _UP],  # 10
            [-1, 1, "nn.Upsample", _UP],  # 11
            [9, 1, "DownsampleConv", []],  # 12
            [[6, 9], 1, "FullPAD_Tunnel", []],  # 13
            [[4, 10], 1, "FullPAD_Tunnel", []],  # 14
            [11, 1, "Conv", [256, 1, 1]],  # 15
            [[2, -1], 1, "FullPAD_Tunnel", []],  # 16
            [[8, 12], 1, "FullPAD_Tunnel", []],  # 17
            [-1, 1, "nn.Upsample", _UP],  # 18
            [[-1, 13], 1, "Concat", [1]],  # 19
            [-1, 2, "DSC3k2", [512, True]],  # 20
            [[-1, 9], 1, "FullPAD_Tunnel", []],  # 21
            [20, 1, "nn.Upsample", _UP],  # 22
            [[-1, 14], 1, "Concat", [1]],  # 23
            [-1, 2, "DSC3k2", [256, True]],  # 24
            [10, 1, "Conv", [256, 1, 1]],  # 25
            [[24, 25], 1, "FullPAD_Tunnel", []],  # 26
            [24, 1, "nn.Upsample", _UP],  # 27
            [[-1, 16], 1, "Concat", [1]],  # 28
            [-1, 2, "DSC3k2", [128, True]],  # 29
            [15, 1, "Conv", [128, 1, 1]],  # 30
            [[29, 30], 1, "FullPAD_Tunnel", []],  # 31
            [-1, 1, "Conv", [256, 3, 2]],  # 32
            [[-1, 26], 1, "Concat", [1]],  # 33
            [-1, 2, "DSC3k2", [256, True]],  # 34
            [10, 1, "Conv", [256, 1, 1]],  # 35
            [[34, 35], 1, "FullPAD_Tunnel", []],  # 36
            [-1, 1, "Conv", [512, 3, 2]],  # 37
            [[-1, 21], 1, "Concat", [1]],  # 38
            [-1, 2, "DSC3k2", [512, True]],  # 39
            [[-1, 9], 1, "FullPAD_Tunnel", []],  # 40
            [-1, 1, "Conv", [512, 3, 2]],  # 41
            [[-1, 17], 1, "Concat", [1]],  # 42
            [-1, 2, "DSC3k2", [1024, True]],  # 43
            [[-1, 12], 1, "FullPAD_Tunnel", []],  # 44
            [[31, 36, 40, 44], 1, "JDE", ["nc", 256, 6]],
        ],
    },
    "tinyjde.yaml": {
        "nc": 1,
        "state_classes": 6,
        "backbone": [
            [-1, 1, "Conv", [16, 3, 2]],  # 0-P1/2
            [-1, 1, "Conv", [32, 3, 2]],  # 1-P2/4
            [-1, 1, "C2f", [32, True]],
            [-1, 1, "Conv", [64, 3, 2]],  # 3-P3/8
            [-1, 1, "C2f", [64, True]],
            [-1, 1, "Conv", [128, 3, 2]],  # 5-P4/16
            [-1, 1, "C2f", [128, True]],
            [-1, 1, "Conv", [128, 3, 2]],  # 7-P5/32
            [-1, 1, "SPPF", [128, 5]],  # 8
        ],
        "head": [
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 6], 1, "Concat", [1]],
            [-1, 1, "C2f", [128]],  # 11
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 4], 1, "Concat", [1]],
            [-1, 1, "C2f", [64]],  # 14
            [[14, 11, 8], 1, "JDE", ["nc", 32, 6]],
        ],
    },
    "yolov8.yaml": {
        "nc": 80,
        "scales": _SCALES_V8,
        "backbone": [
            [-1, 1, "Conv", [64, 3, 2]],  # 0-P1/2
            [-1, 1, "Conv", [128, 3, 2]],  # 1-P2/4
            [-1, 3, "C2f", [128, True]],
            [-1, 1, "Conv", [256, 3, 2]],  # 3-P3/8
            [-1, 6, "C2f", [256, True]],
            [-1, 1, "Conv", [512, 3, 2]],  # 5-P4/16
            [-1, 6, "C2f", [512, True]],
            [-1, 1, "Conv", [1024, 3, 2]],  # 7-P5/32
            [-1, 3, "C2f", [1024, True]],
            [-1, 1, "SPPF", [1024, 5]],  # 9
        ],
        "head": [
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 6], 1, "Concat", [1]],
            [-1, 3, "C2f", [512]],  # 12
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 4], 1, "Concat", [1]],
            [-1, 3, "C2f", [256]],  # 15 (P3/8-small)
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 12], 1, "Concat", [1]],
            [-1, 3, "C2f", [512]],  # 18 (P4/16-medium)
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 9], 1, "Concat", [1]],
            [-1, 3, "C2f", [1024]],  # 21 (P5/32-large)
            [[15, 18, 21], 1, "Detect", ["nc"]],
        ],
    },
    "yolo11.yaml": {
        "nc": 1,
        "scales": _SCALES_V11,
        "backbone": _V11_BACKBONE,
        "head": _v11_head([[16, 19, 22], 1, "Detect", ["nc"]]),
    },
    "yolo11-JDE.yaml": {
        "nc": 1,
        "state_classes": 6,
        "scales": _SCALES_V11,
        "backbone": _V11_BACKBONE,
        "head": _v11_head([[16, 19, 22], 1, "JDE", ["nc", 256, 6]]),
    },
    "yolov12.yaml": {
        "nc": 80,
        "scales": _SCALES_V11,
        "backbone": [
            [-1, 1, "Conv", [64, 3, 2]],  # 0-P1/2
            [-1, 1, "Conv", [128, 3, 2, 1, 2]],  # 1-P2/4
            [-1, 2, "C3k2", [256, False, 0.25]],
            [-1, 1, "Conv", [256, 3, 2, 1, 4]],  # 3-P3/8
            [-1, 2, "C3k2", [512, False, 0.25]],
            [-1, 1, "Conv", [512, 3, 2]],  # 5-P4/16
            [-1, 4, "A2C2f", [512, True, 4]],
            [-1, 1, "Conv", [1024, 3, 2]],  # 7-P5/32
            [-1, 4, "A2C2f", [1024, True, 1]],  # 8
        ],
        "head": [
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 6], 1, "Concat", [1]],
            [-1, 2, "A2C2f", [512, False, -1]],  # 11
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 4], 1, "Concat", [1]],
            [-1, 2, "A2C2f", [256, False, -1]],  # 14
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 11], 1, "Concat", [1]],
            [-1, 2, "A2C2f", [512, False, -1]],  # 17
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 8], 1, "Concat", [1]],
            [-1, 2, "C3k2", [1024, True]],  # 20 (P5/32-large)
            [[14, 17, 20], 1, "Detect", ["nc"]],
        ],
    },
    "tinydet.yaml": {
        "nc": 3,
        "backbone": [
            [-1, 1, "Conv", [16, 3, 2]],  # 0-P1/2
            [-1, 1, "Conv", [32, 3, 2]],  # 1-P2/4
            [-1, 1, "C2f", [32, True]],
            [-1, 1, "Conv", [64, 3, 2]],  # 3-P3/8
            [-1, 1, "C2f", [64, True]],
            [-1, 1, "Conv", [128, 3, 2]],  # 5-P4/16
            [-1, 1, "C2f", [128, True]],
            [-1, 1, "Conv", [128, 3, 2]],  # 7-P5/32
            [-1, 1, "SPPF", [128, 5]],  # 8
        ],
        "head": [
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 6], 1, "Concat", [1]],
            [-1, 1, "C2f", [128]],  # 11
            [-1, 1, "nn.Upsample", _UP],
            [[-1, 4], 1, "Concat", [1]],
            [-1, 1, "C2f", [64]],  # 14
            [[14, 11, 8], 1, "Detect", ["nc"]],
        ],
    },
}


def model_config(name: str) -> dict:
    """Config dict for a model name, with the scale letter taken from it.

    'yolov13n-JDE.yaml' -> the 'yolov13-JDE.yaml' dict with scale='n' (the
    naming rule of the JAX package's `yaml_model_load`). Returns a deep copy.
    """
    stem = re.sub(r"\.yaml$", "", str(name).rsplit("/", 1)[-1])
    m = re.match(r"(.*yolov?\d+)([nslmx])(.*)", stem)
    scale, unified = (m.group(2), f"{m.group(1)}{m.group(3)}.yaml") if m else ("", f"{stem}.yaml")
    if unified not in MODELS:
        raise KeyError(f"model '{name}' is not one of {sorted(MODELS)}")
    d = copy.deepcopy(MODELS[unified])
    d["scale"] = scale
    return d
