"""Model configurations: the YAML files under `cfg/models/` (copies of the JAX package's
`sar_yolo_tpu/cfg/models/`, in the same subdirectories), read with the port's own
YAML reader (`utils/dataset_yaml.py::load_yaml`, equal to `yaml.safe_load` on every
one of them). The graph dialect and the channel arithmetic of `nn/tasks.py` apply to
them unchanged. Note that YAML reads the `None` of `nn.Upsample` as the string "None".
"""

from __future__ import annotations

import re
from pathlib import Path

from sar_yolo_tpu_torch.utils.dataset_yaml import load_yaml

MODELS_DIR = Path(__file__).resolve().parent / "models"


def model_config(name) -> dict:
    """Config dict of a model name or YAML path, with the scale letter taken from the stem
    (the JAX package's `yaml_model_load`).

    'yolov13n-JDE.yaml' -> `v13/yolov13-JDE.yaml` with scale='n'. An existing file path,
    absolute or relative, is read as it is (its stem still gives the scale); any other
    name is looked up under `cfg/models/`, first by its name without the scale letter,
    then by its own name. A name found nowhere raises FileNotFoundError.
    """
    path = Path(name)
    m = re.match(r"(.*yolov?\d+)([nslmx])(.*)", path.stem)
    scale, unified = (m.group(2), f"{m.group(1)}{m.group(3)}.yaml") if m else ("", path.name)
    found = path if path.is_file() else None
    for cand in (unified, path.name):
        if found is None:
            hits = sorted(MODELS_DIR.rglob(cand))
            found = hits[0] if hits else None
    if found is None:
        raise FileNotFoundError(f"model yaml '{name}' not found (searched {MODELS_DIR}/**)")
    d = load_yaml(found)
    d["scale"] = d.get("scale") or scale
    return d
