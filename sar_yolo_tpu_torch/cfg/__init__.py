"""The command line of the port (port of `sar_yolo_tpu/cfg/__init__.py`'s `entrypoint` and its
special modes), over the config layer of `cfg/default.py`; the model configurations are
`cfg/models.py`.

    python -m sar_yolo_tpu_torch TASK MODE key=value ...     (or the `saryolo-torch` script)
    python -m sar_yolo_tpu_torch detect predict model=yolov8n.yaml source=frames/ device=cpu

Each `key=value` is parsed as the JAX package parses it (`ast.literal_eval`, then bare
true/false/none); TASK defaults to detect, MODE to predict, `model` to the task's model, and
the call is `getattr(YOLO(model, task=task, device=device), mode)(**overrides)`: the card
unless `device=cpu` (without CUDA the call raises, as `YOLO(...)` does). A key the port has
not ported raises where the mode's config meets it (`get_cfg`, `check_ported`). Special modes:
help, version, settings [reset | key=value ...], cfg, checks, copy-cfg; login and logout raise.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Any

TASKS = {"detect", "segment", "classify", "pose", "obb", "jde"}
MODES = {"train", "val", "predict", "export", "track", "benchmark", "tune"}

TASK2DATA = {
    "detect": "coco8.yaml",
    "segment": "coco8-seg.yaml",
    "classify": "imagenet10",
    "pose": "coco8-pose.yaml",
    "obb": "dota8.yaml",
    "jde": "person-search.yaml",
}
TASK2MODEL = {
    "detect": "yolov8n.yaml",
    "segment": "yolov8n-seg.yaml",
    "classify": "yolov8n-cls.yaml",
    "pose": "yolov8n-pose.yaml",
    "obb": "yolov8n-obb.yaml",
    "jde": "yolov13n-JDE.yaml",
}

USAGE = (f"Usage: saryolo-torch TASK MODE key=value ...\n  TASK in {sorted(TASKS)}\n"
         f"  MODE in {sorted(MODES)}")


def _logger():
    from sar_yolo_tpu_torch.utils import LOGGER
    return LOGGER


def parse_value(v: str):
    """A command-line value as the JAX package reads it: a Python literal where it is one,
    then true/false/none in any case, else the string."""
    try:
        v = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    if isinstance(v, str) and v.lower() in {"true", "false", "none"}:
        v = {"true": True, "false": False, "none": None}[v.lower()]
    return v


def parse_args(args: list[str]) -> tuple[str, str, str, dict]:
    """(task, mode, model, overrides) of TASK MODE key=value arguments, with the JAX
    `entrypoint`'s defaults."""
    overrides: dict[str, Any] = {}
    task, mode = None, None
    for a in args:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = parse_value(v)
        elif a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        else:
            raise SyntaxError(f"'{a}' is not a valid task, mode, or key=value pair")
    task = task or overrides.pop("task", None) or "detect"
    mode = mode or overrides.pop("mode", None) or "predict"
    model = overrides.pop("model", None) or TASK2MODEL[task]
    return task, mode, model, overrides


def _version() -> str:
    import sar_yolo_tpu_torch
    return f"sar_yolo_tpu_torch {getattr(sar_yolo_tpu_torch, '__version__', 'dev')}"


def _yaml_scalar(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, str) and (v == "" or v.strip() != v or v.lower() in
                               {"true", "false", "none", "null", "~"} or ":" in v):
        return f"'{v}'"
    return str(v)


def cfg_text() -> str:
    """The port's defaults (`cfg/default.py`) as YAML text, one `key: value` a line."""
    from sar_yolo_tpu_torch.cfg.default import DEFAULT_CFG
    lines = ["# sar_yolo_tpu_torch defaults (cfg/default.py)"]
    lines += [f"{k}: {_yaml_scalar(v)}".rstrip() for k, v in DEFAULT_CFG.items()]
    return "\n".join(lines) + "\n"


def _copy_default_cfg() -> Path:
    """The defaults written to the working directory as default_copy.yaml."""
    dst = Path.cwd() / "default_copy.yaml"
    dst.write_text(cfg_text())
    _logger().info(f"{dst} created")
    return dst


def _handle_settings(rest: list[str]) -> dict:
    """`settings [reset | key=value ...]`: reset to the defaults, update, then print."""
    from sar_yolo_tpu_torch.utils import settings as S
    if rest and rest[0] == "reset":
        S.SETTINGS.clear()
        S.SETTINGS.update(S._DEFAULTS)
        S.SETTINGS_FILE.parent.mkdir(parents=True, exist_ok=True)
        S.SETTINGS_FILE.write_text("{}")
        _logger().info("settings reset to defaults")
        rest = rest[1:]
    updates = {}
    for a in rest:
        if "=" in a:
            k, v = a.split("=", 1)
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass
            updates[k] = v
    if updates:
        S.update_settings(**updates)
    _logger().info("\n".join(f"{k}={v}" for k, v in S.SETTINGS.items()))
    return dict(S.SETTINGS)


def _run_checks() -> dict:
    """The versions of Python, torch, CUDA and numpy, and the device (the card's name)."""
    import platform

    import numpy
    import torch
    cuda = torch.cuda.is_available()
    info = {"python": platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "numpy": numpy.__version__,
            "cuda_available": cuda, "device_count": torch.cuda.device_count() if cuda else 0,
            "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
    _logger().info("\n".join(f"{k}: {v}" for k, v in info.items()))
    return info


def _network_client(mode: str):
    def refuse(_rest):
        raise NotImplementedError(f"'{mode}': the hub clients are not part of this port yet "
                                  "(ROADMAP.md Queue A, network clients)")
    return refuse


def entrypoint(argv: list[str] | None = None) -> Any:
    """`saryolo-torch TASK MODE key=value ...`; returns what the mode returns."""
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        _logger().info(USAGE)
        return None
    special = {
        "help": lambda _: _logger().info(
            f"{USAGE}\nSpecial: help version settings cfg checks copy-cfg\n"
            "Docs: README.md in the repo"),
        "version": lambda _: _logger().info(_version()),
        "settings": _handle_settings,
        "cfg": lambda _: _logger().info(cfg_text()),
        "checks": lambda _: _run_checks(),
        "copy-cfg": lambda _: _copy_default_cfg(),
        "login": _network_client("login"),
        "logout": _network_client("logout"),
    }
    for k in list(special):
        special[f"-{k}"] = special[f"--{k}"] = special[k]
    if args[0].lower() in special:
        return special[args[0].lower()](args[1:])

    task, mode, model, overrides = parse_args(args)
    device = overrides.pop("device", None)
    from sar_yolo_tpu_torch import YOLO
    return getattr(YOLO(model, task=task, device=device), mode)(**overrides)
