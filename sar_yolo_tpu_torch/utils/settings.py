"""Persistent user settings (port of `sar_yolo_tpu/utils/settings.py`): a JSON-backed dict
of the logger integrations and the standard directories, read and written by the command
line's `settings [reset | key=value ...]`.

Highest wins: the environment's `SARYOLO_<KEY>` > settings.json > the defaults. The file is
the JAX package's (`SARYOLO_SETTINGS`, else ~/.config/saryolo/settings.json), so both
packages read the same settings. The port runs no integration yet: the flags are kept for
the JAX package's users and for when the integrations are ported.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

_DEFAULTS = {
    "settings_version": "1.0",
    "datasets_dir": "datasets",
    "weights_dir": "weights",
    "runs_dir": "runs",
    "tensorboard": False,
    "wandb": False,
    "mlflow": False,
    "comet": False,
    "clearml": False,
    "dvc": False,
    "neptune": False,
    "raytune": False,
    "hub": True,        # hub callbacks activate only if SARYOLO_HUB_API is set
    "api_key": "",      # hub API key
}

SETTINGS_FILE = Path(os.environ.get(
    "SARYOLO_SETTINGS", Path.home() / ".config" / "saryolo" / "settings.json"))


def _coerce(val: str, like):
    if isinstance(like, bool):
        return val.strip().lower() in ("1", "true", "yes", "on")
    return type(like)(val) if not isinstance(like, str) else val


def _load() -> dict:
    s = dict(_DEFAULTS)
    if SETTINGS_FILE.is_file():
        try:
            s.update({k: v for k, v in json.loads(SETTINGS_FILE.read_text()).items()
                      if k in _DEFAULTS})
        except (json.JSONDecodeError, OSError):
            pass
    for k, default in _DEFAULTS.items():
        env = os.environ.get(f"SARYOLO_{k.upper()}")
        if env is not None:
            s[k] = _coerce(env, default)
    return s


SETTINGS = _load()


def update_settings(**kwargs) -> dict:
    """Update and persist settings; an unknown key raises KeyError."""
    bad = set(kwargs) - set(_DEFAULTS)
    if bad:
        raise KeyError(f"unknown settings: {sorted(bad)}; valid: {sorted(_DEFAULTS)}")
    SETTINGS.update(kwargs)
    SETTINGS_FILE.parent.mkdir(parents=True, exist_ok=True)
    SETTINGS_FILE.write_text(json.dumps(SETTINGS, indent=2))
    return SETTINGS
