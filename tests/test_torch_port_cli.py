"""The port's command line (`sar_yolo_tpu_torch/cfg/__init__.py`, `__main__.py`) against the
JAX package's `entrypoint`.

Parsing: a table of argv through both entrypoints with `YOLO` stubbed on both sides, the same
(model, task, mode, overrides) (the port takes `device` out of the overrides into
`YOLO(..., device=)`). The special modes against a temporary settings file. A predict run
through both command lines on the same numpy-filled tinydet weights: the same rows within
1e-4. Without CUDA and without `device=cpu` the command raises.
"""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

import sar_yolo_tpu
import sar_yolo_tpu_torch
from sar_yolo_tpu import cfg as jax_cfg
from sar_yolo_tpu_torch import cfg as port_cfg
from sar_yolo_tpu_torch.cfg.default import DEFAULT_CFG
from torch_port_common import jax_and_port_yolo, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


class _Recorder:
    """A YOLO stand-in: records the constructor's arguments and the mode's kwargs."""

    calls: list = []

    def __init__(self, model, task=None, device=None):
        self.init = {"model": model, "task": task, "device": device}

    def __getattr__(self, mode):
        def call(**kwargs):
            _Recorder.calls.append({**self.init, "mode": mode, "overrides": kwargs})
            return mode
        return call


ARGV = [
    ["detect", "predict", "model=yolov8n.yaml", "source=frames/", "imgsz=640", "conf=0.25"],
    ["jde", "train", "data=synthetic", "epochs=3", "batch=-1", "mesh_shape=[1]",
     "imgsz=[640, 480]"],
    ["val", "int8=auto", "profile=trace", "half=True", "rect=false", "name=None", "save=FALSE"],
    ["export", "format=onnx", "opset=13", "dynamic=TRUE", "nms=true"],
    ["task=pose", "mode=val", "plots=True", "keras=True"],
    ["segment", "track", "tracker=botsort.yaml", "lr0=1e-3", "project=runs/x y"],
    ["classify", "benchmark", "formats=('pt2',)", "n_iter=5"],
    ["obb", "tune", "iterations=2", "use_ray=True", "epochs=1"],
    ["predict", "source=0", "device=cpu"],
    ["jde", "embed=[6, 8]", "device=cuda:1", "augment=True"],
    ["train", "model=yolov13n-JDE.yaml", "device=None", "batch=16.0", "hsv_h={'a': 1}"],
]


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a))
def test_parse_matches_jax_entrypoint(argv, monkeypatch):
    monkeypatch.setattr(sar_yolo_tpu, "YOLO", _Recorder, raising=False)
    monkeypatch.setattr(sar_yolo_tpu_torch, "YOLO", _Recorder, raising=False)
    _Recorder.calls = []
    jax_cfg.entrypoint(list(argv))
    port_cfg.entrypoint(list(argv))
    want, got = _Recorder.calls
    device = got["overrides"].pop("device", "absent")
    assert device == "absent"  # taken out into YOLO(..., device=)
    if any(a.startswith("device=") for a in argv):
        got["overrides"]["device"] = got["device"]
    else:
        assert got["device"] is None
    assert (got["model"], got["task"], got["mode"], got["overrides"]) == \
        (want["model"], want["task"], want["mode"], want["overrides"])


def test_parse_rejects_what_jax_rejects(monkeypatch):
    monkeypatch.setattr(sar_yolo_tpu, "YOLO", _Recorder, raising=False)
    monkeypatch.setattr(sar_yolo_tpu_torch, "YOLO", _Recorder, raising=False)
    for entry in (jax_cfg.entrypoint, port_cfg.entrypoint):
        with pytest.raises(SyntaxError, match="bogus"):
            entry(["detect", "bogus"])
        with pytest.raises(KeyError):
            entry(["task=nosuchtask"])
    assert port_cfg.entrypoint([]) is None
    assert (port_cfg.TASKS, port_cfg.MODES, port_cfg.TASK2DATA, port_cfg.TASK2MODEL) == \
        (jax_cfg.TASKS, jax_cfg.MODES, jax_cfg.TASK2DATA, jax_cfg.TASK2MODEL)


@pytest.fixture
def settings_files(tmp_path, monkeypatch):
    """Both packages' settings on their own temporary files, reset to the defaults."""
    from sar_yolo_tpu.utils import settings as jax_settings
    from sar_yolo_tpu_torch.utils import settings as port_settings
    for i, module in enumerate((jax_settings, port_settings)):
        monkeypatch.setattr(module, "SETTINGS_FILE", tmp_path / f"s{i}" / "settings.json")
        monkeypatch.setattr(module, "SETTINGS", dict(module._DEFAULTS))
    return jax_settings, port_settings


def test_settings_mode_matches_jax(settings_files):
    jax_settings, port_settings = settings_files
    assert port_settings._DEFAULTS == jax_settings._DEFAULTS
    for argv in (["settings"], ["settings", "tensorboard=True", "runs_dir=my_runs"],
                 ["settings", "wandb=1"], ["settings", "reset", "raytune=True"],
                 ["settings", "reset"]):
        want = jax_cfg.entrypoint(list(argv))
        got = port_cfg.entrypoint(list(argv))
        assert got == want, argv
        files = [m.SETTINGS_FILE for m in (port_settings, jax_settings)]
        assert files[0].exists() == files[1].exists()
        if files[1].exists():
            assert files[0].read_text() == files[1].read_text()
    for entry in (jax_cfg.entrypoint, port_cfg.entrypoint):
        with pytest.raises(KeyError, match="unknown settings"):
            entry(["settings", "nosuchkey=1"])


def test_special_modes(settings_files, tmp_path, monkeypatch):
    logged = []
    monkeypatch.setattr(port_cfg._logger(), "info", lambda msg: logged.append(str(msg)))
    port_cfg.entrypoint(["version"])
    assert logged[-1] == f"sar_yolo_tpu_torch {sar_yolo_tpu_torch.__version__}"
    port_cfg.entrypoint(["--help"])
    assert "TASK MODE" in logged[-1] and "copy-cfg" in logged[-1]
    port_cfg.entrypoint(["cfg"])
    assert yaml.safe_load(logged[-1]) == DEFAULT_CFG
    monkeypatch.chdir(tmp_path)
    path = port_cfg.entrypoint(["copy-cfg"])
    assert path == tmp_path / "default_copy.yaml"
    assert yaml.safe_load(path.read_text()) == DEFAULT_CFG
    info = port_cfg.entrypoint(["checks"])
    assert (info["torch"], info["cuda"]) == (torch.__version__, torch.version.cuda)
    assert info["device"] == (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                              else "cpu")
    for mode in ("login", "logout"):
        with pytest.raises(NotImplementedError, match="network clients"):
            port_cfg.entrypoint([mode, "key"])


def test_python_m_version_in_a_subprocess():
    env = {**os.environ, "SARYOLO_VERBOSE": "1", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-m", "sar_yolo_tpu_torch", "version"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        f"sar_yolo_tpu_torch {sar_yolo_tpu_torch.__version__}"


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_frames")
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate(((72, 128), (64, 64))):
        cells = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        cv2.imwrite(str(root / f"f{i}.png"), cv2.resize(cells, (w, h),
                                                        interpolation=cv2.INTER_NEAREST))
    return root


def test_cli_predict_rows_match_jax_cli(frames_dir, monkeypatch):
    """`detect predict model=tinydet.yaml source=... device=cpu` through both command lines,
    `YOLO` handing out one pair of models with the same numpy-filled weights (each package
    seeds its own otherwise)."""
    jyolo, pyolo = jax_and_port_yolo("tinydet.yaml", 3, cls_gain=3.0)
    devices = []

    def port_yolo(model, task=None, device=None):
        devices.append((model, task, device))
        return pyolo
    monkeypatch.setattr(sar_yolo_tpu, "YOLO", lambda model, task=None: jyolo, raising=False)
    monkeypatch.setattr(sar_yolo_tpu_torch, "YOLO", port_yolo, raising=False)
    argv = ["detect", "predict", "model=tinydet.yaml", f"source={frames_dir}", "imgsz=64",
            "conf=0.5", "max_det=20"]
    want = jax_cfg.entrypoint(argv)
    got = port_cfg.entrypoint(argv + ["device=cpu"])
    assert devices == [("tinydet.yaml", "detect", "cpu")]
    assert len(got) == len(want) == 2 and sum(len(r) for r in want) > 0
    for g, w in zip(got, want):
        assert str(g.path) == str(w.path) and len(g) == len(w)
        np.testing.assert_array_equal(g.boxes.data[:, 5], np.asarray(w.boxes.data)[:, 5])
        np.testing.assert_allclose(g.boxes.data[:, :5], np.asarray(w.boxes.data)[:, :5],
                                   rtol=0, atol=TOL)


def test_cli_needs_cuda_or_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cfg.entrypoint(["detect", "predict", "model=tinydet.yaml", f"source={tmp_path}"])
    # a key the port has not ported raises where the mode meets it, as get_cfg does
    with pytest.raises(NotImplementedError, match="simplify"):
        port_cfg.entrypoint(["detect", "val", "model=tinydet.yaml", "simplify=False",
                             "device=cpu"])
    with pytest.raises(NotImplementedError, match="keras"):
        port_cfg.entrypoint(["detect", "export", "model=tinydet.yaml", "keras=True",
                             "device=cpu"])
