"""The facade's remaining modes of the PyTorch port against the JAX package: `YOLO.embed`,
`YOLO.tune` (`engine/tuner.py`) and the built-in ASHA (`utils/tuner.py`), `YOLO.benchmark`
and `ProfileModels` (`utils/benchmarks.py`), `utils/mfu.py` and `batch=-1`
(`utils/autobatch.py`).

The same numpy-filled weights go through both packages. `embed`: the port serves the
BN-folded model where JAX applies the unfused variables, so the vectors are held within 1e-5
of each vector's largest magnitude (float32's folding error). The tuners with `train`
stubbed: the same children, draws, rungs and rows, bit for bit. `benchmark`: the native row's
mAP50-95 equals JAX's on ground truth planted at the model's own detections, and the `pt2`
and `onnx` artifacts' rows equal the native one's. autobatch: its arithmetic with the memory
functions stubbed, and 16 without device statistics, as JAX returns on the CPU.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.engine import tuner as port_tuner
from sar_yolo_tpu_torch.utils import autobatch, benchmarks, mfu
from sar_yolo_tpu_torch.utils import tuner as port_ray_tuner
from torch_port_common import jax_and_port_yolo, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EMBED_TOL = 1e-5


def _frames():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in ((72, 128), (64, 64))]


@pytest.fixture(scope="module")
def v13():
    return jax_and_port_yolo("yolov13n.yaml", 3)


@pytest.mark.parametrize("embed", [None, [4, 6], [-25]], ids=str)
def test_embed_matches_jax(v13, embed):
    jyolo, pyolo = v13
    frames = _frames()
    want = jyolo.embed(frames, embed=embed, imgsz=64)
    got = pyolo.embed(frames, embed=embed, imgsz=64)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.ndim == 1 and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=EMBED_TOL * np.abs(w).max())


def test_embed_stops_after_the_last_listed_layer(v13, monkeypatch):
    _, pyolo = v13
    model = pyolo._fused_for_serving()
    ran = []
    for i, blk in enumerate(model.blocks):
        blk.register_forward_hook(lambda m, a, o, i=i: ran.append(i))
    try:
        pyolo.embed(_frames()[1], embed=[6], imgsz=64)
    finally:
        for blk in model.blocks:
            blk._forward_hooks.clear()
    assert ran == list(range(7))


def test_embed_tiny_jde_over_a_video_matches_jax():
    """tinyjde at its default layer over the Motion-JPEG fixture (any predict source)."""
    jyolo, pyolo = jax_and_port_yolo("tinyjde.yaml", 3, bias_init=True)
    video = str(ROOT / "tests" / "data" / "video" / "flight.avi")
    want = jyolo.embed(video, imgsz=64)
    got = pyolo.embed(video, imgsz=64)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=EMBED_TOL * np.abs(np.asarray(w)).max())


def test_tuner_mutations_match_jax_bit_for_bit():
    from sar_yolo_tpu.engine.tuner import SPACE as JAX_SPACE
    from sar_yolo_tpu.engine.tuner import Tuner as JaxTuner
    assert port_tuner.SPACE == JAX_SPACE
    args = {"model": "tinydet.yaml", "task": "detect", "data": "synthetic", "seed": 5,
            "epochs": 1}
    jt, pt = JaxTuner(args), port_tuner.Tuner(args, device="cpu")
    parents = []
    for i in range(6):
        want, got = jt._mutate(parents[:5]), pt._mutate(parents[:5])
        assert got == want
        parents.append((0.1 * i + want["lr0"], want))
        parents.sort(key=lambda x: -x[0])


def _fitness(kw):  # deterministic in the hyperparameters, so rankings are testable
    return float(kw["lr0"] * 10 + kw["momentum"])


def test_tune_matches_jax_with_train_stubbed(monkeypatch, tmp_path):
    from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
    calls = {"jax": [], "port": []}
    for name, cls in (("jax", JaxYOLO), ("port", YOLO)):
        monkeypatch.setattr(cls, "train", lambda self, _n=name, **kw: (
            calls[_n].append(kw), {"fitness": _fitness(kw)})[1])
    kw = dict(data="synthetic", epochs=1, imgsz=32, seed=2)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = JaxYOLO("tinydet.yaml").tune(iterations=4, **kw)
    monkeypatch.chdir(tmp_path / "port")
    got = YOLO("tinydet.yaml", device="cpu").tune(iterations=4, **kw)
    assert got == want
    assert [{k: v for k, v in c.items() if k != "task"} for c in calls["port"]] == \
        [{k: v for k, v in c.items() if k not in ("task", "model", "mode")} for c in calls["jax"]]
    assert all(c["epochs"] == 1 and c["imgsz"] == 32 for c in calls["port"])

    def rows(path):
        with open(path) as f:
            return [[r[0], r[1], *r[3:]] for r in csv.reader(f)]  # without the seconds
    assert rows(tmp_path / "port" / "runs" / "tune" / "tune_results.csv") == \
        rows(tmp_path / "jax" / "runs" / "tune" / "tune_results.csv")


def test_builtin_asha_matches_jax(monkeypatch, tmp_path):
    """The JAX package's `test_run_ray_tune_builtin_asha` on the port, and its rows equal to
    JAX's: rungs at 1, 3, 9 epochs with 6 -> 2 -> 1 survivors."""
    from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
    from sar_yolo_tpu.utils import tuner as jax_ray_tuner
    calls = {"jax": [], "port": []}
    for name, cls in (("jax", JaxYOLO), ("port", YOLO)):
        monkeypatch.setattr(cls, "train", lambda self, _n=name, **kw: (
            calls[_n].append({"epochs": kw["epochs"], "lr0": kw["lr0"]}),
            {"fitness": kw["lr0"]})[1])
    kw = dict(grace_period=1, max_samples=6, data="synthetic", epochs=9, seed=0)
    want = jax_ray_tuner.run_ray_tune(JaxYOLO("tinydet.yaml"), project=str(tmp_path / "jax"),
                                      **kw)
    got = YOLO("tinydet.yaml", device="cpu").tune(use_ray=True, iterations=6,
                                                  project=str(tmp_path / "port"),
                                                  **{k: v for k, v in kw.items()
                                                     if k != "max_samples"})
    assert [c["epochs"] for c in calls["port"]] == [1] * 6 + [3] * 2 + [9]
    assert calls["port"] == calls["jax"]
    assert got == want
    assert got[0]["fitness"] == max(r["fitness"] for r in got)
    rung1 = sorted(calls["port"][:6], key=lambda c: -c["lr0"])
    assert {c["lr0"] for c in calls["port"][6:8]} == {c["lr0"] for c in rung1[:2]}
    assert port_ray_tuner.DEFAULT_SPACE == jax_ray_tuner.DEFAULT_SPACE
    with open(tmp_path / "port" / "ray_tune" / "asha_results.csv") as f:
        assert len(list(csv.reader(f))) == 1 + 6 + 2 + 1


class _Planted:
    """The benchmark's synthetic images with ground truth planted 1 px from detections."""

    def __init__(self, base, rows):
        self.base, self.rows = base, rows

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        item = dict(self.base[i])
        d = self.rows[i]
        M = len(item["mask"])
        b = d[:M, :4] - 1.0
        item["bboxes"] = np.zeros((M, 4), np.float32)
        item["bboxes"][:len(b)] = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                                            b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1) / 64
        item["cls"] = np.zeros(M, np.float32)
        item["cls"][:len(b)] = d[:M, 5]
        item["mask"] = (np.arange(M) < len(b)).astype(np.float32)
        return item


def test_benchmark_rows_match_jax(monkeypatch, tmp_path):
    from sar_yolo_tpu.utils import benchmarks as jax_benchmarks
    jyolo, pyolo = jax_and_port_yolo("tinydet.yaml", 3, calibrate=64)
    base = benchmarks._dataset_for(pyolo, None, 64)
    rows = [pyolo.predict(np.ascontiguousarray(base[i]["img"][..., ::-1]), imgsz=64,
                          conf=0.5)[0].boxes.data[:4] for i in range(len(base))]
    planted = _Planted(base, rows)
    monkeypatch.setattr(benchmarks, "_dataset_for", lambda *a: planted)
    monkeypatch.setattr(jax_benchmarks, "_dataset_for", lambda *a: planted)
    monkeypatch.chdir(tmp_path)
    want = jax_benchmarks.benchmark(jyolo, imgsz=64, n_iter=1, formats=(), verbose=False)
    got = pyolo.benchmark(imgsz=64, n_iter=1, formats=("pt2", "onnx", "stablehlo"),
                          verbose=False)
    assert [r["format"] for r in got] == ["torch", "pt2", "onnx", "stablehlo"]
    assert want[0]["mAP50-95"] > 0.1
    assert got[0]["mAP50-95"] == pytest.approx(want[0]["mAP50-95"], abs=1e-6)
    for r in got[1:3]:
        assert "error" not in r, r
        assert r["mAP50-95"] == pytest.approx(got[0]["mAP50-95"], abs=1e-6)
        assert r["size_mb"] > 0 and r["ms_per_image"] > 0 and r["fps"] > 0
    assert "pt2" in got[3]["error"]


def test_profile_models_and_sigma_clipping():
    from sar_yolo_tpu.utils.benchmarks import ProfileModels as JaxProfileModels
    rng = np.random.default_rng(0)
    for data in (rng.normal(5, 1, 50), np.r_[rng.normal(5, 0.1, 40), [50, 60, -30]],
                 np.full(7, 3.0)):
        np.testing.assert_array_equal(benchmarks.ProfileModels.iterative_sigma_clipping(data),
                                      JaxProfileModels.iterative_sigma_clipping(data))
    out = benchmarks.ProfileModels(["tinydet.yaml"], num_timed_runs=2, num_warmup_runs=1,
                                   min_time=0.0, imgsz=64, half=True, device="cpu").profile()
    (row,) = out
    yolo = YOLO("tinydet.yaml", device="cpu")
    assert row["model/name"] == "tinydet"
    assert row["model/parameters"] == sum(p.numel() for p in yolo.model.parameters())
    assert row["model/GFLOPs"] == pytest.approx(mfu.model_fwd_gflops(
        yolo._fused_for_serving(), 64), abs=1e-3)
    assert row["model/GFLOPs"] > 0 and row["model/speed_torch(ms)"] > 0


def test_mfu(monkeypatch):
    from sar_yolo_tpu.utils.mfu import mfu_pct as jax_mfu_pct
    assert mfu.chip_peak_bf16_tflops() is None if not torch.cuda.is_available() else True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0, _n=name: _n)
        assert mfu.chip_peak_bf16_tflops() == peak
    assert mfu.mfu_pct(1000.0, 8.7, 989.0) == jax_mfu_pct(1000.0, 8.7, 989.0)
    assert mfu.mfu_pct(1000.0, 8.7, 0.0) is None


def test_autobatch_arithmetic_and_cpu_default(monkeypatch):
    from sar_yolo_tpu.utils.autobatch import check_train_batch_size as jax_autobatch
    assert autobatch.check_train_batch_size(device="cpu") == 16 == jax_autobatch(2_600_000, 640)
    # a line through (2, 2 GiB) and (4, 3 GiB): 0.5 GiB an image over 1 GiB
    gib = 2 ** 30
    assert autobatch.batch_for((2, 4), (2 * gib, 3 * gib), 80 * gib) == 64  # 0.8 x 80: 126
    assert autobatch.batch_for((2, 4), (2 * gib, 3 * gib), 80 * gib, fixed=10 * gib) == 64
    assert autobatch.batch_for((2, 4), (2 * gib, 3 * gib), 80 * gib, fraction=0.5) == 64
    assert autobatch.batch_for((2, 4), (2 * gib, 3 * gib), 80 * gib, fraction=0.4) == 32
    assert autobatch.batch_for((2, 4), (2 * gib, 3 * gib), 1 * gib) == 1
    assert autobatch.batch_for((2, 4), (100, 100), 1e15) == 1024
    stats = {"mem_get_info": lambda d=None: (70 * gib, 80 * gib),
             "memory_reserved": lambda d=None: 6 * gib, "memory_allocated": lambda d=None: 1 * gib}
    for k, fn in stats.items():
        monkeypatch.setattr(torch.cuda, k, fn)
    probed = []

    def step_peak(b):
        probed.append(b)
        return int((1 + 0.5 * b) * gib)
    # free = 70 + 6 - 1 = 75 GiB; (60 - 2 - 1) / 0.5 = 114 -> 64
    assert autobatch.check_train_batch_size(step_peak, "cuda", fixed=2 * gib) == 64
    assert probed == list(autobatch.PROBE_BATCHES)


def test_train_batch_minus_one_on_the_cpu(tmp_path):
    yolo = YOLO("tinydet.yaml", device="cpu")
    yolo.train(data="synthetic", batch=-1, imgsz=32, epochs=1, val=False, workers=1,
               project=str(tmp_path))
    assert yolo.trainer.args.batch == 16 and yolo.trainer.nb == 4


def test_rf100_local_datasets_match_jax(tmp_path):
    import yaml

    from sar_yolo_tpu.utils.benchmarks import RF100Benchmark as JaxRF100Benchmark

    class Model:  # val's metrics by dataset; one dataset fails
        def val(self, data, imgsz, **kw):
            if "bad" in data:
                raise ValueError("no such dataset")
            return {"metrics/mAP50(B)": 0.25 + len(data) % 7 / 10}

    yamls = []
    for name in ("rivers", "bad", "roads"):
        (tmp_path / name).mkdir()
        path = tmp_path / name / "data.yaml"
        path.write_text("path: .\ntrain: images/train\nval: images/val\nnames:\n  0: person\n")
        yamls.append(path)
    logs, results = [], []
    for i, cls in enumerate((JaxRF100Benchmark, benchmarks.RF100Benchmark)):
        rf = cls()
        with pytest.raises(ModuleNotFoundError, match="roboflow"):
            rf.set_key("key")
        rf.add_local_datasets(yamls)
        results.append(rf.benchmark(Model(), eval_log_file=tmp_path / f"log{i}.txt", imgsz=64))
        logs.append((tmp_path / f"log{i}.txt").read_text())
    assert results[0] == results[1] and results[1]["bad"] is None and logs[0] == logs[1]
    want, got = tmp_path / "want.yaml", tmp_path / "got.yaml"
    for p in (want, got):
        p.write_text(yamls[0].read_text())
    JaxRF100Benchmark.fix_yaml(want)
    benchmarks.RF100Benchmark.fix_yaml(got)
    assert yaml.safe_load(got.read_text()) == yaml.safe_load(want.read_text())
