"""`YOLO.benchmark`, `ProfileModels` and `RF100Benchmark` (port of
`sar_yolo_tpu/utils/benchmarks.py`).

`benchmark` gives the native row, then one row per export format: the artifact is written
(`YOLO.export`), reloaded through `YOLO(artifact)` (`nn/autobackend.py`), timed, and scored
(mAP50-95) on the same dataset as the native model; a format that fails becomes an error row.
The port's formats are `pt2` and `onnx`; the JAX package's `stablehlo`, `saved_model` and
`tflite` give the exporter's error row. `ProfileModels` times the deploy-fused (optionally
bf16) forward with CUDA events on the card (the host clock on the CPU), sigma-clipped as the
JAX package does; its GFLOPs are `torch.utils.flop_counter.FlopCounterMode`'s count of one
forward (convolutions and matmuls), where JAX reads XLA's cost analysis. `RF100Benchmark`
validates a list of local dataset YAML files; the Roboflow download is not ported.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from sar_yolo_tpu_torch.utils import LOGGER


def _dataset_for(model, data, imgsz):
    from sar_yolo_tpu_torch.data.dataset import SyntheticDataset, YOLODataset, check_det_dataset
    if data in (None, "synthetic"):
        return SyntheticDataset(n=8, imgsz=imgsz, nc=min(model.meta["nc"], 3), max_labels=16,
                                seed=1)
    info = check_det_dataset(data)
    return YOLODataset(info.get("val") or info["train"], imgsz=imgsz, augment=False,
                       max_labels=64)


def _map_over_dataset(predict_fn, dataset, imgsz):
    """mAP50-95 of a predict callable over a padded-label dataset."""
    from sar_yolo_tpu_torch.utils.metrics import DetMetrics, match_predictions
    dm = DetMetrics()
    for i in range(len(dataset)):
        s = dataset[i]
        img = np.ascontiguousarray(s["img"][..., ::-1])  # RGB -> BGR frame
        res = predict_fn(img)
        d = res[0].boxes.data[:, :6] if res[0].boxes is not None else np.zeros((0, 6))
        gm = s["mask"] > 0
        h, w = img.shape[:2]
        gb = s["bboxes"][gm] * np.array([w, h, w, h])
        gt = np.stack([gb[:, 0] - gb[:, 2] / 2, gb[:, 1] - gb[:, 3] / 2,
                       gb[:, 0] + gb[:, 2] / 2, gb[:, 1] + gb[:, 3] / 2], 1) \
            if len(gb) else np.zeros((0, 4), np.float32)
        gc = s["cls"][gm]
        tp = match_predictions(d[:, :4], d[:, 5], gt, gc)
        dm.update(tp, d[:, 4], d[:, 5], gc)
    return dm.process().get("metrics/mAP50-95(B)")


def _size_mb(path):
    p = Path(path)
    if p.is_file():
        return p.stat().st_size / 1e6
    if p.is_dir():
        return sum(f.stat().st_size for f in p.rglob("*") if f.is_file()) / 1e6
    return None


def benchmark(model, imgsz: int = 640, data: str | None = None, n_iter: int = 10,
              formats=("pt2", "onnx"), verbose: bool = True, half: bool = False,
              int8: bool = False, device=None):
    """Rows {format, size_mb, mAP50-95, ms_per_image, fps} of the native model ('torch')
    and of each format's artifact, reloaded on `device` (default: the model's); a failing
    format gives {format, error}. The latency is the host clock over `n_iter` predicts of
    one random imgsz x imgsz frame after one warm-up; mAP50-95 is over `data` (default:
    8 synthetic images) at conf 0.01. `half` and `int8` are accepted and unread, as in the
    JAX package."""
    from sar_yolo_tpu_torch.engine.model import YOLO
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (imgsz, imgsz, 3), dtype=np.uint8)
    dataset = _dataset_for(model, data, imgsz)
    device = device or model.device
    rows = []

    def time_predict(m):
        m.predict(img, imgsz=imgsz)  # warm-up
        t0 = time.perf_counter()
        for _ in range(n_iter):
            m.predict(img, imgsz=imgsz)
        return (time.perf_counter() - t0) / n_iter

    dt = time_predict(model)
    rows.append({"format": "torch", "size_mb": None, "ms_per_image": dt * 1e3, "fps": 1.0 / dt,
                 "mAP50-95": _map_over_dataset(
                     lambda im: model.predict(im, imgsz=imgsz, conf=0.01), dataset, imgsz)})
    for fmt in formats:
        try:
            path = model.export(format=fmt, imgsz=imgsz)
            m2 = YOLO(path, device=device)
            dt = time_predict(m2)
            rows.append({"format": fmt, "size_mb": _size_mb(path), "ms_per_image": dt * 1e3,
                         "fps": 1.0 / dt, "mAP50-95": _map_over_dataset(
                             lambda im: m2.predict(im, conf=0.01), dataset, imgsz)})
        except Exception as e:  # noqa: BLE001 — benchmark rows degrade gracefully
            rows.append({"format": fmt, "error": str(e)[:120]})

    if verbose:
        LOGGER.info(f"{'Format':<12} {'Size(MB)':>9} {'mAP50-95':>9} {'ms/im':>8} {'FPS':>8}")
        for r in rows:
            if "error" in r:
                LOGGER.info(f"{r['format']:<12} ERROR: {r['error']}")
            else:
                size = f"{r['size_mb']:.1f}" if r["size_mb"] else "-"
                m = f"{r['mAP50-95']:.3f}" if r["mAP50-95"] is not None else "-"
                LOGGER.info(f"{r['format']:<12} {size:>9} {m:>9} {r['ms_per_image']:>8.1f} "
                            f"{r['fps']:>8.1f}")
    return rows


class ProfileModels:
    """Latency and FLOPs of a list of models (model YAML names or files, checkpoint
    directories, folders and globs of them): each served deploy-fused (BN folded; bf16 on the
    card with `half`) on `device` (default: the card).

        ProfileModels(["yolov8n.yaml", "yolov13n-JDE.yaml"], imgsz=640).profile()
    """

    def __init__(self, paths, num_timed_runs: int = 100, num_warmup_runs: int = 10,
                 min_time: float = 10.0, imgsz: int = 640, half: bool = True,
                 batch: int = 1, device=None):
        self.paths = [paths] if isinstance(paths, (str, Path)) else list(paths)
        self.num_timed_runs = num_timed_runs
        self.num_warmup_runs = num_warmup_runs
        self.min_time = min_time
        self.imgsz = imgsz
        self.half = half
        self.batch = batch
        self.device = device

    def get_files(self):
        """Folders and globs expanded into model YAML files and checkpoint directories."""
        import glob

        from sar_yolo_tpu_torch.utils.checkpoint import is_checkpoint
        files = []
        for p in self.paths:
            p = Path(p)
            if is_checkpoint(p):
                files.append(p)
            elif p.is_dir():
                files.extend(sorted(p.glob("*.yaml")))
                files.extend(d for d in sorted(p.iterdir()) if is_checkpoint(d))
            elif p.suffix in {".yaml", ".yml"} or p.exists():
                files.append(p)
            else:
                files.extend(Path(f) for f in sorted(glob.glob(str(p))))
        LOGGER.info(f"Profiling: {[str(f) for f in files]}")
        return files

    @staticmethod
    def iterative_sigma_clipping(data, sigma: float = 2.0, max_iters: int = 3):
        """The samples within `sigma` standard deviations of the mean, iterated."""
        data = np.asarray(data, np.float64)
        for _ in range(max_iters):
            mean, std = data.mean(), data.std()
            keep = data[(data > mean - sigma * std) & (data < mean + sigma * std)]
            if len(keep) == len(data) or len(keep) == 0:
                break
            data = keep
        return data

    def _profile_model(self, yolo):
        """(mean ms, std ms, parameters, GFLOPs) of the deploy-fused forward of a batch."""
        from sar_yolo_tpu_torch.engine.model import _meta_copy
        net = yolo._fused_for_serving(self.half)
        dtype = getattr(net, "compute_dtype", torch.float32)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            _meta_copy(net)(torch.zeros(self.batch, 3, self.imgsz, self.imgsz, device="meta",
                                        dtype=dtype))
        gflops = counter.get_total_flops() / 1e9
        params = sum(p.numel() for p in yolo.model.parameters())
        x = torch.zeros(self.batch, 3, self.imgsz, self.imgsz, device=yolo.device, dtype=dtype)
        cuda = yolo.device.type == "cuda"

        @torch.no_grad()
        def run_once():
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                net(x)
                end.record()
                end.synchronize()
                return start.elapsed_time(end)
            t0 = time.perf_counter()
            net(x)
            return (time.perf_counter() - t0) * 1e3

        elapsed = sum(run_once() for _ in range(max(self.num_warmup_runs, 1))) / 1e3
        per_run = elapsed / max(self.num_warmup_runs, 1)
        num_runs = max(int(round(self.min_time / max(per_run, 1e-6))), self.num_timed_runs)
        times = self.iterative_sigma_clipping([run_once() for _ in range(num_runs)])
        return float(times.mean()), float(times.std()), params, gflops

    def generate_table_row(self, name, t, params, gflops):
        return (f"| {name:18s} | {self.imgsz} | {t[0]:.2f}±{t[1]:.2f} ms | "
                f"{params / 1e6:.1f} | {gflops:.1f} |")

    @staticmethod
    def generate_results_dict(name, t, params, gflops):
        return {"model/name": name, "model/parameters": params,
                "model/GFLOPs": round(gflops, 3),
                "model/speed_torch(ms)": round(t[0], 3),
                "model/speed_torch_std(ms)": round(t[1], 3)}

    def profile(self):
        """Profile every model, log the markdown table and return the result dicts; a model
        that fails is logged and skipped."""
        from sar_yolo_tpu_torch.engine.model import YOLO
        rows, output = [], []
        for f in self.get_files():
            try:
                yolo = YOLO(str(f), device=self.device)
                mean, std, params, gflops = self._profile_model(yolo)
            except Exception as e:  # noqa: BLE001 — one bad model must not kill the sweep
                LOGGER.warning(f"ProfileModels: {f} failed: {e}")
                continue
            rows.append(self.generate_table_row(Path(f).stem, (mean, std), params, gflops))
            output.append(self.generate_results_dict(Path(f).stem, (mean, std), params, gflops))
        if rows:
            dev = torch.cuda.get_device_name(0) if str(self.device or "cuda").startswith("cuda") \
                else str(self.device)
            LOGGER.info(f"\n| Model | size<br><sup>(pixels) | Speed<br><sup>{dev} "
                        f"(ms) | params<br><sup>(M) | FLOPs<br><sup>(B) |\n"
                        f"|-------|-------|-------|-------|-------|")
            for r in rows:
                LOGGER.info(r)
        return output


class RF100Benchmark:
    """Validation over several local datasets, one mAP50 each in an eval log. The
    Roboflow-100 download (`set_key`, `parse_dataset`) needs the `roboflow` SDK and the
    network, neither of which the port uses: register downloaded dataset YAML files with
    `add_local_datasets`."""

    def __init__(self):
        self.ds_names: list[str] = []
        self.ds_cfg_list: list[Path] = []
        self.val_metrics = ["class", "images", "targets", "precision", "recall",
                            "map50", "map95"]

    def set_key(self, api_key: str):
        raise ModuleNotFoundError("required package 'roboflow' is not installed: the "
                                  "Roboflow download is not part of this port (ROADMAP.md "
                                  "Queue A, network clients); use add_local_datasets")

    def parse_dataset(self, ds_link_txt: str = "datasets_links.txt"):
        self.set_key("")

    def add_local_datasets(self, yaml_paths):
        """Register already-downloaded dataset YAML files."""
        for p in yaml_paths:
            p = Path(p)
            self.ds_names.append(p.parent.name or p.stem)
            self.ds_cfg_list.append(p)
        return self.ds_names, self.ds_cfg_list

    @staticmethod
    def fix_yaml(path):
        """Point a Roboflow data.yaml's train and val at train/images and valid/images (the
        two top-level lines rewritten, or added)."""
        p = Path(path)
        lines = p.read_text().splitlines()
        new = {"train": "train/images", "val": "valid/images"}
        out = []
        for line in lines:
            key = line.split(":", 1)[0]
            if key in new and not line.startswith((" ", "\t")):
                out.append(f"{key}: {new.pop(key)}")
            else:
                out.append(line)
        out += [f"{k}: {v}" for k, v in new.items()]
        p.write_text("\n".join(out) + "\n")

    def evaluate(self, yaml_path, model, eval_log_file, list_ind: int,
                 imgsz: int = 640, **val_kwargs):
        """Validate `model` on one dataset and append `name: mAP50` to the eval log."""
        metrics = model.val(data=str(yaml_path), imgsz=imgsz, **val_kwargs)
        map50 = float(metrics.get("metrics/mAP50(B)", 0.0))
        with open(eval_log_file, "a") as f:
            f.write(f"{self.ds_names[list_ind]}: {map50}\n")
        return map50

    def benchmark(self, model, eval_log_file="rf100_eval.txt", imgsz: int = 640,
                  **val_kwargs):
        """`evaluate` over every registered dataset; {name: mAP50, or None where it failed}."""
        results = {}
        for i, cfg in enumerate(self.ds_cfg_list):
            try:
                results[self.ds_names[i]] = self.evaluate(
                    cfg, model, eval_log_file, i, imgsz=imgsz, **val_kwargs)
            except Exception as e:  # noqa: BLE001 — keep sweeping remaining datasets
                LOGGER.warning(f"RF100Benchmark: {cfg} failed: {e}")
                results[self.ds_names[i]] = None
        return results
