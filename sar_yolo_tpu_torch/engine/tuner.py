"""Hyperparameter tuner: mutation-based evolution over repeated train runs (port of
`sar_yolo_tpu/engine/tuner.py`): each iteration mutates a parent drawn with probability in
proportion to its fitness from the best five so far (the defaults before the first), trains a
new model with the user's train settings and the child's hyperparameters, and appends a row to
`save_dir/tune_results.csv`. A trial that raises scores 0."""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.utils import LOGGER

# (min, max, gain) of each mutated hyperparameter, the JAX package's space
SPACE = {
    "lr0": (1e-5, 1e-1, 1.0),
    "lrf": (0.0001, 0.1, 1.0),
    "momentum": (0.7, 0.98, 0.3),
    "weight_decay": (0.0, 0.001, 1.0),
    "warmup_epochs": (0.0, 5.0, 1.0),
    "warmup_momentum": (0.0, 0.95, 1.0),
    "box": (1.0, 20.0, 1.0),
    "cls": (0.2, 4.0, 1.0),
    "dfl": (0.4, 6.0, 1.0),
    "hsv_h": (0.0, 0.1, 1.0),
    "hsv_s": (0.0, 0.9, 1.0),
    "hsv_v": (0.0, 0.9, 1.0),
    "degrees": (0.0, 45.0, 1.0),
    "translate": (0.0, 0.9, 1.0),
    "scale": (0.0, 0.9, 1.0),
    "shear": (0.0, 10.0, 1.0),
    "perspective": (0.0, 0.001, 1.0),
    "flipud": (0.0, 1.0, 1.0),
    "fliplr": (0.0, 1.0, 1.0),
    "mosaic": (0.0, 1.0, 1.0),
    "mixup": (0.0, 1.0, 1.0),
    "copy_paste": (0.0, 1.0, 1.0),
}


class Tuner:
    """`Tuner(train_args, save_dir, device)(iterations=10)` -> (best fitness, its
    hyperparameters); every trial is a new `YOLO(train_args["model"], task, device)`."""

    def __init__(self, args: dict | None = None, save_dir: str | Path = "runs/tune",
                 device=None):
        self._overrides = {k: v for k, v in dict(args or {}).items()
                           if k not in ("model", "task", "mode", "iterations")}
        self.args = get_cfg({k: v for k, v in dict(args or {}).items()
                             if k not in ("mode", "iterations")})
        self.save_dir = Path(save_dir)
        self.csv = self.save_dir / "tune_results.csv"
        self.rng = np.random.default_rng(self.args.seed)
        self.device = device

    def _mutate(self, parents: list[tuple[float, dict]], mutation=0.8, sigma=0.2) -> dict:
        """A child of a fitness-weighted draw among `parents` (the defaults if none): each
        key multiplied by 1 + N(0, sigma) gain with probability `mutation`, then clipped to
        its bounds."""
        if parents:
            fits = np.array([max(f, 1e-6) for f, _ in parents])
            probs = fits / fits.sum()
            base = parents[int(self.rng.choice(len(parents), p=probs))][1]
        else:
            base = {k: getattr(self.args, k) for k in SPACE}
        child = {}
        for k, (lo, hi, gain) in SPACE.items():
            v = float(base.get(k, lo))
            if self.rng.random() < mutation:
                v *= float(1 + self.rng.normal(0, sigma) * gain)
            child[k] = float(np.clip(v, lo, hi))
        return child

    def __call__(self, model=None, iterations: int = 10, **train_kwargs):
        """Run `iterations` mutated trainings; returns (best_fitness, best_hyp)."""
        from sar_yolo_tpu_torch.engine.model import YOLO
        self.save_dir.mkdir(parents=True, exist_ok=True)
        parents: list[tuple[float, dict]] = []
        best = (-1.0, {})
        for it in range(iterations):
            hyp = self._mutate(parents[:5])
            t0 = time.time()
            m = YOLO(self.args.model or "yolov8n.yaml", task=self.args.task, device=self.device)
            try:
                metrics = m.train(**{**self._overrides, **train_kwargs, **hyp})
                fitness = float(metrics.get("fitness", 0.0))
            except Exception as e:  # noqa: BLE001 — a failed trial scores 0
                LOGGER.warning(f"tune iteration {it} failed: {e}")
                fitness = 0.0
            parents.append((fitness, hyp))
            parents.sort(key=lambda x: -x[0])
            if fitness > best[0]:
                best = (fitness, hyp)
            write_header = not self.csv.exists()
            with self.csv.open("a", newline="") as f:
                w = csv.writer(f)
                if write_header:
                    w.writerow(["iteration", "fitness", "seconds", *SPACE.keys()])
                w.writerow([it, fitness, round(time.time() - t0, 1), *[hyp[k] for k in SPACE]])
            LOGGER.info(f"tune {it + 1}/{iterations}: fitness={fitness:.4f} best={best[0]:.4f}")
        return best
