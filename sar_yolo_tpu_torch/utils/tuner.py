"""ASHA hyperparameter search (port of `sar_yolo_tpu/utils/tuner.py`'s `run_ray_tune` and its
built-in scheduler): uniform draws over the training space, then successive halving: rung k
trains the survivors from scratch for grace_period * 3^k epochs (the last rung the full
`epochs`) and keeps the top third, one trial after another on the model's device. The JAX
package hands the search to Ray Tune where `ray[tune]` imports; the port always runs the
built-in scheduler (Ray is not installed where the port runs). Every trial appends a row to
`project/ray_tune/asha_results.csv`.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.utils import LOGGER

# uniform search space, the JAX package's default_space
DEFAULT_SPACE = {
    "lr0": (1e-5, 1e-1),
    "lrf": (0.01, 1.0),
    "momentum": (0.6, 0.98),
    "weight_decay": (0.0, 0.001),
    "warmup_epochs": (0.0, 5.0),
    "warmup_momentum": (0.0, 0.95),
    "box": (0.02, 0.2),
    "cls": (0.2, 4.0),
    "hsv_h": (0.0, 0.1),
    "hsv_s": (0.0, 0.9),
    "hsv_v": (0.0, 0.9),
    "degrees": (0.0, 45.0),
    "translate": (0.0, 0.9),
    "scale": (0.0, 0.9),
    "shear": (0.0, 10.0),
    "perspective": (0.0, 0.001),
    "flipud": (0.0, 1.0),
    "fliplr": (0.0, 1.0),
    "mosaic": (0.0, 1.0),
    "mixup": (0.0, 1.0),
    "copy_paste": (0.0, 1.0),
}


def run_ray_tune(model, space: dict | None = None, grace_period: int = 10,
                 gpu_per_trial: int | None = None, max_samples: int = 10, **train_args):
    """ASHA over `space` ({name: (lo, hi)}) for a YOLO facade `model`: `max_samples` configs
    drawn from default_rng(seed); returns [{"config", "fitness", "epochs"}] best first.
    `gpu_per_trial` is accepted and unread (one trial at a time on the model's device)."""
    LOGGER.info("ASHA: the built-in sequential scheduler (same space, same rung semantics)")
    return _builtin_asha(model, space or dict(DEFAULT_SPACE), grace_period, max_samples,
                         train_args)


def _builtin_asha(model, space, grace_period, max_samples, train_args,
                  reduction_factor: int = 3):
    """Sequential successive halving: rung k trains survivors from scratch at
    grace_period * rf^k epochs and promotes the top 1/rf."""
    from sar_yolo_tpu_torch.engine.model import YOLO
    model_yaml = model.overrides.get("model") or getattr(model, "cfg", None) or "yolov8n.yaml"
    task, device = model.task, model.device
    max_epochs = int(train_args.get("epochs", 100))
    rng = np.random.default_rng(int(train_args.get("seed", 0)))
    configs = [{k: float(rng.uniform(lo, hi)) for k, (lo, hi) in space.items()}
               for _ in range(max_samples)]

    save_dir = Path(train_args.get("project") or "runs") / "ray_tune"
    save_dir.mkdir(parents=True, exist_ok=True)
    csv_path = save_dir / "asha_results.csv"

    rungs = []
    budget = grace_period
    while budget < max_epochs:
        rungs.append(budget)
        budget *= reduction_factor
    rungs.append(max_epochs)

    alive = list(range(len(configs)))
    history = {i: {"config": configs[i], "fitness": 0.0, "epochs": 0} for i in alive}
    with csv_path.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["rung_epochs", "trial", "fitness", "seconds", *space.keys()])
        for budget in rungs:
            scores = []
            for i in alive:
                t0 = time.time()
                m = YOLO(model_yaml, task=task, device=device)
                try:
                    metrics = m.train(**{**train_args, **configs[i], "epochs": budget})
                    fit = float(metrics.get("fitness", 0.0))
                except Exception as e:  # noqa: BLE001 — a failed trial scores 0
                    LOGGER.warning(f"ASHA trial {i} @ {budget} epochs failed: {e}")
                    fit = 0.0
                history[i] = {"config": configs[i], "fitness": fit, "epochs": budget}
                scores.append((fit, i))
                writer.writerow([budget, i, fit, round(time.time() - t0, 1),
                                 *[configs[i][k] for k in space]])
                f.flush()
                LOGGER.info(f"ASHA rung {budget}ep trial {i}: fitness={fit:.4f}")
            if budget == rungs[-1]:
                break
            scores.sort(reverse=True)
            keep = max(1, len(scores) // reduction_factor)
            alive = [i for _, i in scores[:keep]]
    rows = sorted(history.values(), key=lambda r: -r["fitness"])
    LOGGER.info(f"ASHA best: fitness={rows[0]['fitness']:.4f} @ {rows[0]['epochs']} epochs "
                f"-> {csv_path}")
    return rows
