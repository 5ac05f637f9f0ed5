"""The detect train step of the PyTorch port against the JAX package's DetectionTrainer.

`test_yolov8n_loss_and_first_step_gradient_match_jax`: yolov8n (nc 3 on the synthetic
set) at 64 px, batch 2, from the same `fill_variables` weights with the head's bias
init, on the JAX loader's first batch: the loss items (box, cls, dfl) within 1e-5
relative or 4 times the spread of JAX's own items under 1e-7 relative weight
perturbations, whichever is larger (at 64 px the box and DFL items are ~2e-4: few
anchors overlap a ground truth, and JAX's items move by ~1e-5 of themselves under
that perturbation), and the whole first-step gradient of a float64 copy of the port within 1e-3
relative L2 of JAX's float32 gradient, each tensor within 1e-4 of its largest magnitude
or 4 times the spread of JAX's own gradient under 1e-7 relative weight perturbations,
whichever is larger (as `test_torch_port_train_v13.py` holds yolov13n-JDE's).

`test_tinydet_three_steps_match_jax`: 3 SGD steps of tinydet against the JAX train step,
held as `test_torch_port_train.py` holds the tinyjde trajectory.

`test_yolo_train_detect_with_amp`: `YOLO.train` of yolov12n with bf16 compute forced on
the CPU: `check_bf16` passes on the detect model, the run keeps bf16 and its losses and
validation are finite.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.utils.loss import detection_loss
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.engine import trainer as trainer_module
from sar_yolo_tpu_torch.engine.trainer import DetectionTrainer, JDETrainer
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import (assert_trajectories_match, jax_jde_trainer,  # noqa: F401
                               one_torch_thread, port_trainer_like)


def _common(model: str, **kw) -> dict:
    return dict(model=model, data="synthetic", imgsz=64, batch=2, nbs=2, workers=1,
                max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0, **kw)


def _jax_overrides(common: dict, tmp_path) -> dict:
    return {**common, "mesh_shape": [1], "plots": False, "val": False, "save": False,
            "project": str(tmp_path)}


def test_yolov8n_loss_and_first_step_gradient_match_jax(tmp_path, monkeypatch):
    common = _common("yolov8n.yaml", lr0=1e-4)
    jtr = jax_jde_trainer(_jax_overrides(common, tmp_path), seed=11, monkeypatch=monkeypatch,
                          task="detect")
    assert jtr.meta["nc"] == 3 and jtr.task == "detect"
    jtr.train_loader.set_epoch(0)
    batch = next(iter(jtr.train_loader))
    assert "tags" not in batch
    meta, batch_stats = jtr.meta, jtr.state.batch_stats
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        feats, _ = jtr.model.apply({"params": params, "batch_stats": batch_stats},
                                   jb["img"].astype(jnp.float32) / 255.0, train=True,
                                   mutable=["batch_stats"])
        out = detection_loss(feats, jb, jtr.args, nc=meta["nc"], reg_max=meta["reg_max"],
                             strides=tuple(meta["strides"]))
        return out.total, out.items

    grad = jax.jit(jax.grad(loss, has_aux=True))
    params = jax.device_get(jtr.state.params)
    jgrad, jitems = grad(params)
    want = from_jax_variables({"params": jax.device_get(jgrad)})
    rng = np.random.default_rng(0)
    runs = [grad(jax.tree.map(
        lambda p: (p * (1 + 1e-7 * rng.standard_normal(p.shape))).astype(np.float32), params))
        for _ in range(3)]
    perturbed = [from_jax_variables({"params": jax.device_get(g)}) for g, _ in runs]
    item_spread = np.max([np.abs(np.asarray(i) - np.asarray(jitems)) for _, i in runs], 0)

    ptr = port_trainer_like(jtr, common)
    assert isinstance(ptr, DetectionTrainer) and ptr.loss_names == ("box", "cls", "dfl")
    b = ptr.to_device(batch)
    total, items, _ = ptr.loss(ptr.model(b["img"]), b)
    err = np.abs(items.numpy() - np.asarray(jitems))
    assert (err <= np.maximum(1e-5 * np.abs(np.asarray(jitems)), 4 * item_spread)).all(), \
        (items, jitems, item_spread)
    assert (items > 0).all()
    model = copy.deepcopy(ptr.model).double()
    ptr.loss(model(b["img"].double()), b)[0].backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()

    def flat(g):
        return torch.cat([g[n].double().flatten() for n in got])

    rel_l2 = ((flat(got) - flat(want)).norm() / flat(want).norm()).item()
    assert rel_l2 < 1e-3, f"gradient {rel_l2:.3g} from JAX's (relative L2)"
    for name, w in want.items():
        w = w.double()
        spread = max((q[name].double() - w).abs().max().item() for q in perturbed)
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=max(1e-4 * w.abs().max().item(), 4 * spread),
                                   err_msg=f"gradient of {name}")


def test_tinydet_three_steps_match_jax(tmp_path, monkeypatch):
    common = _common("tinydet.yaml", lr0=1e-3)
    jtr = jax_jde_trainer(_jax_overrides(common, tmp_path), seed=11, monkeypatch=monkeypatch,
                          task="detect")
    ptr = port_trainer_like(jtr, common)
    assert isinstance(ptr, DetectionTrainer) and ptr.cb_counts.shape == (1,)
    assert_trajectories_match(jtr, ptr, steps=3)


def test_trainer_refuses_a_model_of_another_task(tmp_path):
    with pytest.raises(ValueError, match="is a detect model, not a jde model"):
        JDETrainer({"model": "tinydet.yaml", "project": str(tmp_path)}, device="cpu").setup()


def test_yolo_train_detect_with_amp(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "amp_dtype", lambda args, device: torch.bfloat16)
    seen = []
    check = trainer_module.check_bf16
    monkeypatch.setattr(trainer_module, "check_bf16",
                        lambda model, imgsz=64: seen.append(check(model, imgsz)) or seen[-1])
    m = YOLO("yolov12n.yaml", device="cpu")
    metrics = m.train(data="synthetic", imgsz=64, batch=4, epochs=1, workers=0, max_labels=16,
                      project=str(tmp_path))
    assert seen == [True]
    assert m.trainer.model.compute_dtype == torch.bfloat16
    assert {"train/box", "train/cls", "train/dfl", "fitness"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    assert m.task == "detect" and m.meta["nc"] == 3
