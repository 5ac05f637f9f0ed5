"""The JDE train step of the PyTorch port against the JAX package (tinyjde).

Train-mode BatchNorm against `flax.linen.BatchNorm`; the defaults against
`default.yaml`; the synthetic data and the loader's order; the lr and momentum
schedules, the three param groups and the SGD / AdamW updates (clip active,
accumulation) against `build_optimizer`; 10 train steps under SGD and under
AdamW against `JDETrainer._train_step`; `YOLO.train` then `predict_batched`.

Tolerances: loss values and schedules 1e-5 relative; outputs, gradients,
parameters, EMA and BN statistics 1e-4 of each tensor's largest magnitude.
Dropout is off on both sides in the parity cases (no RNG stream matches
JAX's); `test_dropout_*` checks the port's own.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data.build import DataLoader as JaxDataLoader
from sar_yolo_tpu.data.dataset import SyntheticDataset as JaxSyntheticDataset
from sar_yolo_tpu.engine.trainer import _group_labels, build_optimizer
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.utils import ROOT as JAX_ROOT
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.cfg.default import DEFAULT_CFG, get_cfg
from sar_yolo_tpu_torch.data.build import DataLoader
from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
from sar_yolo_tpu_torch.engine.trainer import Optimizer, group_label
from sar_yolo_tpu_torch.nn.modules.conv import BatchNorm2d, Dropout, set_generator
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import (assert_trajectories_match, close_to_max, fill_variables,  # noqa: F401
                               jax_jde_trainer, one_torch_thread, port_trainer_like)


def test_train_mode_batchnorm_matches_flax():
    rng = np.random.default_rng(0)
    # half the channels with |mean| = 10 std (Flax's E[x^2] - E[x]^2 loses digits there);
    # the running variance must be the biased one (torch's stock BatchNorm is 0.8% off)
    x = (3.0 + rng.normal(0, 0.3, (4, 5, 6, 8))).astype(np.float32)  # NHWC
    x[..., :4] = rng.normal(0, 2, (4, 5, 6, 4))
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(0, 0.1, 8).astype(np.float32)
    mean0, var0 = rng.normal(0, 0.1, 8).astype(np.float32), rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    w = rng.normal(size=x.shape).astype(np.float32)

    def jf(xx, params):
        y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return (y * w).sum(), (y, mut["batch_stats"])
    (_, (want, stats)), (jgx, jgp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables["params"])

    pbn = BatchNorm2d(8, eps=1e-3, momentum=0.03).train()
    with torch.no_grad():
        pbn.weight.copy_(torch.tensor(scale))
        pbn.bias.copy_(torch.tensor(bias))
        pbn.running_mean.copy_(torch.tensor(mean0))
        pbn.running_var.copy_(torch.tensor(var0))
    xt = torch.tensor(x.transpose(0, 3, 1, 2)).requires_grad_()
    y = pbn(xt)
    (y * torch.tensor(w.transpose(0, 3, 1, 2))).sum().backward()
    close_to_max(y.detach().numpy().transpose(0, 2, 3, 1), want, "output")
    close_to_max(pbn.running_mean.numpy(), stats["mean"], "running mean")
    close_to_max(pbn.running_var.numpy(), stats["var"], "running var")
    close_to_max(xt.grad.numpy().transpose(0, 2, 3, 1), jgx, "input gradient")
    close_to_max(pbn.weight.grad.numpy(), jgp["scale"], "scale gradient")
    close_to_max(pbn.bias.grad.numpy(), jgp["bias"], "bias gradient")
    # eval mode normalizes with the running statistics
    pbn.eval()
    bn_eval = fnn.BatchNorm(use_running_average=True, momentum=0.97, epsilon=1e-3)
    want_eval = bn_eval.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
    close_to_max(pbn(xt).detach().numpy().transpose(0, 2, 3, 1), want_eval, "eval output")


def test_defaults_match_default_yaml():
    jax_defaults = yaml.safe_load((JAX_ROOT / "cfg" / "default.yaml").read_text())
    assert {k: jax_defaults[k] for k in DEFAULT_CFG} == DEFAULT_CFG
    args = get_cfg({"batch": 4, "optimizer": "SGD"})
    assert (args.batch, args.optimizer, args.lr0) == (4, "SGD", 0.01)
    with pytest.raises(KeyError, match="lr_0"):
        get_cfg({"lr_0": 0.1})


@pytest.mark.parametrize("task", ["detect", "jde"])
def test_synthetic_dataset_matches_jax(task):
    want = JaxSyntheticDataset(n=6, imgsz=64, nc=3, max_labels=8, task=task, seed=2)
    got = SyntheticDataset(n=6, imgsz=64, nc=3, max_labels=8, task=task, seed=2)
    assert len(got) == len(want)
    for i in range(len(want)):
        w, g = want[i], got[i]
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"item {i} key {k}")
            assert g[k].dtype == w[k].dtype


def test_loader_order_matches_jax():
    ds = JaxSyntheticDataset(n=11, imgsz=32, nc=3, max_labels=8, task="jde")
    want = JaxDataLoader(ds, batch_size=3, shuffle=True, workers=2, seed=5)
    got = DataLoader(SyntheticDataset(n=11, imgsz=32, nc=3, max_labels=8, task="jde"),
                     batch_size=3, workers=2, seed=5)
    assert len(got) == len(want) == 3  # the partial batch is dropped
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        wb, gb = list(want), list(got)
        assert len(wb) == len(gb) == 3
        for w, g in zip(wb, gb):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def _args(**kw):
    base = dict(batch=2, nbs=2, epochs=3, lr0=0.01, lrf=0.01, momentum=0.937,
                weight_decay=0.0005, warmup_epochs=3.0, warmup_momentum=0.8, warmup_bias_lr=0.1,
                cos_lr=False, optimizer="SGD")
    base.update(kw)
    return jax_get_cfg(overrides=base), get_cfg(base)


def _tiny_params(seed=0):
    model, _ = jax_build_model("tinyjde.yaml")
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    return fill_variables(shapes, np.random.default_rng(seed))["params"]


@pytest.mark.parametrize("cos_lr,warmup_epochs,optimizer,nbs",
                         [(False, 3.0, "SGD", 2), (True, 3.0, "AdamW", 2), (True, 0.0, "SGD", 2),
                          (False, 3.0, "SGD", 8)],
                         ids=["linear", "cos", "cos_nowarmup", "accumulate4"])
def test_lr_schedules_match_jax(cos_lr, warmup_epochs, optimizer, nbs):
    jargs, pargs = _args(cos_lr=cos_lr, warmup_epochs=warmup_epochs, optimizer=optimizer, nbs=nbs)
    nb = 40
    _, jsched, jacc = build_optimizer(jargs, nb, 3, _tiny_params())
    popt = Optimizer(pargs, nb, 3, build_model("tinyjde.yaml")[0])
    assert popt.accumulate == jacc
    updates = np.arange(0, 3 * nb // jacc + 5)
    for key, sched in zip(("pg0", "pg1", "pg2"), popt.schedules):
        want = np.asarray([float(jsched[key](u)) for u in updates])
        np.testing.assert_allclose([sched(int(u)) for u in updates], want, rtol=1e-5, atol=1e-12)


def test_param_groups_match_jax():
    params = _tiny_params()
    codes = {"decay": 0, "nodecay": 1, "bias": 2}
    labels = _group_labels(params)
    coded = jax.tree.map(lambda p, lab: np.full(p.shape, codes[lab], np.float32), params, labels)
    want = from_jax_variables({"params": coded})
    model, _ = build_model("tinyjde.yaml")
    got = {name: codes[group_label(name, p)] for name, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, code in got.items():
        assert {float(v) for v in want[name].flatten().tolist()} == {code}, name
    assert set(got.values()) == {0, 1, 2}


def _momenta(opt_state):
    """The SGD momentum of the last update of each group, from optax's inject_hyperparams states."""
    found = []

    def walk(node):
        if hasattr(node, "hyperparams"):
            found.append(float(node.hyperparams["decay"]))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        elif isinstance(node, dict):
            for child in node.values():
                walk(child)
    walk(opt_state)
    return found


@pytest.mark.parametrize("optimizer,nbs,grad_scale", [("SGD", 2, 1.0), ("AdamW", 2, 1.0),
                                                      ("SGD", 4, 1.0), ("SGD", 2, 1e-4)],
                         ids=["sgd_clipped", "adamw_clipped", "sgd_accumulate2", "sgd_unclipped"])
def test_optimizer_updates_match_jax(optimizer, nbs, grad_scale):
    """Each update against optax's, during warmup (lr0 1 so that every group moves
    visibly, weight decay 0.05 so that it shows): the step of each parameter within
    1e-4 of the largest step plus 4 float32 ulps of the largest parameter."""
    jargs, pargs = _args(optimizer=optimizer, nbs=nbs, lr0=1.0, weight_decay=0.05)
    params = _tiny_params()
    nb = 4
    tx, _, acc = build_optimizer(jargs, nb, 3, params)
    model, _ = build_model("tinyjde.yaml")
    model.load_state_dict(from_jax_variables({"params": params}), strict=False)
    popt = Optimizer(pargs, nb, 3, model)
    assert popt.accumulate == acc == nbs // 2
    jparams, opt_state = jax.tree.map(jnp.asarray, params), tx.init(params)
    rng = np.random.default_rng(1)
    norms = []
    for step in range(6):
        grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * grad_scale).astype(np.float32),
                             params)
        norms.append(float(optax.global_norm(grads)))
        before = from_jax_variables({"params": jax.device_get(jparams)})
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        pgrads = from_jax_variables({"params": grads})
        for name, p in model.named_parameters():
            p.grad = pgrads[name].clone()
        assert popt.step() == ((step + 1) % acc == 0)
        model.zero_grad(set_to_none=True)
        after = from_jax_variables({"params": jax.device_get(jparams)})
        for name, p in model.named_parameters():
            want = (after[name] - before[name]).numpy()
            got = (p.detach() - before[name]).numpy()
            tol = 1e-4 * np.abs(want).max() + 4 * np.finfo(np.float32).eps * \
                after[name].abs().max().item()
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"step {step} {name}")
        if optimizer == "SGD" and popt.updates:
            assert _momenta(opt_state) == pytest.approx([popt.momentum(popt.updates - 1)] * 3,
                                                        rel=1e-6)
    assert popt.updates == 6 // acc
    assert (min(norms) > 10) if grad_scale == 1.0 else (max(norms) < 10)


def test_dropout_train_mode_is_seeded_and_eval_mode_is_off():
    x = torch.ones(4, 1000)
    d = Dropout(0.1).train()
    with pytest.raises(RuntimeError, match="generator"):
        d(x)
    outs = []
    for _ in range(2):
        set_generator(d, torch.Generator().manual_seed(3))
        outs.append(d(x))
    assert torch.equal(outs[0], outs[1])
    dropped = (outs[0] == 0).float().mean().item()
    assert 0.05 < dropped < 0.15
    assert torch.allclose(outs[0][outs[0] != 0], torch.tensor(1 / 0.9))
    assert not torch.equal(outs[0], d(x))  # the stream moves on
    assert torch.equal(d.eval()(x), x)
    model, _ = build_model("tinyjde.yaml")
    assert sum(isinstance(m, Dropout) for m in model.modules()) == 1  # the JDE state MLP


@pytest.mark.parametrize("optimizer,warmup_epochs,lr0,param_tol",
                         [("SGD", 0.0, 1e-3, 1e-4), ("AdamW", 3.0, 0.01, 5e-3)],
                         ids=["sgd", "adamw"])
def test_tinyjde_ten_steps_match_jax(optimizer, warmup_epochs, lr0, param_tol, tmp_path,
                                     monkeypatch):
    """10 steps against the JAX train step. SGD at lr 1e-3: at higher rates the
    float32 drift reaches the loss's kinks (the assigner's top-k, the triplet
    miner's picks, the state MLP's ReLU) within the 10 steps and the runs
    part. AdamW: its first
    steps move each parameter by about lr * sign(g), so an element whose gradient
    lies within rounding of 0 moves by +-lr in either run; its parameters are held
    to 5e-3 of each tensor's largest magnitude (its update rule is held exactly by
    `test_optimizer_updates_match_jax`)."""
    common = dict(model="tinyjde.yaml", data="synthetic", imgsz=64, batch=2, nbs=2, workers=1,
                  max_labels=16, seed=0, optimizer=optimizer, warmup_epochs=warmup_epochs, lr0=lr0)
    jtr = jax_jde_trainer({**common, "mesh_shape": [1], "plots": False, "val": False,
                           "save": False, "project": str(tmp_path)}, seed=11, monkeypatch=monkeypatch)
    ptr = port_trainer_like(jtr, common)
    assert ptr.optimizer.name == optimizer and ptr.accumulate == 1
    assert_trajectories_match(jtr, ptr, steps=10, param_tol=param_tol)


def test_yolo_train_then_predict_on_cpu(tmp_path):
    m = YOLO("tinyjde.yaml", device="cpu")
    metrics = m.train(data="synthetic", imgsz=64, batch=8, epochs=1, workers=2, max_labels=16,
                      project=str(tmp_path))
    losses = {f"train/{k}" for k in ("box", "cls", "dfl", "emb", "state")}
    # the epoch ends in a validation (on by default), whose fitness is the trainer's
    assert losses | {"fitness", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/mAP50(S)",
                     "speed/ms_per_image"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    tr = m.trainer
    assert tr.fitness == tr.best_fitness == metrics["fitness"]
    assert (tmp_path / "jde" / "jde" / "results.csv").exists()
    assert (tr.step, tr.accumulate, tr.optimizer.updates) == (8, 8, 1)  # nbs 64 / batch 8
    assert tr.optimizer.name == "AdamW"  # optimizer=auto on a short run
    for p, e in zip(m.model.parameters(), tr.ema):
        assert torch.equal(p, e)  # the model serves the EMA weights
    assert m.meta["nc"] == 3 and m.names == {0: "class0", 1: "class1", 2: "class2"}
    frames = np.random.default_rng(0).integers(0, 256, (2, 72, 128, 3), np.uint8)
    dets = m.predict_batched(frames, imgsz=64, conf=0.001)
    assert dets.shape == (2, 300, 6 + 32 + 6) and np.isfinite(dets).all()
    assert (dets[..., 4] > 0).any()
    assert m._fused is not None and not any(isinstance(x, torch.nn.BatchNorm2d)
                                            for x in m._fused.modules())


def test_trainer_raises_without_cuda(monkeypatch):
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JDETrainer({"model": "tinyjde.yaml", "data": "synthetic"})
    assert JDETrainer({"model": "tinyjde.yaml"}, device="cpu").device.type == "cpu"
