"""The training options of the PyTorch port against the JAX package (CPU).

The config keys (`amp`, `half`, `remat`, `multi_scale`, `profile`, `dropout` with the
JAX defaults; `int8` not ported); on the CPU `amp` and `half` leave the model in
float32, as the JAX package does off its accelerator; `remat=True` train steps equal
the plain ones exactly (yolov13n-JDE, whose HyperACE dropout is live: the masks, the
BN statistics, the EMA and the dropout stream too); `multi_scale` batches equal
`BaseTrainer._multi_scale`'s sizes and pixels; RMSProp, Adam, NAdam and RAdam updates
against `build_optimizer` (the tolerance of `test_torch_port_train.py`: each step within
1e-4 of the largest step plus 4 float32 ulps of the largest parameter);
`profile='trace'` writes a trace of steps 1-3 and closes it when a step raises.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.engine.trainer import BaseTrainer, build_optimizer
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.engine import trainer as trainer_module
from sar_yolo_tpu_torch.engine.trainer import JDETrainer, Optimizer
from sar_yolo_tpu_torch.nn.modules.conv import Conv2d, Linear
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401

TINY = dict(model="tinyjde.yaml", data="synthetic", imgsz=64, batch=4, workers=1, max_labels=8,
            val=False, save=False, exist_ok=True)


def test_precision_and_option_keys():
    args = get_cfg({})
    assert (args.amp, args.half, args.remat, args.multi_scale, args.profile, args.dropout) == \
        (True, False, False, False, False, 0.0)
    get_cfg({"amp": False, "half": True, "remat": True, "multi_scale": True, "profile": "trace",
             "dropout": 0.1})
    assert get_cfg({"int8": "auto", "mesh_shape": [2]}).int8 == "auto"  # ported since
    assert get_cfg({"plots": False}).plots is False and get_cfg({}).plots is True  # ported since
    with pytest.raises(NotImplementedError, match="keras"):
        get_cfg({"keras": True})


def _dtypes(model):
    return {m.compute_dtype for m in model.modules() if isinstance(m, (Conv2d, Linear))}


def test_amp_and_half_leave_the_cpu_in_float32(tmp_path):
    tr = JDETrainer({**TINY, "amp": True, "half": True, "project": str(tmp_path)}, device="cpu")
    tr.setup()
    assert tr.model.compute_dtype == torch.float32 and _dtypes(tr.model) == {None}
    # float32 compute follows the parameters: a float64 copy (the tests' exact reference)
    # runs in float64
    exact = copy.deepcopy(tr.model).double().eval()
    with torch.no_grad():
        assert exact(torch.zeros(1, 3, 64, 64, dtype=torch.float64))[0].dtype == torch.float64
    batch = next(iter(tr.train_loader))
    assert tr.to_device(batch)["img"].dtype == torch.float32
    yolo = YOLO("tinyjde.yaml", device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 80, 3), np.uint8)
    want = yolo.predict_batched(frames, imgsz=64, conf=0.001)
    got = yolo.predict_batched(frames, imgsz=64, conf=0.001, half=True)
    assert yolo._fused_for_serving(True) is yolo._fused_for_serving()
    assert {p.dtype for p in yolo._fused_for_serving(True).parameters()} == {torch.float32}
    np.testing.assert_array_equal(got, want)


def _run(remat: bool, tmp_path, steps: int = 3):
    tr = JDETrainer(dict(model="yolov13n-JDE.yaml", data="synthetic", imgsz=64, batch=2,
                         workers=1, max_labels=8, seed=0, remat=remat, nbs=2, optimizer="SGD",
                         val=False, save=False, project=str(tmp_path), name=f"remat{remat}"),
                    device="cpu")
    tr.setup()
    it = iter(tr.train_loader)
    items = [tr.train_step(next(it), i)[1] for i in range(steps)]
    return tr, items


def test_remat_steps_equal_the_plain_steps(tmp_path):
    """Three SGD steps of yolov13n-JDE at 64 px with the HyperACE dropout live (p 0.1):
    loss items, parameters, BN statistics, EMA, momenta and the dropout stream all equal."""
    plain, pitems = _run(False, tmp_path)
    remat, ritems = _run(True, tmp_path)
    assert remat.model.remat and not plain.model.remat
    for a, b in zip(pitems, ritems):
        assert torch.equal(a, b)
    want, got = plain.model.state_dict(), remat.model.state_dict()
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert all(torch.equal(a, b) for a, b in zip(plain.ema, remat.ema))
    pm, rm = (t.optimizer.opt.state_dict()["state"] for t in (plain, remat))
    assert all(torch.equal(pm[i]["momentum_buffer"], rm[i]["momentum_buffer"]) for i in pm)
    assert torch.equal(plain.generator.get_state(), remat.generator.get_state())
    assert not torch.equal(plain.generator.get_state(),
                           torch.Generator().manual_seed(1).get_state())  # masks were drawn


def test_multi_scale_matches_jax(tmp_path):
    tr = JDETrainer({**TINY, "multi_scale": True, "seed": 3, "project": str(tmp_path)},
                    device="cpu")
    tr.setup()
    jself = SimpleNamespace(meta={"strides": tr.meta["strides"]},
                            args=SimpleNamespace(seed=3, imgsz=64))
    batch = next(iter(tr.train_loader))
    sizes = set()
    for i in range(12):
        want = BaseTrainer._multi_scale(jself, batch, i)
        got = tr._multi_scale(batch)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        sizes.add(got["img"].shape[1])
    assert len(sizes) > 2 and min(sizes) < 64 < max(sizes)
    # a step at a drawn size trains on it
    tr.train_loader.set_epoch(0)
    _, items = tr.train_step(tr._multi_scale(batch))
    assert torch.isfinite(items).all()


def _args(**kw):
    base = dict(batch=2, nbs=2, epochs=3, lr0=1.0, lrf=0.01, momentum=0.937, weight_decay=0.05,
                warmup_epochs=3.0, warmup_momentum=0.8, warmup_bias_lr=0.1, cos_lr=False)
    base.update(kw)
    return jax_get_cfg(overrides=base), get_cfg(base)


@pytest.mark.parametrize("optimizer,nbs,grad_scale",
                         [("RMSProp", 2, 1.0), ("RMSProp", 4, 1e-4), ("Adam", 2, 1.0),
                          ("NAdam", 2, 1.0), ("RAdam", 4, 1.0)],
                         ids=["rmsprop_clipped", "rmsprop_accumulate2_unclipped", "adam", "nadam",
                              "radam_accumulate2"])
def test_optimizer_updates_match_jax(optimizer, nbs, grad_scale):
    """Six micro-steps against optax's updates, during warmup (lr0 1, weight decay 0.05, so
    that every group and the decay move visibly); momentum 0.937 on RMSProp's trace. Each
    of the port's steps is held to optax's step from optax's parameters."""
    jargs, pargs = _args(optimizer=optimizer, nbs=nbs)
    jmodel, _ = jax_build_model("tinyjde.yaml")
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3)), train=False))
    params = fill_variables(shapes, np.random.default_rng(0))["params"]
    nb = 4
    tx, _, acc = build_optimizer(jargs, nb, 3, params)
    model, _ = build_model("tinyjde.yaml")
    model.load_state_dict(from_jax_variables({"params": params}), strict=False)
    popt = Optimizer(pargs, nb, 3, model)
    assert popt.accumulate == acc == nbs // 2
    want_cls = trainer_module.RMSProp if optimizer == "RMSProp" else torch.optim.AdamW
    assert type(popt.opt) is want_cls
    jparams, opt_state = jax.tree.map(jnp.asarray, params), tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(1)
    for step in range(6):
        grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * grad_scale).astype(np.float32),
                             params)
        before = from_jax_variables({"params": jax.device_get(jparams)})
        updates, opt_state = update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        pgrads = from_jax_variables({"params": grads})
        prev = {name: p.detach().clone() for name, p in model.named_parameters()}
        for name, p in model.named_parameters():
            p.grad = pgrads[name].clone()
        assert popt.step() == ((step + 1) % acc == 0)
        model.zero_grad(set_to_none=True)
        after = from_jax_variables({"params": jax.device_get(jparams)})
        for name, p in model.named_parameters():
            want = (after[name] - before[name]).numpy()
            got = (p.detach() - prev[name]).numpy()
            tol = 1e-4 * np.abs(want).max() + 4 * np.finfo(np.float32).eps * \
                after[name].abs().max().item()
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"step {step} {name}")
    assert popt.updates == 6 // acc


def test_rmsprop_state_survives_a_checkpoint_round_trip():
    model, _ = build_model("tinyjde.yaml")
    popt = Optimizer(get_cfg({"optimizer": "RMSProp", "batch": 2, "nbs": 2}), 4, 3, model)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    popt.step()
    copy_model = copy.deepcopy(model)
    again = Optimizer(get_cfg({"optimizer": "RMSProp", "batch": 2, "nbs": 2}), 4, 3, copy_model)
    again.load_state_dict(copy.deepcopy(popt.state_dict()))  # as torch.save and load would
    for opt, m in ((popt, model), (again, copy_model)):
        for p in m.parameters():
            p.grad = torch.full_like(p, 0.5)
        opt.step()
    for a, b in zip(model.parameters(), copy_model.parameters()):
        assert torch.equal(a, b)


def test_profile_trace_writes_steps_and_closes_on_error(tmp_path, monkeypatch):
    tr = JDETrainer({**TINY, "epochs": 1, "profile": "trace", "project": str(tmp_path),
                     "name": "trace"}, device="cpu")
    tr.setup()
    steps = []
    orig = JDETrainer.train_step

    def counted(self, batch, i=0):
        steps.append(i)
        return orig(self, batch, i)
    monkeypatch.setattr(JDETrainer, "train_step", counted)
    tr.train()
    trace = tmp_path / "jde" / "trace" / "trace" / "train_steps.pt.trace.json"
    assert trace.stat().st_size > 0 and len(steps) == tr.nb > 4
    assert not torch._C._autograd._profiler_enabled()

    def failing(self, batch, i=0):
        if i == 2:
            raise RuntimeError("step failed")
        return orig(self, batch, i)
    monkeypatch.setattr(JDETrainer, "train_step", failing)
    tr2 = JDETrainer({**TINY, "epochs": 1, "profile": "trace", "project": str(tmp_path),
                      "name": "trace_err"}, device="cpu")
    with pytest.raises(RuntimeError, match="step failed"):
        tr2.train()
    assert not torch._C._autograd._profiler_enabled() and tr2._trace is None
    assert (tmp_path / "jde" / "trace_err" / "trace" / "train_steps.pt.trace.json").exists()

