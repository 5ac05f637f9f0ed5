"""bf16 compute of the PyTorch port against the JAX package's bf16 models (CPU).

The same `fill_variables` weights go through the JAX model built with
`dtype=jnp.bfloat16` and the port built with `dtype=torch.bfloat16`, both on the CPU.
The two frameworks round to bf16 at the same modules but not bit for bit alike (XLA
keeps some elementwise chains in float32, oneDNN and XLA accumulate in other orders),
so the tolerances are relative L2 distances set by bf16's own size:

* eval-mode head maps within 1e-2 relative L2 (bf16 keeps 8 significant bits, a
  relative spacing of 2^-8 = 3.9e-3; the maps lie 2.6e-3 to 3.2e-3 apart, as far as
  JAX's bf16 maps lie from its float32 maps);
* train-mode BatchNorm normalizes by the batch statistics of 2x2 to 8x8 maps, which
  magnifies rounding by ~100x: there the port's bf16 maps lie no farther from JAX's
  bf16 maps than twice JAX's own bf16-to-float32 distance, and the same holds for the
  first step's gradient (both ~0.4-0.5 relative L2 from float32 at this size: the
  train-mode BN backward of a random-weight model); the loss items within 10% (Gaussian
  noise of the maps' size moves them by 1-4%), and both loss functions on the same
  bf16 maps within 1e-5 (the loss takes the maps to float32 first);
* module level, where rounding does not compound: a bf16 train-mode BatchNorm's
  running statistics within 1e-6 relative of Flax's (both reduce in float32) and its
  output within 1 bf16 ulp; the bf16 area attention within 2 bf16 ulps.

Also: `half` serving against the JAX bf16 fused model (`dataclasses.replace(model,
dtype=bf16)` and bf16 variables, as `YOLO._get_predictor` does on its accelerator) at a
threshold in a score gap; `check_bf16` and the trainer's fallback; bf16 training (forced
on the CPU) resumes exactly; the device augmentation in bf16 against JAX's.
"""

import copy
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data import device_augment as jax_da
from sar_yolo_tpu.nn.modules.block import area_attention
from sar_yolo_tpu.nn.tasks import bias_init_head, infer_strides
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.utils.loss import jde_loss as jax_jde_loss
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data.build import DataLoader
from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
from sar_yolo_tpu_torch.data.device_augment import device_train_augment
from sar_yolo_tpu_torch.engine import trainer as trainer_module
from sar_yolo_tpu_torch.engine.predictor import JDEPredictor
from sar_yolo_tpu_torch.engine.trainer import JDETrainer
from sar_yolo_tpu_torch.nn.fuse import half_model
from sar_yolo_tpu_torch.nn.modules.conv import BatchNorm2d, Conv2d, Dropout
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.ops.cuda.flash_attention import area_attention_plain
from sar_yolo_tpu_torch.utils.checks import check_bf16
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from sar_yolo_tpu_torch.utils.loss import jde_loss
from test_torch_port_device_augment import CASES, HYP, _batch, jax_params
from torch_port_common import fill_variables, jax_and_port_yolo, one_torch_thread  # noqa: F401

BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """Flax's Dropout as the identity (no RNG stream of the port reproduces its masks)."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _models(cfg: str, seed: int, nc=None):
    """{dtype name: (JAX model, variables, meta, port model)} for float32 and bf16, the same
    weights (dropout off in the port)."""
    out = {}
    for name, jdt, pdt in (("f32", jnp.float32, torch.float32), ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm, meta = jax_build_model(cfg, nc=nc, dtype=jdt)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                train=False))
        meta["strides"] = infer_strides(jm, meta)
        v = jax.device_get(bias_init_head(fill_variables(shapes, np.random.default_rng(seed)), meta))
        pm, _ = build_model(cfg, nc=nc, dtype=pdt)
        pm.load_state_dict(from_jax_variables(v))
        for m in pm.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        out[name] = (jm, v, meta, pm)
    return out


@pytest.mark.parametrize("cfg", ["tinyjde.yaml", "yolov13n-JDE.yaml"])
def test_bf16_forward_matches_jax(cfg, no_jax_dropout):
    models = _models(cfg, 0)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    maps = {}
    for name, (jm, v, _, pm) in models.items():
        for train in (False, True):
            if train:
                jout, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                                        mutable=["batch_stats"]))(v, x)
            else:
                jout = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
            pm.train(train)
            with torch.no_grad():
                pout = pm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
            want_dtype = torch.bfloat16 if name == "bf16" else torch.float32
            assert all(p.dtype == want_dtype for p in pout)
            maps["jax", name, train] = [np.asarray(o.astype(jnp.float32)).transpose(0, 3, 1, 2)
                                        for o in jout]
            maps["port", name, train] = [p.float().numpy() for p in pout]
    for lvl in range(len(maps["jax", "f32", False])):
        def d(a, b, train):
            return rel_l2(maps[a[0], a[1], train][lvl], maps[b[0], b[1], train][lvl])
        assert d(("port", "f32"), ("jax", "f32"), False) < 1e-5  # the float32 path as before
        assert d(("port", "bf16"), ("port", "f32"), False) > 1e-3  # it ran in bf16
        assert d(("port", "bf16"), ("jax", "bf16"), False) < 1e-2, f"eval level {lvl}"
        assert d(("port", "bf16"), ("jax", "bf16"), True) < \
            2 * d(("jax", "bf16"), ("jax", "f32"), True), f"train level {lvl}"


def test_bf16_batchnorm_and_attention_match_flax():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.normal(0, 0.5, (4, 6, 5, 16))).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    scale, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.normal(0, 0.1, 16).astype(np.float32)
    stats = {"mean": rng.normal(0, 0.1, 16).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3, dtype=jnp.bfloat16)
    want, mut = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, xb,
                         mutable=["batch_stats"])
    pbn = BatchNorm2d(16, eps=1e-3, momentum=0.03).train()
    with torch.no_grad():
        pbn.weight.copy_(torch.tensor(scale))
        pbn.bias.copy_(torch.tensor(bias))
        pbn.running_mean.copy_(torch.tensor(stats["mean"]))
        pbn.running_var.copy_(torch.tensor(stats["var"]))
        got = pbn(torch.tensor(x.transpose(0, 3, 1, 2)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    for key, got_stat in (("mean", pbn.running_mean), ("var", pbn.running_var)):
        want_stat = np.asarray(mut["batch_stats"][key])
        np.testing.assert_allclose(got_stat.numpy(), want_stat, rtol=0,
                                   atol=1e-6 * np.abs(want_stat).max(), err_msg=key)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP, atol=BF16_ULP / 8)
    # eval mode: the running statistics, normalized in float32
    pbn.eval()
    with torch.no_grad():
        got = pbn(torch.tensor(x.transpose(0, 3, 1, 2)).to(torch.bfloat16))
    want = fnn.BatchNorm(use_running_average=True, momentum=0.97, epsilon=1e-3,
                         dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": mut["batch_stats"]}, xb)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2),
                               rtol=BF16_ULP, atol=BF16_ULP / 8)
    # the area attention's plain version: QK^T in bf16, softmax in float32, PV in bf16
    q, k, v = (rng.normal(0, 1, (2, 64, 64)).astype(np.float32) for _ in range(3))
    want = area_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), 2, 4)
    got = area_attention_plain(*(torch.tensor(t).to(torch.bfloat16) for t in (q, k, v)), 2, 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 * BF16_ULP, atol=2 * BF16_ULP)


def test_bf16_train_step_matches_jax(no_jax_dropout):
    """tinyjde at 128 px, batch 4: the first step's loss items and gradient."""
    models = _models("tinyjde.yaml", 0, nc=3)
    ds = SyntheticDataset(n=4, imgsz=128, nc=3, max_labels=16, task="jde")
    batch = next(iter(DataLoader(ds, 4, workers=1, seed=0)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = {}
    for name, (jm, v, meta, pm) in models.items():
        kw = dict(nc=3, reg_max=16, strides=tuple(meta["strides"]), embed_dim=meta["embed_dim"],
                  state_classes=meta["state_classes"])

        def loss(params, jm=jm, v=v, kw=kw):
            feats, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                jb["img"].astype(jnp.float32) / 255.0, train=True,
                                mutable=["batch_stats"])
            o = jax_jde_loss(feats, jb, jax_get_cfg(overrides={}),
                             cb_counts=jnp.zeros(kw["state_classes"]), **kw)
            return o.total, (o.items, feats)
        (_, (jitems, jfeats)), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        pm.train()
        img = (pb["img"].permute(0, 3, 1, 2).float() / 255.0).to(pm.compute_dtype)
        o = jde_loss(pm(img), pb, get_cfg({}), cb_counts=torch.zeros(kw["state_classes"]), **kw)
        o.total.backward()
        grads = {n: p.grad for n, p in pm.named_parameters()}
        assert all(g.dtype == torch.float32 for g in grads.values())  # float32 masters
        jgrad = from_jax_variables({"params": jax.device_get(jgrad)})
        names = list(grads)
        out[name] = {"jitems": np.asarray(jitems), "pitems": o.items.detach().numpy(),
                     "jgrad": torch.cat([jgrad[n].flatten() for n in names]).numpy(),
                     "pgrad": torch.cat([grads[n].flatten() for n in names]).numpy()}
        if name == "bf16":  # both loss functions on JAX's bf16 maps
            same = jde_loss([torch.from_numpy(np.array(f.astype(jnp.float32)).transpose(0, 3, 1, 2))
                             .to(torch.bfloat16) for f in jfeats], pb, get_cfg({}),
                            cb_counts=torch.zeros(kw["state_classes"]), **kw)
            np.testing.assert_allclose(same.items.numpy(), np.asarray(jitems), rtol=1e-5)
    f32, bf = out["f32"], out["bf16"]
    np.testing.assert_allclose(f32["pitems"], f32["jitems"], rtol=1e-5)
    np.testing.assert_allclose(bf["pitems"], bf["jitems"], rtol=0.1)
    assert rel_l2(bf["pgrad"], f32["pgrad"]) > 1e-3  # it ran in bf16
    assert rel_l2(bf["pgrad"], bf["jgrad"]) < 2 * rel_l2(bf["jgrad"], f32["jgrad"])


def test_half_serving_matches_jax_bf16():
    jyolo, pyolo = jax_and_port_yolo("tinyjde.yaml", 3, bias_init=True, cls_gain=8.0)
    frames = np.random.default_rng(0).integers(0, 256, (3, 72, 128, 3), np.uint8)

    def jax_half(conf):  # a new predictor: JAX's compiled serve keeps the conf it saw first
        jpred = jyolo._get_predictor({"imgsz": 96, "conf": conf})
        jpred.model = dataclasses.replace(jpred.model, dtype=jnp.bfloat16)
        jpred.variables = jax.tree.map(lambda t: t.astype(jnp.bfloat16)
                                       if t.dtype == jnp.float32 else t, jpred.variables)
        return jpred
    model = half_model(copy.deepcopy(pyolo._fused_for_serving()))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    args = copy.copy(pyolo._get_predictor({"imgsz": 96, "conf": 0.001}).args)
    ppred = JDEPredictor(model, pyolo.meta, args, pyolo.names)
    x, _, _ = ppred.preprocess(frames)
    assert x.dtype == torch.bfloat16
    # a threshold in the highest gap of JAX's bf16 scores where they fall by over 1.5x
    # (bf16 sigmoids part by ~1 ulp, 0.4-0.8% of a score)
    scores = np.sort(np.asarray(jax_half(0.001).predict_batch(frames))[..., 4].ravel())[::-1]
    scores = scores[scores > 0]
    gaps = np.flatnonzero(scores[:-1] > 1.5 * scores[1:])
    assert len(gaps) > 0
    conf = float(np.sqrt(scores[gaps[0]] * scores[gaps[0] + 1]))
    ppred.args.conf = conf
    want = np.asarray(jax_half(conf).predict_batch(frames))
    got = ppred.predict_batch(frames)
    assert got.shape == want.shape and got.dtype == np.float32
    kept = 0
    for b in range(len(frames)):
        g, w = got[b][got[b, :, 4] > 0], want[b][want[b, :, 4] > 0]
        assert len(g) == len(w)
        kept += len(g)
        order = [int(np.abs(w[:, :4] - row[:4]).max(1).argmin()) for row in g]
        w = w[order]
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=2e-2)  # scores
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1.0)  # px at 96
        assert rel_l2(g[:, 6:38], w[:, 6:38]) < 2e-2  # embeddings
    assert kept > 0


def test_check_bf16_and_the_trainer_fallback(tmp_path, monkeypatch):
    model, _ = build_model("tinyjde.yaml", dtype=torch.bfloat16)
    assert check_bf16(model.train()) and model.training and model.compute_dtype == torch.bfloat16

    class Cancelling(torch.nn.Module):
        """x + 1e4 - 1e4: exact to 1e-3 in float32, all lost in bf16 (spacing 64 at 1e4)."""

        def __init__(self):
            super().__init__()
            self.a, self.b = Conv2d(3, 3, 1), Conv2d(3, 3, 1)
            with torch.no_grad():
                for conv, bias in ((self.a, 1e4), (self.b, -1e4)):
                    conv.weight.copy_(torch.eye(3)[..., None, None])
                    conv.bias.fill_(bias)

        def forward(self, x):
            return [self.b(self.a(x))]
    assert not check_bf16(Cancelling())
    common = dict(model="tinyjde.yaml", data="synthetic", imgsz=64, batch=4, workers=1,
                  max_labels=8, val=False, save=False, project=str(tmp_path), exist_ok=True)
    monkeypatch.setattr(trainer_module, "amp_dtype", lambda args, device: torch.bfloat16)
    tr = JDETrainer(common, device="cpu")
    tr.setup()
    assert tr.model.compute_dtype == torch.bfloat16
    b = tr.to_device(next(iter(tr.train_loader)))
    assert b["img"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    warnings = []
    monkeypatch.setattr(trainer_module, "check_bf16", lambda model, imgsz: False)
    monkeypatch.setattr(trainer_module.LOGGER, "warning", warnings.append)
    tr = JDETrainer({**common, "amp": True}, device="cpu")
    tr.setup()
    assert tr.model.compute_dtype == torch.float32
    assert any("falling back to f32" in w for w in warnings)


def test_bf16_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    """bf16 training forced on the CPU: the checkpoints hold float32 masters, and a run
    resumed from epoch 1 ends equal to the uninterrupted one."""
    monkeypatch.setattr(trainer_module, "amp_dtype", lambda args, device: torch.bfloat16)
    common = dict(model="tinyjde.yaml", data="synthetic", imgsz=64, batch=8, workers=2,
                  max_labels=8, val=False, optimizer="SGD", warmup_epochs=0.0, epochs=2,
                  device_augment=True, copy_paste=0.0, close_mosaic=1, nbs=24,
                  multi_scale=True, project=str(tmp_path), exist_ok=True)
    full = JDETrainer({**common, "name": "full", "save_period": 1}, device="cpu")
    full.train()
    assert full.model.compute_dtype == torch.bfloat16
    state = torch.load(tmp_path / "jde" / "full" / "weights" / "epoch1" / "state.pt",
                       weights_only=True)
    assert all(t.dtype == torch.float32 for k, t in state["model"].items()
               if not k.endswith("num_batches_tracked"))
    resumed = JDETrainer({**common, "name": "resumed",
                          "resume": str(tmp_path / "jde" / "full" / "weights" / "epoch1")},
                         device="cpu")
    resumed.train()
    for k, w in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], w), k
    assert all(torch.equal(a, b) for a, b in zip(resumed.ema, full.ema))
    assert torch.equal(resumed.generator.get_state(), full.generator.get_state())
    assert resumed._ms_rng.bit_generator.state == full._ms_rng.bit_generator.state


@pytest.mark.parametrize("case", ["mosaic_mixup_flips", "letterbox"])
def test_device_augment_bf16_matches_jax(case):
    mosaic, over = CASES[case]
    hyp = {**HYP, **over}
    batch = _batch(sorted(CASES).index(case))
    key = jax.random.PRNGKey(3 + sorted(CASES).index(case))
    want = jax.jit(lambda b, k: jax_da.device_train_augment(b, k, hyp, mosaic=mosaic,
                                                            dtype=jnp.bfloat16))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    got = device_train_augment({k: torch.from_numpy(v) for k, v in batch.items()},
                               jax_params(key, hyp, mosaic), hyp, mosaic=mosaic,
                               dtype=torch.bfloat16)
    assert got["img"].dtype == torch.bfloat16
    wimg = np.asarray(want["img"].astype(jnp.float32))
    gimg = got["img"].float().numpy()
    # the warp rounds to bf16 in both; values within 1 bf16 ulp, nearly all equal
    np.testing.assert_allclose(gimg, wimg, rtol=0, atol=BF16_ULP)
    assert (gimg == wimg).mean() > 0.9
    np.testing.assert_allclose(got["bboxes"].numpy(), np.asarray(want["bboxes"]), rtol=0, atol=1e-5)
    for k in ("cls", "tags", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
