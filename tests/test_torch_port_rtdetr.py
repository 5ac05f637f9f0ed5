"""RT-DETR of the PyTorch port against the JAX package (float32; all inputs numpy-seeded).

(a) `ms_deformable_attention` with sampling locations reaching past every border (the
out-of-bounds corners read zero), within 1e-5;
(b) MSDeformAttn, AIFI and a deformable decoder layer with a CDN block mask, within 1e-5;
(c) the RTDETRDecoder head in eval mode and in train mode with denoising queries built from
JAX's own draws (its `make_rng("dn")` key fixed, the draws made from it as `_cdn_group`
makes them): every output, the dn outputs and the input projections' BN statistics within
1e-5;
(d) the Hungarian matching: the same assignment as `hungarian_match` on costs without ties
(padded gt rows included), and its total cost within 1e-5 relative;
(e) `detr_loss` and `dn_loss` items on the head's train outputs within 1e-5 relative, and
with no gt in the batch (focal class term, zero box terms);
(f) three train steps of tinyrtdetr at 128 px (batch 2, dn queries on): at each step the
port's gradient from JAX's current weights within 1e-3 relative L2 of JAX's (over all
parameters), the loss items within 1e-5 relative and the BN statistics within 1e-5
(64 px is not used: there train-mode BN over 2 x 2 maps amplifies float32 rounding
beyond that);
(g) `RTDETRPredictor` rows of `predict_batched` within 1e-4 px and 1e-5 in score, and
`RTDETRValidator` on ground truth planted near the model's own detections: every metric
within 1e-6 (the served layer's class logits scaled by SCORE_GAIN, so that the rows'
scores rank apart from float32 rounding: with random weights they crowd within 1e-6 of
each other and AP follows their order); `RTDETR.train` runs on synthetic data and its
checkpoint serves.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.engine import validator as jax_validator
from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
from sar_yolo_tpu.nn.modules import transformer as JT
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.utils import detr_loss as JL
from sar_yolo_tpu_torch import RTDETR
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.cfg.models import MODELS_DIR
from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.nn.modules import transformer as PT
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.utils import detr_loss as PL
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_val import _assert_metrics_equal, _record_dets
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5
SCORE_GAIN = 30.0  # on the served layer's class logits (g)
DN_KEY = jax.random.PRNGKey(7)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=0, atol=atol, err_msg=what)


def _variables(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(
        {"params": DN_KEY, "dn": DN_KEY, "dropout": DN_KEY}, *args, **kw))
    return fill_variables(shapes, np.random.default_rng(seed))


@pytest.fixture
def fixed_dn_key(monkeypatch):
    """JAX's decoder draws its CDN noise from DN_KEY; returns draws(B, M, nc) -> the port's."""
    monkeypatch.setattr(JT.RTDETRDecoder, "make_rng", lambda self, name: DN_KEY)

    def draws(B, M, nc):
        _, DN = PT.cdn_sizes(M)
        r_cls, r_sign, r_part, r_flip = jax.random.split(DN_KEY, 4)
        return {"flip": _t(jax.random.uniform(r_flip, (B, DN))),
                "cls": _t(jax.random.randint(r_cls, (B, DN), 0, nc)),
                "sign": _t(jax.random.uniform(r_sign, (B, DN, 4))),
                "part": _t(jax.random.uniform(r_part, (B, DN, 4)))}
    return draws


def _gt(B, M, nc, counts, seed=3):
    rng = np.random.default_rng(seed)
    mask = (np.arange(M)[None] < np.asarray(counts)[:, None]).astype(np.float32)
    boxes = np.concatenate([rng.uniform(.2, .8, (B, M, 2)), rng.uniform(.05, .3, (B, M, 2))], -1)
    return {"cls": (rng.integers(0, nc, (B, M)) * mask).astype(np.float32),
            "bboxes": (boxes * mask[..., None]).astype(np.float32), "mask": mask}


# ---- (a) the deformable sampling core ---------------------------------------------------------

def test_ms_deformable_attention_matches_jax():
    rng = np.random.default_rng(0)
    shapes = ((8, 10), (4, 5), (2, 3))
    B, Q, nh, hd, npts = 2, 7, 4, 8, 3
    value = rng.standard_normal((B, sum(h * w for h, w in shapes), nh, hd)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, nh, len(shapes), npts, 2)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, Q, nh, len(shapes), npts)).astype(np.float32)
    want = JT.ms_deformable_attention(jnp.asarray(value), shapes, jnp.asarray(loc),
                                      jnp.asarray(attn))
    got = PT.ms_deformable_attention(_t(value), shapes, _t(loc), _t(attn))
    assert ((loc < 0) | (loc > 1)).any(axis=-1).mean() > 0.2  # many corners fall outside
    _close(got, want)


# ---- (b) the attention modules -------------------------------------------------------------------

def test_msdeformattn_matches_jax():
    rng = np.random.default_rng(1)
    shapes = ((6, 6), (3, 3))
    q = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ref = np.concatenate([rng.uniform(.1, .9, (2, 5, 2)), rng.uniform(.05, .5, (2, 5, 2))],
                         -1).astype(np.float32)
    val = rng.standard_normal((2, 45, 32)).astype(np.float32)
    jm = JT.MSDeformAttn(32, 2, 4, 3, shapes=shapes)
    v = _variables(jm, jnp.asarray(q), jnp.asarray(ref), jnp.asarray(val), shapes)
    pm = PT.MSDeformAttn(32, 2, 4, 3)
    pm.load_state_dict(from_jax_variables(v), strict=True)
    _close(pm(_t(q), _t(ref), _t(val), shapes),
           jm.apply(v, jnp.asarray(q), jnp.asarray(ref), jnp.asarray(val), shapes))


def test_offset_init_matches_jax():
    """The ring-pattern bias of the sampling offsets (JAX's initializer, not fill_variables)."""
    jm = JT.MSDeformAttn(64, 3, 8, 4)
    shapes = ((4, 4), (2, 2), (1, 1))
    q, ref, val = jnp.zeros((1, 2, 64)), jnp.full((1, 2, 4), .5), jnp.zeros((1, 21, 64))
    v = jm.init(jax.random.PRNGKey(0), q, ref, val, shapes)["params"]
    pm = PT.MSDeformAttn(64, 3, 8, 4)
    pm.reset_offsets()
    _close(pm.sampling_offsets.bias, v["sampling_offsets"]["bias"], 1e-6)
    assert not pm.sampling_offsets.weight.any() and not pm.attention_weights.bias.any()


def test_aifi_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 7, 32)).astype(np.float32)
    jm = JT.AIFI(cm=64, num_heads=4)
    v = _variables(jm, jnp.asarray(x))
    pm = PT.AIFI(32, 64, 4)
    pm.load_state_dict(from_jax_variables(v), strict=True)
    _close(pm(_t(x.transpose(0, 3, 1, 2).copy())), np.asarray(jm.apply(v, jnp.asarray(x)))
           .transpose(0, 3, 1, 2))


def test_decoder_layer_with_block_mask_matches_jax():
    rng = np.random.default_rng(3)
    shapes = ((4, 4), (2, 2))
    T = 9
    embed, pos = (rng.standard_normal((2, T, 32)).astype(np.float32) for _ in range(2))
    ref = np.concatenate([rng.uniform(.1, .9, (2, T, 2)), rng.uniform(.05, .5, (2, T, 2))],
                         -1).astype(np.float32)
    feats = rng.standard_normal((2, 20, 32)).astype(np.float32)
    grp = np.where(np.arange(T) < 6, np.arange(T) // 3, 2)
    mask = (grp[:, None] != grp[None, :]) & (np.arange(T) < 6)[None, :]
    jm = JT.DeformableTransformerDecoderLayer(32, 4, 48, 2, 3, shapes=shapes)
    args = [jnp.asarray(a) for a in (embed, ref, feats, pos)]
    v = _variables(jm, *args[:3], args[3], False, jnp.asarray(mask))
    pm = PT.DeformableTransformerDecoderLayer(32, 4, 48, 2, 3)
    pm.load_state_dict(from_jax_variables(v), strict=True)
    got = pm(_t(embed), _t(ref), _t(feats), shapes, _t(pos), torch.tensor(mask))
    _close(got, jm.apply(v, *args[:3], args[3], False, attn_mask=jnp.asarray(mask)))


# ---- (c) the decoder head ----------------------------------------------------------------------

CH = (16, 32, 32)


def _feats(B=2):
    return [np.random.default_rng(10 + i).standard_normal((B, s, s, c)).astype(np.float32)
            for i, (s, c) in enumerate(zip((8, 4, 2), CH))]


def _head_pair(nc=3):
    jm = JT.RTDETRDecoder(nc=nc, ch=CH, hd=32, nq=20, ndl=3, d_ffn=64)
    gt1 = {k: jnp.asarray(v[:1]) for k, v in _gt(1, 4, nc, [2]).items()}
    v = _variables(jm, [jnp.asarray(a[:1]) for a in _feats()], train=True, batch_gt=gt1)
    pm = PT.RTDETRDecoder(nc=nc, ch=CH, hd=32, nq=20, ndl=3, d_ffn=64)
    pm.load_state_dict(from_jax_variables(v), strict=True)
    return jm, pm, v


def _nchw(xs):
    return [_t(a.transpose(0, 3, 1, 2).copy()) for a in xs]


def test_decoder_head_eval_matches_jax():
    jm, pm, v = _head_pair()
    xs = _feats()
    want = jax.jit(lambda v, xs: jm.apply(v, xs, train=False))(v, [jnp.asarray(a) for a in xs])
    got = pm.eval()(_nchw(xs))
    assert [tuple(g.shape) for g in got] == [(3, 2, 20, 4), (3, 2, 20, 3), (2, 20, 4), (2, 20, 3)]
    for g, w in zip(got, want):
        _close(g, w)


def test_decoder_head_train_with_dn_matches_jax(fixed_dn_key):
    jm, pm, v = _head_pair()
    xs = _feats()
    gt = _gt(2, 5, 3, [3, 1])
    want, mut = jax.jit(lambda v, xs, gt: jm.apply(
        v, xs, train=True, batch_gt=gt, mutable=["batch_stats"], rngs={"dn": DN_KEY}))(
        v, [jnp.asarray(a) for a in xs], {k: jnp.asarray(a) for k, a in gt.items()})
    got = pm.train()(_nchw(xs), {k: _t(a) for k, a in gt.items()}, fixed_dn_key(2, 5, 3))
    G, DN = PT.cdn_sizes(5)
    assert (G, DN) == (10, 100) and got[4]["G"] == want[4]["G"]
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)
    for k in ("dn_bboxes", "dn_scores", "pos_flag"):
        _close(got[4][k], want[4][k], what=k)
    own = pm.state_dict()
    for k, w in from_jax_variables(jax.device_get(dict(mut))).items():
        if "running_" in k:
            _close(own[k], w, what=k)


# ---- (d) the Hungarian matching ----------------------------------------------------------------

def test_hungarian_assignment_matches_jax():
    """Random decoder boxes and scores against padded gt rows: the port's batched costs
    equal JAX's, and scipy's assignment of each image equals optax's."""
    rng = np.random.default_rng(4)
    L, B, Q, M, nc = 2, 3, 30, 6, 4
    boxes = np.concatenate([rng.uniform(.1, .9, (L, B, Q, 2)), rng.uniform(.02, .4, (L, B, Q, 2))],
                           -1).astype(np.float32)
    scores = rng.standard_normal((L, B, Q, nc)).astype(np.float32) * 2
    gt = _gt(B, M, nc, [6, 3, 1])
    pt = {k: _t(a) for k, a in gt.items()}
    costs = PL.matching_costs(_t(boxes), _t(scores), pt["bboxes"], pt["cls"], pt["mask"])
    got = PL.solve_assignments(costs, pt["mask"])
    assert got.n_gt == 10
    for lyr in range(L):
        for b in range(B):
            n = int(gt["mask"][b].sum())
            aq, _ = JL.hungarian_match(jnp.asarray(boxes[lyr, b]), jnp.asarray(scores[lyr, b]),
                                       jnp.asarray(gt["bboxes"][b]),
                                       jnp.asarray(gt["cls"][b]).astype(jnp.int32),
                                       jnp.asarray(gt["mask"][b]))
            want_q = np.asarray(aq)[:n]
            got_q = got.index[lyr, b, :n].numpy()
            assert (got_q == want_q).all(), (lyr, b)
            assert (got.index[lyr, b, n:] == Q).all()
            c = costs[lyr, b].numpy()
            np.testing.assert_allclose(c[got_q, np.arange(n)].sum(), c[want_q, np.arange(n)].sum(),
                                       rtol=1e-5)


# ---- (e) the loss ----------------------------------------------------------------------------

@pytest.mark.parametrize("counts", [[3, 1], [0, 0]], ids=["gt", "no_gt"])
def test_detr_and_dn_loss_items_match_jax(fixed_dn_key, counts):
    jm, pm, v = _head_pair()
    xs = _feats()
    gt = _gt(2, 5, 3, counts)
    jgt = {k: jnp.asarray(a) for k, a in gt.items()}

    @jax.jit
    def jax_loss(v, xs, jgt):
        out, _ = jm.apply(v, xs, train=True, batch_gt=jgt, mutable=["batch_stats"],
                          rngs={"dn": DN_KEY})
        return out, JL.detr_loss(out, jgt, None, nc=3), JL.dn_loss(out[4], jgt, nc=3)

    out, want, jdn = jax_loss(v, [jnp.asarray(a) for a in xs], jgt)
    pgt = {k: _t(a) for k, a in gt.items()}
    pout = pm.train()(_nchw(xs), pgt, fixed_dn_key(2, 5, 3))
    got = PL.detr_loss(pout, pgt)
    np.testing.assert_allclose(got.items.numpy(), np.asarray(want.items), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got.total.detach()), float(want.total), rtol=1e-5)
    dc, db, dg = PL.dn_loss(pout[4], pgt, int(gt["mask"].sum()))
    np.testing.assert_allclose([float(t.detach()) for t in (dc, db, dg)], [float(a) for a in jdn],
                               rtol=1e-5, atol=1e-7)
    if not sum(counts):
        assert float(got.items[1]) == float(got.items[2]) == 0.0


# ---- (f) three train steps of tinyrtdetr ---------------------------------------------------------

def test_tinyrtdetr_gradients_match_jax(fixed_dn_key):
    jmodel, _ = jax_build_model("tinyrtdetr.yaml")
    B, S, M, nc = 2, 128, 4, 3
    gt1 = {k: jnp.asarray(a[:1]) for k, a in _gt(1, M, nc, [2]).items()}
    v = _variables(jmodel, jnp.zeros((1, 64, 64, 3)), train=True, batch_gt=gt1)
    pmodel, _ = build_model("tinyrtdetr.yaml")
    params, stats = v["params"], v["batch_stats"]

    def loss_fn(p, stats, x, jgt):
        out, mut = jmodel.apply({"params": p, "batch_stats": stats}, x, train=True,
                                batch_gt=jgt, mutable=["batch_stats"],
                                rngs={"dn": DN_KEY, "dropout": DN_KEY})
        r = JL.detr_loss(out, jgt, None, nc=nc)
        return r.total, (r.items, mut["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    for step in range(3):
        rng = np.random.default_rng(20 + step)
        x = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
        gt = _gt(B, M, nc, [3, 2], seed=30 + step)
        jgt = {k: jnp.asarray(a) for k, a in gt.items()}
        (_, (jitems, new_stats)), jgrad = grad_fn(params, stats, jnp.asarray(x), jgt)
        pmodel.load_state_dict(from_jax_variables(jax.device_get(
            {"params": params, "batch_stats": stats})), strict=True)
        pmodel.train().zero_grad()
        pgt = {k: _t(a) for k, a in gt.items()}
        out = pmodel(_t(x.transpose(0, 3, 1, 2).copy()), pgt, fixed_dn_key(B, M, nc))
        r = PL.detr_loss(out, pgt)
        r.total.backward()
        np.testing.assert_allclose(r.items.numpy(), np.asarray(jitems), rtol=1e-5,
                                   err_msg=f"step {step + 1}")
        want = from_jax_variables({"params": jax.device_get(jgrad)})
        named = dict(pmodel.named_parameters())
        diff = sum(float(((named[k].grad - w) ** 2).sum()) for k, w in want.items())
        norm = sum(float((w ** 2).sum()) for w in want.values())
        assert (diff / norm) ** 0.5 < 1e-3, f"step {step + 1}: {(diff / norm) ** 0.5}"
        own = pmodel.state_dict()
        for k, w in from_jax_variables(jax.device_get({"batch_stats": new_stats})).items():
            if "running_" in k:
                _close(own[k], w, what=f"step {step + 1} {k}")
        params = jax.tree.map(lambda p, g: p - 0.01 * g, params, jgrad)
        stats = new_stats


# ---- (g) the predictor, the validator and the facade ------------------------------------------

@pytest.fixture(scope="module")
def rtdetr_pair():
    jyolo = JaxYOLO("tinyrtdetr.yaml")
    gt1 = {"cls": jnp.zeros((1, 4), jnp.int32), "bboxes": jnp.full((1, 4, 4), .5),
           "mask": jnp.zeros((1, 4))}
    variables = _variables(jyolo.model, jnp.zeros((1, 64, 64, 3)), seed=7, train=True,
                           batch_gt=gt1)
    # the last layer's class logits spread, so that scores rank apart from rounding
    head = variables["params"]["blocks_19"]["dec_score_head_5"]
    head["kernel"] = head["kernel"] * np.float32(SCORE_GAIN)
    jyolo.meta["strides"] = [8, 16, 32]
    jyolo.variables = variables
    pyolo = RTDETR("tinyrtdetr.yaml", device="cpu")
    pyolo.load_jax_variables(variables)
    return jyolo, pyolo


def test_predictor_rows_match_jax(rtdetr_pair):
    jyolo, pyolo = rtdetr_pair
    frames = np.random.default_rng(8).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    scores = np.sort(np.asarray(jyolo.predict_batched(frames, imgsz=64, conf=0.0))[..., 4], None)
    mid = scores[len(scores) // 4: 3 * len(scores) // 4]
    gap = int(np.argmax(np.diff(mid)))
    conf = float(mid[gap] + mid[gap + 1]) / 2  # in the widest score gap of the middle half
    want = np.asarray(jyolo.predict_batched(frames, imgsz=64, conf=conf))
    got = pyolo.predict_batched(frames, imgsz=64, conf=conf)
    assert got.shape == want.shape == (3, 84, 6)
    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    assert 0 < (got[..., 4] > 0).sum() < got[..., 4].size  # the conf filter cuts
    _close(got[..., :4], want[..., :4], 1e-4)
    _close(got[..., 4:], want[..., 4:], 1e-5)


class _Planted:
    """The synthetic val images with ground truth near the model's own best rows (4 an
    image, boxes moved by a few percent)."""

    def __init__(self, base, dets, seed=5):
        self.items = []
        rng = np.random.default_rng(seed)
        s = base.imgsz
        for i, d in enumerate(dets):
            d = d[d[:, 4] > 0][:4]
            item = {k: np.array(a) for k, a in base[i].items()}
            for k in ("cls", "bboxes", "mask"):
                item[k] = np.zeros_like(item[k])
            x1, y1, x2, y2 = d[:, :4].T
            w, h = x2 - x1, y2 - y1
            jit = rng.uniform(-0.06, 0.06, (len(d), 4)) * np.stack([w, h, w, h], 1)
            item["bboxes"][:len(d)] = (np.stack([(x1 + x2) / 2, (y1 + y2) / 2, w, h], 1) + jit) / s
            item["cls"][:len(d)] = d[:, 5]
            item["mask"][:len(d)] = 1
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_validator_on_planted_ground_truth_matches_jax(rtdetr_pair, tmp_path, monkeypatch):
    jyolo, pyolo = rtdetr_pair
    seen = _record_dets(monkeypatch, port_validator)
    pyolo.val(data="synthetic", imgsz=64, batch=16, project=str(tmp_path / "probe"))
    assert seen[0].shape == (16, 300, 6) and (seen[0][:, 84:] == 0).all()  # 84 queries
    ds = _Planted(SyntheticDataset(n=16, imgsz=64, nc=3, max_labels=16), seen[0])
    data = {"nc": 3, "names": {0: "c0", 1: "c1", 2: "c2"}}
    jargs = jax_get_cfg(overrides={"model": "tinyrtdetr.yaml", "mode": "val", "batch": 6,
                                   "imgsz": 64, "plots": False, "max_labels": 16, "max_det": 50})
    jargs.save_dir = str(tmp_path / "jax")
    pargs = get_cfg({"model": "tinyrtdetr.yaml", "batch": 6, "imgsz": 64, "max_labels": 16,
                     "max_det": 50})
    pargs.save_dir = str(tmp_path / "port")
    pdets = _record_dets(monkeypatch, port_validator)
    vmodel, vvars = jyolo._fused_for_serving()
    want = jax_validator.RTDETRValidator()(model=vmodel, variables=vvars, meta=jyolo.meta,
                                          dataset=ds, args=jargs, data=data)
    got = port_validator.RTDETRValidator()(model=pyolo._fused_for_serving(), meta=pyolo.meta,
                                          dataset=ds, args=pargs, data=data)
    assert [len(d) for d in pdets] == [6, 6, 4] and pdets[0].shape[1] == 50
    _assert_metrics_equal(got, want, 1e-6)
    assert 0.1 < got["metrics/mAP50-95(B)"] < got["metrics/mAP50(B)"]


def test_rtdetr_trains_and_serves_checkpoint(tmp_path):
    """tinyrtdetr's graph with the decoder trimmed by its YAML arguments (hd 32, 20 queries,
    2 layers), so that an epoch takes seconds on the CPU."""
    cfg = tmp_path / "tinyrtdetr-trim.yaml"
    text = (MODELS_DIR / "test" / "tinyrtdetr.yaml").read_text()
    cfg.write_text(text.replace("RTDETRDecoder, [nc]]", "RTDETRDecoder, [nc, 32, 20, 2]]"))
    m = RTDETR(str(cfg), device="cpu")
    assert m.model.blocks[-1].hd == 32 and m.model.blocks[-1].ndl == 2
    metrics = m.train(data="synthetic", imgsz=64, batch=16, epochs=1, workers=2,
                      max_labels=8, project=str(tmp_path))
    assert {"train/cls", "train/bbox", "train/giou", "metrics/mAP50(B)"} <= set(metrics)
    assert all(np.isfinite(metrics[k]) for k in ("train/cls", "train/bbox", "train/giou"))
    served = RTDETR(m.ckpt_dir, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    rows = served.predict_batched(frames, imgsz=64, conf=0.0)
    assert rows.shape == (2, 20, 6) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, m.predict_batched(frames, imgsz=64, conf=0.0), atol=1e-5)
    assert copy.deepcopy(served.meta)["head"] == "RTDETRDecoder"


def test_check_bf16_is_order_free_for_rtdetr():
    """bf16 rounding reorders RT-DETR's top-k queries: compared query by query (JAX's
    `check_bf16`) the boxes look divergent; sorted over the queries they agree, and the
    port's check passes, so amp stays on."""
    from sar_yolo_tpu_torch.nn.modules.conv import set_compute_dtype
    from sar_yolo_tpu_torch.nn.tasks import init_weights
    from sar_yolo_tpu_torch.utils.checks import check_bf16
    model, meta = build_model("rtdetr-l.yaml")
    init_weights(model, meta, torch.Generator().manual_seed(0))
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model.eval()(x)[0].float()
        set_compute_dtype(model, torch.bfloat16)
        b = model(x)[0].float()
    set_compute_dtype(model, torch.float32)

    def rel(p, q):
        return float((p - q).abs().mean() / (p.abs().mean() + 1e-6))
    assert rel(a, b) > 0.1 > 10 * rel(a.sort(-2)[0], b.sort(-2)[0])
    assert check_bf16(model, imgsz=64)
