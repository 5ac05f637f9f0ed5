"""The training losses of the PyTorch port against the JAX package.

Same numpy inputs through both: the loss-side box ops, `flatten_feats`, the
task-aligned assigner (padded ground-truth rows, forced ties, anchors claimed
by several ground truths), the DFL and triplet terms, and `detection_loss` /
`jde_loss` with gradients with respect to the head maps and the class-balanced
counts threaded over calls.

Tolerances: loss values 1e-5 relative; gradients 1e-4 of the tensor's largest
magnitude; the assigner's masks, indices, labels and tags exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.ops import boxes as JBX
from sar_yolo_tpu.ops.decode import flatten_feats as jax_flatten_feats
from sar_yolo_tpu.utils import loss as JL
from sar_yolo_tpu.utils.tal import task_aligned_assigner as jax_assigner
from sar_yolo_tpu_torch.ops import boxes as PBX
from sar_yolo_tpu_torch.ops.decode import flatten_feats
from sar_yolo_tpu_torch.utils import loss as PL
from sar_yolo_tpu_torch.utils.tal import task_aligned_assigner
from torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL = 1e-5
HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5, clr=0.5, state=1.0, state_focal_gamma=2.0,
                      use_state_cb=True, state_cb_beta=0.999)
LEVELS = [(8, 8), (4, 4), (2, 2)]  # a 64 px input at strides 8, 16, 32
STRIDES = [8, 16, 32]


def _t(a):
    return torch.tensor(np.asarray(a))


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-4 * np.abs(want).max())


def _boxes(rng, shape, scale=64.0):
    xy = rng.uniform(0, scale * 0.7, (*shape, 2))
    wh = rng.uniform(scale * 0.05, scale * 0.5, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["IoU", "GIoU", "DIoU", "CIoU"])
def test_bbox_iou_matches_jax(mode):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, (5, 1)), _boxes(rng, (1, 7))
    kw = {} if mode == "IoU" else {mode: True}
    want = JBX.bbox_iou(jnp.asarray(a), jnp.asarray(b), **kw)
    np.testing.assert_allclose(PBX.bbox_iou(_t(a), _t(b), **kw).numpy(), np.asarray(want),
                               rtol=RTOL, atol=1e-7)
    # gradients: CIoU's alpha carries none on either side
    jg = jax.grad(lambda x: JBX.bbox_iou(x, jnp.asarray(b), **kw).sum())(jnp.asarray(a))
    x = _t(a).requires_grad_()
    PBX.bbox_iou(x, _t(b), **kw).sum().backward()
    _grad_close(x.grad.numpy(), jg)
    # xywh input
    aw, bw = JBX.xyxy2xywh(jnp.asarray(a)), JBX.xyxy2xywh(jnp.asarray(b))
    np.testing.assert_allclose(PBX.xyxy2xywh(_t(a)).numpy(), np.asarray(aw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(PBX.bbox_iou(_t(aw), _t(bw), xywh=True, **kw).numpy(),
                               np.asarray(JBX.bbox_iou(aw, bw, xywh=True, **kw)),
                               rtol=RTOL, atol=1e-6)


def test_bbox2dist_matches_jax():
    rng = np.random.default_rng(1)
    anchors = rng.uniform(0, 8, (30, 2)).astype(np.float32)
    bb = _boxes(rng, (2, 30), scale=40.0) - 12.0  # both clamps active
    want = JBX.bbox2dist(jnp.asarray(anchors)[None], jnp.asarray(bb), 15)
    got = PBX.bbox2dist(_t(anchors)[None], _t(bb), 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert float(got.min()) == 0.0 and float(got.max()) == pytest.approx(14.99)


def test_flatten_feats_matches_jax():
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(2, h, w, 5)).astype(np.float32) for h, w in LEVELS]
    want, whw = jax_flatten_feats([jnp.asarray(f) for f in feats])
    got, hw = flatten_feats([_t(f.transpose(0, 3, 1, 2)) for f in feats])
    assert hw == whw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assigner_inputs(seed=3, B=2, M=6, nc=3):
    """Scores, boxes and ground truths with padded rows, ties and overlapping ground truths."""
    rng = np.random.default_rng(seed)
    anchors, strides = JBX.make_anchors(LEVELS, STRIDES)
    anc = np.asarray(anchors * strides)
    N = anc.shape[0]
    gt = _boxes(rng, (B, M), scale=64.0)
    gt[:, 1] = gt[:, 0] + rng.uniform(-4, 4, (B, 4)).astype(np.float32)  # overlaps gt 0
    mask = np.ones((B, M), np.float32)
    mask[0, 4:] = 0
    gt[0, 4:] = 0  # padded rows
    labels = rng.integers(0, nc, (B, M)).astype(np.float32)
    tags = rng.integers(0, 4, (B, M)).astype(np.float32)
    scores = rng.uniform(0.01, 1, (B, N, nc)).astype(np.float32)
    centre = np.concatenate([anc - rng.uniform(2, 20, (N, 2)), anc + rng.uniform(2, 20, (N, 2))], -1)
    pd = np.broadcast_to(centre, (B, N, 4)).astype(np.float32).copy()
    # ties: a run of anchors with the same box and score, inside ground truth 2
    inside = np.where((anc[:, 0] > gt[1, 2, 0]) & (anc[:, 0] < gt[1, 2, 2]) &
                      (anc[:, 1] > gt[1, 2, 1]) & (anc[:, 1] < gt[1, 2, 3]))[0]
    assert len(inside) >= 3
    pd[1, inside] = gt[1, 2] + 1.0
    scores[1, inside] = 0.5
    return scores, pd, anc.astype(np.float32), labels, gt, mask, tags, inside


def test_assigner_matches_jax_exactly():
    scores, pd, anc, labels, gt, mask, tags, tied = _assigner_inputs()
    want = jax_assigner(*(jnp.asarray(a) for a in (scores, pd, anc, labels.astype(np.int32), gt,
                                                    mask, tags.astype(np.int32))),
                        topk=4, num_classes=3)
    got = task_aligned_assigner(*(_t(a) for a in (scores, pd, anc, labels.astype(np.int64), gt,
                                                 mask, tags.astype(np.int64))),
                                topk=4, num_classes=3)
    for key in ("fg_mask", "target_gt_idx", "target_labels", "target_tags"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                      err_msg=key)
    for key in ("target_scores", "target_bboxes"):
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                   rtol=RTOL, atol=1e-6, err_msg=key)
    fg = got.fg_mask.numpy()
    assert fg[1, tied].any() and not fg[1, tied].all()  # top-4 cut the tie, by index
    assert 0 < fg.sum() < fg.size
    assert not (got.target_gt_idx.numpy()[0][fg[0]] >= 4).any()  # padded rows never assigned


def test_df_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    target = rng.uniform(-1, 16.5, (2, 9, 4)).astype(np.float32)
    want = JL._df_loss(jnp.asarray(logits), jnp.asarray(target), 16)
    np.testing.assert_allclose(PL._df_loss(_t(logits), _t(target), 16).numpy(), np.asarray(want),
                               rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("case", ["semihard_drops", "n_total_gating", "fg_over_k"])
def test_triplet_loss_matches_jax(case):
    rng = np.random.default_rng({"semihard_drops": 14, "n_total_gating": 14, "fg_over_k": 7}[case])
    K, D = 16, 3  # few dimensions: semihard negatives close enough for a positive loss
    emb = rng.normal(size=(K, D)).astype(np.float32)
    tags = rng.integers(0, 3, K).astype(np.int32)
    conf = rng.uniform(0.1, 1, K).astype(np.float32)
    valid = np.ones(K, bool)
    n_total = None
    if case == "semihard_drops":  # collapsed identities: some anchors have no semihard negative
        emb[tags == 0] = emb[tags == 0][:1] + 1e-3 * rng.normal(size=((tags == 0).sum(), D))
        valid[-3:] = False
    elif case == "n_total_gating":
        conf[3] = conf[4]  # a tie at the cut keeps both
        n_total = np.int32(9)
    else:  # more foreground than candidates: keep = floor(0.5 * 40) clamps to the valid count
        n_total = np.int32(40)
    jargs = [jnp.asarray(a) for a in (emb, tags, conf, valid)]
    jf = (lambda e: JL.triplet_embedding_loss(e, *jargs[1:], n_total=None if n_total is None
                                               else jnp.asarray(n_total)))
    want, jg = jax.value_and_grad(jf)(jargs[0])
    e = _t(emb).requires_grad_()
    got = PL.triplet_embedding_loss(e, _t(tags).long(), _t(conf), _t(valid),
                                    n_total=None if n_total is None else torch.tensor(n_total))
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    _grad_close(e.grad.numpy(), jg)


def _loss_inputs(seed, nc, extra, B=2, M=5):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1.5, (B, h, w, 64 + nc + extra)).astype(np.float32) for h, w in LEVELS]
    xy = rng.uniform(0.2, 0.8, (B, M, 2))
    wh = rng.uniform(0.1, 0.5, (B, M, 2))
    batch = {"cls": rng.integers(0, nc, (B, M)).astype(np.float32),
             "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
             "mask": np.ones((B, M), np.float32),
             "tags": rng.integers(0, 4, (B, M)).astype(np.float32)}
    batch["mask"][1, 3:] = 0
    batch["bboxes"][1, 3:] = 0
    return feats, batch


def test_detection_loss_and_gradients_match_jax():
    feats, batch = _loss_inputs(8, nc=2, extra=0)
    kw = dict(nc=2, reg_max=16, strides=STRIDES)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jf(fs):
        out = JL.detection_loss(fs, jb, HYP, **kw)
        return out.total, out.items
    (wt, witems), jg = jax.value_and_grad(jf, has_aux=True)([jnp.asarray(f) for f in feats])
    pf = [_t(f.transpose(0, 3, 1, 2)).requires_grad_() for f in feats]
    out = PL.detection_loss(pf, {k: _t(v) for k, v in batch.items()}, HYP, **kw)
    out.total.backward()
    assert (np.asarray(witems) > 1e-3).all()
    np.testing.assert_allclose(out.items.numpy(), np.asarray(witems), rtol=RTOL)
    np.testing.assert_allclose(out.total.item(), float(wt), rtol=RTOL)
    for p, g in zip(pf, jg):
        _grad_close(p.grad.numpy().transpose(0, 2, 3, 1), g)


def test_jde_loss_gradients_and_cb_counts_match_jax():
    nc, E, S = 2, 8, 3
    kw = dict(nc=nc, reg_max=16, strides=STRIDES, embed_dim=E, state_classes=S)
    jcb, pcb = jnp.zeros(S, jnp.float32), torch.zeros(S)
    for call in range(5):  # the counts thread through the calls
        feats, batch = _loss_inputs(20 + call, nc=nc, extra=E + S)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def jf(fs):
            out = JL.jde_loss(fs, jb, HYP, cb_counts=jcb, **kw)
            return out.total, (out.items, out.cb_counts)
        (wt, (witems, jcb)), jg = jax.value_and_grad(jf, has_aux=True)(
            [jnp.asarray(f) for f in feats])
        pf = [_t(f.transpose(0, 3, 1, 2)).requires_grad_() for f in feats]
        out = PL.jde_loss(pf, {k: _t(v) for k, v in batch.items()}, HYP, cb_counts=pcb, **kw)
        out.total.backward()
        pcb = out.cb_counts
        np.testing.assert_allclose(out.items.numpy(), np.asarray(witems), rtol=RTOL,
                                   err_msg=f"call {call}")
        np.testing.assert_allclose(out.total.item(), float(wt), rtol=RTOL)
        np.testing.assert_allclose(pcb.numpy(), np.asarray(jcb), rtol=RTOL, atol=1e-9)
        for p, g in zip(pf, jg):
            _grad_close(p.grad.numpy().transpose(0, 2, 3, 1), g)
    assert (np.asarray(witems) > 1e-4).all()  # every term is live
    assert (pcb.numpy() > 0).sum() >= 2
