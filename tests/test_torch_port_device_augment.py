"""The device augmentation of the PyTorch port against the JAX package's.

(a) `device_train_augment` with JAX's draws (`draw_params(key)` and the label-slot
uniforms of `fold_in(key, 0x5151)`) handed in: mosaic on and off, mixup, flips, HSV on
and off, on the same uint8 batch (S = 64, B = 4, M = 8): the normalized image within
1e-5, boxes within 1e-5, classes, tags and mask equal;
(b) the port's own `draw_params`: ranges, means and the partner span over many draws;
(c) `YOLODataset(device_augment=True)` items equal the JAX package's bit for bit;
(d) one tinyjde train step on the device route against JAX's, with the draws of
JAX's `kaug` (the split of `state.rng` inside its step) handed to the port: loss items
within the tolerance of `test_torch_port_train.py` (1e-5 relative; the triplet item
1e-5 of its gain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data import dataset as jax_dataset
from sar_yolo_tpu.data import device_augment as jax_da
from sar_yolo_tpu.parallel import shard_batch
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data.dataset import YOLODataset
from sar_yolo_tpu_torch.data.device_augment import (AUG_KEYS, AugParams, device_train_augment,
                                                    draw_params, label_slots)
from torch_port_common import (jax_jde_trainer, one_torch_thread, port_trainer_like,  # noqa: F401
                               write_jde_dataset)

B, S, M = 4, 64, 8
HYP = {k: float(v) for k, v in zip(AUG_KEYS, (0.5, 0.1, 0.5, 0.0, 0.015, 0.7, 0.4, 0.0))}


def jax_params(key, hyp: dict, mosaic: bool, n: int = B, side: int = S, m: int = M,
               span=None) -> AugParams:
    """JAX's draws for `key`, as the port's AugParams (CPU tensors)."""
    p = jax_da.draw_params(key, n, side, hyp, mosaic, partner_span=span)
    shuf = jax.random.uniform(jax.random.fold_in(key, 0x5151), (n, label_slots(m, hyp, mosaic)))
    t = [torch.from_numpy(np.array(x)) for x in (*p, shuf)]
    t[0] = t[0].long()
    return AugParams(*t)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, S // 8, S // 8, 3), dtype=np.uint8).repeat(8, 1).repeat(8, 2)
    img = (img.astype(np.int16) + rng.integers(-10, 11, img.shape)).clip(0, 255).astype(np.uint8)
    wh = rng.uniform(0.05, 0.4, (B, M, 2))
    cxy = rng.uniform(wh / 2, 1 - wh / 2)
    mask = (np.arange(M)[None] < rng.integers(2, M + 1, (B, 1))).astype(np.float32)
    return {"img": img, "cls": (rng.integers(0, 3, (B, M)) * mask).astype(np.float32),
            "bboxes": (np.concatenate([cxy, wh], -1) * mask[..., None]).astype(np.float32),
            "mask": mask, "tags": (rng.integers(0, 9, (B, M)) * mask).astype(np.float32)}


CASES = {
    "mosaic": (True, {}),
    "mosaic_mixup_flips": (True, {"mixup": 0.5, "fliplr": 0.5, "flipud": 0.5}),
    "mosaic_no_hsv_all_mixed": (True, {"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "mixup": 1.0}),
    "letterbox": (False, {}),
    "letterbox_flips_no_hsv": (False, {"fliplr": 1.0, "flipud": 1.0, "hsv_h": 0.0, "hsv_s": 0.0,
                                       "hsv_v": 0.0, "scale": 0.9, "translate": 0.3}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_train_augment_matches_jax(case):
    mosaic, over = CASES[case]
    hyp = {**HYP, **over}
    batch = _batch(sorted(CASES).index(case))
    key = jax.random.PRNGKey(3 + sorted(CASES).index(case))
    want = jax.jit(lambda b, k: jax_da.device_train_augment(b, k, hyp, mosaic=mosaic))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    got = device_train_augment({k: torch.from_numpy(v) for k, v in batch.items()},
                               jax_params(key, hyp, mosaic), hyp, mosaic=mosaic)
    assert got.keys() == want.keys()
    assert got["img"].dtype == torch.float32 and got["img"].shape == (B, S, S, 3)
    np.testing.assert_allclose(got["img"].numpy(), np.asarray(want["img"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["bboxes"].numpy(), np.asarray(want["bboxes"]), rtol=0, atol=1e-5)
    for k in ("cls", "tags", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["mask"].sum() > 0  # labels survive


def test_draw_params_statistics():
    n, side, span = 4096, 640, 16
    hyp = {**HYP, "mixup": 0.3, "flipud": 0.2}
    p = draw_params(np.random.default_rng(0), n, side, hyp, True, partner_span=span, M=5)
    again = draw_params(np.random.default_rng(0), n, side, hyp, True, partner_span=span, M=5)
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    i = torch.arange(n)[:, None]
    assert p.sel.dtype == torch.int64 and p.sel.shape == (n, 3)
    assert ((p.sel // span) == (i // span)).all()  # partners within the sample's span
    assert len(torch.unique(p.sel - (i // span) * span)) == span
    for t, lo, hi in ((p.yc, side / 2, 1.5 * side), (p.xc, side / 2, 1.5 * side),
                      (p.scale, 0.5, 1.5), (p.ty, 0.4 * side, 0.6 * side),
                      (p.tx, 0.4 * side, 0.6 * side), (p.mix_r, 0, 1)):
        assert t.dtype == torch.float32 and lo <= t.min() and t.max() <= hi
        assert abs(t.mean().item() - (lo + hi) / 2) < 0.02 * (hi - lo)
    assert abs(p.mix_r.std().item() - (1 / (4 * 65)) ** 0.5) < 0.005  # Beta(32, 32)
    for t, prob in ((p.fliplr, 0.5), (p.flipud, 0.2), (p.mix, 0.3)):
        assert t.dtype == torch.bool and abs(t.float().mean().item() - prob) < 0.03
    gains = torch.tensor([hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"]])
    assert ((p.hsv_gains - 1).abs() <= gains).all()
    assert ((p.hsv_gains - 1).abs().amax(0) > 0.95 * gains).all()
    assert p.shuf_u.shape == (n, 4 * 5 * 2) and 0 <= p.shuf_u.min() and p.shuf_u.max() < 1
    flat = draw_params(np.random.default_rng(1), 8, side, hyp, False, M=5)
    assert (flat.yc == side / 2).all() and (flat.xc == side / 2).all() and not flat.mix.any()
    assert flat.shuf_u.shape == (8, 5) and ((flat.sel // 8) == 0).all()


def test_device_augment_dataset_items_match_jax(tmp_path):
    write_jde_dataset(tmp_path, 6, 0)
    path = str(tmp_path / "images" / "train")
    kw = dict(imgsz=64, augment=True, use_tags=True, max_labels=8, task="jde", device_augment=True)
    got = YOLODataset(path, hyp=get_cfg({"copy_paste": 0.0, "seed": 3}), **kw)
    want = jax_dataset.YOLODataset(path, hyp=jax_get_cfg(overrides={"copy_paste": 0.0, "seed": 3}),
                                   **kw)
    assert got.device_augment and not got.augment and not got.mosaic_enabled
    assert want.device_augment and not want.augment
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys() == {"img", "cls", "bboxes", "mask", "tags"}
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"item {i} {k}")
        assert g["img"].shape == (64, 64, 3) and g["img"].dtype == np.uint8


def test_device_route_train_step_matches_jax(tmp_path, monkeypatch):
    common = dict(model="tinyjde.yaml", data="synthetic", device_augment=True, copy_paste=0.0,
                  imgsz=64, batch=4, nbs=4, workers=1, max_labels=8, seed=0, optimizer="SGD",
                  warmup_epochs=0.0, lr0=1e-3, mixup=0.5)
    jtr = jax_jde_trainer({**common, "mesh_shape": [1], "plots": False, "val": False,
                           "save": False, "project": str(tmp_path)}, seed=11, monkeypatch=monkeypatch)
    ptr = port_trainer_like(jtr, {**common, "project": str(tmp_path)})
    assert jtr._dev_aug and jtr._mosaic_on and ptr.device_augment and ptr._mosaic_on
    state = jtr.state
    _, rng = jax.random.split(state.rng)
    _, kaug = jax.random.split(rng)  # what JAX's step draws its augmentation from
    ptr.aug_params = lambda batch, i: jax_params(kaug, ptr.aug_hyp, True, span=B)
    jtr.train_loader.set_epoch(0)
    batch = next(iter(jtr.train_loader))
    _, _, jitems = jtr._train_step(state, shard_batch(jtr.mesh, batch), True)
    _, pitems = ptr.train_step(batch)
    got, want = pitems.numpy(), np.asarray(jitems)
    np.testing.assert_allclose(got[[0, 1, 2, 4]], want[[0, 1, 2, 4]], rtol=1e-5,
                               err_msg="loss items")
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5 * ptr.args.clr,
                               err_msg="triplet item")
