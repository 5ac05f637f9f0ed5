"""SAM2's video path in the PyTorch port against the JAX package, at `sam2_test` size (see
test_torch_port_sam2.py; float32, numpy-seeded weights bridged from JAX's variables).

(a) `encode_memory` (mask logits resized 4x by JAX's bilinear rule, sigmoid-scaled, into the
memory encoder) within 2e-4, for 3 objects at once against JAX's call per object;
(b) `condition_on_memory` within 2e-4, for 3 objects' banks at once (or one a chunk, under a
small logits budget) against JAX's call per object: banks with invalid slots, every slot
valid, mixed and repeated `tpos`, and no `tpos`;
(c) the video predictor on JAX's 3-frame scene of `test_sam2_video_tracking` (one point
prompt) and on a 9-frame scene with two box prompts, where the ring of slots 1..6 wraps:
at each frame the masks equal wherever JAX's logit is not within 1e-4 of 0, scores and object
logits within 1e-4, the bank within 2e-4 and its validity, slot and tpos equal; then
`SAM.track` against JAX's `SAM2VideoPredictor.__call__`: per frame the same masks (up to the
pixels within 1e-4 of 0), boxes within 1 px, scores within 1e-4, the id column and `frame`
equal; a model that is not SAM2 raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.models.sam.predict import SAM2VideoPredictor as JaxVideoPredictor
from sar_yolo_tpu_torch.models.sam import SAM, SAM2VideoPredictor, modules2
from test_torch_port_sam import ATOL, IOU_TOL, _assert_masks_match, _jax_logits, _nhwc, port_sam
from test_torch_port_sam2 import jax_sam2
from torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def models():
    module, variables = jax_sam2(seed=1)
    return module, variables, port_sam("sam2_test", variables)


def _embed(seed: int, n: int = 1):
    return np.random.default_rng(seed).standard_normal((n, 8, 8, 256)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


# ---- (a) the memory encoder ----------------------------------------------------------

def test_encode_memory_matches_jax(models):
    module, variables, sam = models
    raw = _embed(0)
    logits = (np.random.default_rng(1).standard_normal((3, 32, 32, 1)) * 4).astype(np.float32)
    run = jax.jit(lambda v, r, m: module.apply(v, r, m, method="encode_memory"))
    want = np.concatenate([np.asarray(run(variables, jnp.asarray(raw), jnp.asarray(m[None])))
                           for m in logits])
    with torch.no_grad():
        got = sam.model.encode_memory(_nchw(raw), _nchw(logits))
    assert got.shape == want.shape == (3, 8, 8, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# ---- (b) the memory attention ----------------------------------------------------------

BANKS = {  # validity of the 7 slots for each of 3 objects, and tpos (None: slot order)
    "invalid_slots_mixed_tpos": ([[1, 0, 1, 1, 0, 0, 1], [1, 1, 0, 0, 0, 0, 0],
                                  [1, 1, 1, 1, 1, 1, 1]], [0, 6, 1, 3, 6, 6, 2]),
    "all_valid_repeated_tpos": ([[1] * 7] * 3, [0, 1, 1, 2, 9, 4, 5]),
    "slot_order": ([[1, 1, 1, 0, 0, 0, 0]] * 3, None),
}


@pytest.mark.parametrize("kind", sorted(BANKS))
def test_condition_on_memory_matches_jax(models, monkeypatch, kind):
    """The slot-order bank is conditioned one object a chunk (a logits budget under two
    objects'), the others in one chunk."""
    module, variables, sam = models
    if kind == "slot_order":
        monkeypatch.setattr(modules2, "LOGITS_BUDGET", 64 * 7 * 64 * 4 + 1)
    valid, tpos = (np.asarray(v, np.float32) if v is not None else None for v in BANKS[kind])
    raw = _embed(2)
    bank = np.random.default_rng(3).standard_normal((3, 7, 8, 8, 64)).astype(np.float32)
    run = jax.jit(lambda v, r, b, ok, t: module.apply(v, r, b, ok, t,
                                                       method="condition_on_memory"))
    jt = None if tpos is None else jnp.asarray(tpos.astype(np.int32))
    want = np.concatenate([np.asarray(run(variables, jnp.asarray(raw), jnp.asarray(b),
                                          jnp.asarray(ok), jt)) for b, ok in zip(bank, valid)])
    with torch.no_grad():
        got = sam.model.condition_on_memory(
            _nchw(raw), torch.from_numpy(bank), torch.from_numpy(valid),
            None if tpos is None else torch.from_numpy(tpos.astype(np.int64)))
    assert got.shape == (3, 256, 8, 8)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)


# ---- (c) the video predictor -------------------------------------------------------------

def _jax_scene():
    """test_sam2_video_tracking's frames: a red box moving 6 px a frame."""
    frames = []
    for t in range(3):
        f = np.full((96, 160, 3), 40, np.uint8)
        x0 = 40 + 6 * t
        f[20:70, x0:x0 + 80] = (200, 60, 60)
        frames.append(f)
    return frames


def _ring_scene():
    """9 frames with two boxes crossing: the ring of slots 1..6 wraps after the 7th step."""
    frames = []
    for t in range(9):
        f = np.full((96, 160, 3), 30, np.uint8)
        f[10 + 2 * t:50 + 2 * t, 20 + 5 * t:70 + 5 * t] = (40, 180, 220)
        f[40:90, 120 - 6 * t:150 - 6 * t] = (200, 60, 60)
        frames.append(f)
    return frames


SCENES = {"jax_scene": (_jax_scene, dict(points=[[80, 45]])),
          "ring_wraps": (_ring_scene, dict(bboxes=[[20, 10, 70, 50], [120, 40, 150, 90]]))}


@pytest.fixture(scope="module")
def video(models):
    module, variables, sam = models
    return JaxVideoPredictor(module, variables, imgsz=128), SAM2VideoPredictor(sam.model,
                                                                               imgsz=128)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_track_steps_match_jax(video, monkeypatch, scene):
    jv, pv = video
    make, prompts = SCENES[scene]
    frames = make()
    captured = []
    orig = jv._masks_to_original
    monkeypatch.setattr(jv, "_masks_to_original", lambda low: captured.append(low) or orig(low))
    jm0, js = jv.init_video(frames[0], **prompts)
    pm0, ps = pv.init_video(frames[0], **prompts)
    np.testing.assert_allclose(pm0.numpy(), np.asarray(jm0), atol=ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=IOU_TOL)
    T = 7
    for i, frame in enumerate(frames[1:]):
        tpos, slot = pv.ring_state()
        assert slot == 1 + i % (T - 1)
        jmask, jscore, jobj = jv.track_step(frame)
        pmask, pscore, pobj = pv.track_step(frame)
        label = f"{scene} frame {i + 1}"
        _assert_masks_match(pmask, _jax_logits(jv, captured[-1]), label)
        np.testing.assert_allclose(pscore, jscore, atol=IOU_TOL, err_msg=label)
        np.testing.assert_allclose(pobj, jobj, atol=IOU_TOL, err_msg=label)
        np.testing.assert_allclose(pv._bank.numpy(), np.asarray(jv._bank), atol=ATOL,
                                   err_msg=label)
        np.testing.assert_array_equal(pv._valid.numpy(), np.asarray(jv._valid))
        np.testing.assert_array_equal(pv._slot_frame, jv._slot_frame)
        assert pv.last_step["slot"] == slot and (pv.last_step["tpos"] == tpos).all()
    if scene == "ring_wraps":
        assert pv._slot_frame.tolist() == [-1, 6, 7, 2, 3, 4, 5]
        assert pv.ring_state()[0].tolist() == [0, 3, 2, 6, 6, 5, 4]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_sam_track_matches_jax(models, video, scene):
    jv, _ = video
    sam = models[2]
    make, prompts = SCENES[scene]
    frames = make()
    want = jv(frames, **prompts)
    got = sam.track(frames, **prompts)
    assert len(got) == len(want) == len(frames)
    for i, (g, w) in enumerate(zip(got, want)):
        n = len(w.boxes.data)
        assert g.frame == w.frame == i
        assert g.masks.data.shape == w.masks.data.shape == (n, 96, 160)
        assert (g.masks.data != w.masks.data).mean() < 1e-2
        assert g.boxes.data.shape == w.boxes.data.shape == (n, 7)
        np.testing.assert_allclose(g.boxes.data[:, :4], w.boxes.data[:, :4], atol=1.0)
        np.testing.assert_allclose(g.boxes.data[:, 4], w.boxes.data[:, 4], atol=IOU_TOL)
        np.testing.assert_array_equal(g.boxes.data[:, 5:], w.boxes.data[:, 5:])
        assert g.boxes.data[:, 6].tolist() == list(range(n))


def test_track_needs_sam2_and_prompts(models):
    with pytest.raises(ValueError, match="SAM2"):
        SAM("sam_test", device="cpu").track([np.zeros((32, 32, 3), np.uint8)])
    with pytest.raises(ValueError, match="prompts"):
        models[2].track([np.zeros((32, 32, 3), np.uint8)])
