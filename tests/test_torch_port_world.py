"""YOLO-World of the PyTorch port against the JAX package (float32; inputs numpy-seeded).

(a) MaxSigmoidAttnBlock, C2fAttn and ImagePoolingAttn, eval and train mode (outputs and BN
statistics), within 1e-5;
(b) WorldDetect with and without its BN contrastive heads, eval and train mode, within
1e-5, with text rows (n, E) and batched (B, n, E);
(c) `offline_text_embeddings` equal to JAX's bit for bit;
(d) `.npz` round trips: a file written by either package reads back in the other, equal;
(e) `YOLOWorld.set_classes` with a changed vocabulary (4 names on a 3-class tinyworld): the
text rows equal JAX's, the served rows (class channels following the rows, convolutions
unchanged) within 1e-4 px and 1e-5 in score, the serving cache dropped; a `.npz` of other
names raises;
(f) `GroundingDataset` labels, texts, shapes and files equal to JAX's on a json the test
writes (crowd, zero-area and duplicate annotations, a missing image, `fraction`), and its
items through the port's loader;
(g) `info(detailed=True)` and `profile()` run on tinyworld and tinyrtdetr.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.data.dataset import GroundingDataset as JaxGroundingDataset
from sar_yolo_tpu.models.yolo import world as jax_world
from sar_yolo_tpu.nn.modules import block as JB
from sar_yolo_tpu.nn.modules import head as JH
from sar_yolo_tpu_torch.data.build import DataLoader
from sar_yolo_tpu_torch.data.dataset import GroundingDataset
from sar_yolo_tpu_torch.models.yolo import world as port_world
from sar_yolo_tpu_torch.nn.modules import block as PB
from sar_yolo_tpu_torch.nn.modules import head as PH
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _check_bn_stats(port_module, updates):
    own = port_module.state_dict()
    for k, w in from_jax_variables(jax.device_get(dict(updates))).items():
        if "running_" in k:
            np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=0, atol=ATOL, err_msg=k)


def _run(jm, pm, jargs, pargs, mode, to_port):
    """Both modules from the same fill_variables weights, in `mode`; returns (port, JAX)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs, train=False))
    v = fill_variables(shapes, np.random.default_rng(0))
    pm.load_state_dict(from_jax_variables(v), strict=True)
    train = mode == "train"
    pm.train(train)
    with torch.no_grad():
        got = pm(*pargs)
    if not train:
        return got, to_port(jm.apply(v, *jargs, train=False))
    want, updates = jm.apply(v, *jargs, train=True, mutable=["batch_stats"])
    _check_bn_stats(pm, updates)
    return got, to_port(want)


# ---- (a) the World blocks ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", ["MaxSigmoid", "MaxSigmoid_same_ec", "C2fAttn", "IPA"])
def test_world_block_matches_jax(case, mode):
    guide = _x(2, 5, 24, seed=3)
    x = _x(2, 6, 6, 16)
    maps = lambda out: np.asarray(out).transpose(0, 3, 1, 2)  # noqa: E731
    if case == "MaxSigmoid":
        jm = JB.MaxSigmoidAttnBlock(16, nh=2, ec=8, gc=24)
        pm = PB.MaxSigmoidAttnBlock(16, 16, 2, 8, 24)
        args = ([jnp.asarray(x), jnp.asarray(guide)], [_nchw(x), torch.tensor(guide)], maps)
    elif case == "MaxSigmoid_same_ec":  # c1 == ec: no embedding Conv
        jm = JB.MaxSigmoidAttnBlock(8, nh=4, ec=16, gc=24)
        pm = PB.MaxSigmoidAttnBlock(16, 8, 4, 16, 24)
        args = ([jnp.asarray(x), jnp.asarray(guide)], [_nchw(x), torch.tensor(guide)], maps)
        assert pm.ec is None
    elif case == "C2fAttn":
        jm, pm = JB.C2fAttn(24, n=2, ec=16, nh=2, gc=24), PB.C2fAttn(16, 24, 2, 16, 2, 24)
        args = ([jnp.asarray(x), jnp.asarray(guide)], [_nchw(x), torch.tensor(guide)], maps)
    else:
        xs = [_x(2, 8, 8, 16), _x(2, 4, 4, 32, seed=2), _x(2, 2, 2, 32, seed=4)]
        jm = JB.ImagePoolingAttn(ec=16, ch=(16, 32, 32), ct=24, nh=4)
        pm = PB.ImagePoolingAttn(16, (16, 32, 32), 24, 4)
        args = ([[jnp.asarray(a) for a in xs], jnp.asarray(guide)],
                [[_nchw(a) for a in xs], torch.tensor(guide)], np.asarray)
    got, want = _run(jm, pm, *args[:2], mode, args[2])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# ---- (b) WorldDetect ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("with_bn, batched", [(False, False), (True, False), (True, True)])
def test_world_detect_matches_jax(with_bn, batched, mode):
    ch = (16, 32, 32)
    xs = [_x(2, 8, 8, 16), _x(2, 4, 4, 32, seed=2), _x(2, 2, 2, 32, seed=4)]
    txt = _x(2, 5, 24, seed=6) if batched else _x(5, 24, seed=6)
    jm = JH.WorldDetect(nc=3, embed_dim=24, with_bn=with_bn, ch=ch)
    pm = PH.WorldDetect(nc=3, embed_dim=24, with_bn=with_bn, ch=ch)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), [jnp.asarray(a) for a in xs],
                                            train=False, txt=jnp.asarray(txt)))
    v = fill_variables(shapes, np.random.default_rng(0))
    pm.load_state_dict(from_jax_variables(v), strict=True)
    train = mode == "train"
    pm.train(train)
    with torch.no_grad():
        got = pm([_nchw(a) for a in xs], torch.tensor(txt))
    jxs = [jnp.asarray(a) for a in xs]
    if train:
        want, updates = jm.apply(v, jxs, train=True, txt=jnp.asarray(txt), mutable=["batch_stats"])
        _check_bn_stats(pm, updates)
    else:
        want = jm.apply(v, jxs, train=False, txt=jnp.asarray(txt))
    for g, w in zip(got, want):
        assert g.shape[1] == 64 + 5  # the class channels follow the text rows
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), rtol=0,
                                   atol=ATOL)


# ---- (c, d) the text encoders and the .npz files ---------------------------------------------

def test_offline_text_embeddings_bit_exact():
    names = ["person", "boat", "car", "backpack", "life jacket", "人", ""]
    for dim in (512, 64):
        got = port_world.offline_text_embeddings(names, dim)
        want = jax_world.offline_text_embeddings(names, dim)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_text_embeddings_npz_round_trip(tmp_path):
    names = ["person", "boat", "car"]
    emb = port_world.offline_text_embeddings(names, 32)
    port_world.save_text_embeddings(tmp_path / "port.npz", names, emb)
    np.savez(tmp_path / "jax.npz", names=np.asarray(names), embeddings=emb)  # JAX's layout
    for path in ("port.npz", "jax.npz"):
        for load in (port_world.load_text_embeddings, jax_world.load_text_embeddings):
            got_names, got = load(tmp_path / path)
            assert got_names == names and got.tobytes() == emb.tobytes()


# ---- (e) set_classes ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_pair():
    jyolo = jax_world.YOLOWorld("tinyworld.yaml")
    shapes = jax.eval_shape(lambda: jyolo.model.init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 64, 64, 3)), train=False))
    variables = fill_variables(shapes, np.random.default_rng(4))
    jyolo.meta["strides"] = [8, 16, 32]
    jyolo.variables = variables
    pyolo = port_world.YOLOWorld("tinyworld.yaml", device="cpu")
    pyolo.load_jax_variables(variables)
    return jyolo, pyolo


def test_set_classes_changes_vocabulary_as_jax(world_pair, tmp_path):
    jyolo, pyolo = world_pair
    frames = np.random.default_rng(2).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    before = pyolo.predict_batched(frames, imgsz=64, conf=0.0)
    names = ["person", "boat", "car", "backpack"]
    jyolo.set_classes(names)
    assert pyolo.set_classes(names) is pyolo and pyolo._predictor_cache is None
    assert pyolo.meta["nc"] == jyolo.meta["nc"] == 4 and pyolo.names == jyolo.meta["names"]
    np.testing.assert_array_equal(pyolo.model.text_embeddings.detach().numpy(),
                                  np.asarray(jyolo.variables["params"]["text_embeddings"]))
    want = np.asarray(jyolo.predict_batched(frames, imgsz=64, conf=0.3))
    got = pyolo.predict_batched(frames, imgsz=64, conf=0.3)
    assert got.shape == want.shape and set(np.unique(got[..., 5])) <= {0, 1, 2, 3}
    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    assert (got[..., 4] > 0).sum() > 0
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=1e-5)
    assert not np.allclose(before, pyolo.predict_batched(frames, imgsz=64, conf=0.0))
    port_world.save_text_embeddings(tmp_path / "other.npz", ["a", "b"],
                                    port_world.offline_text_embeddings(["a", "b"], 512))
    with pytest.raises(ValueError, match="precomputed embeddings are for"):
        pyolo.set_classes(names, embeddings=tmp_path / "other.npz")


# ---- (f) GroundingDataset ----------------------------------------------------------------------

def _write_grounding(root):
    import cv2
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    images, anns = [], []
    captions = ["a person in a boat near a car", "two boats and a dog", "a backpack", "gone"]
    for i, cap in enumerate(captions):
        h, w = (48, 64) if i % 2 else (64, 48)
        if i < 3:
            cv2.imwrite(str(root / "images" / f"{i}.png"),
                        rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        images.append({"id": i + 1, "file_name": f"{i}.png", "height": h, "width": w,
                       "caption": cap})
    spans = {1: [[[2, 8]], [[14, 18]], [[26, 29]], [[2, 8]], []],
             2: [[[4, 9]], [[4, 9]], [[16, 19]]], 3: [[[2, 10]]], 4: [[[0, 4]]]}
    for img_id, sp in spans.items():
        for j, tok in enumerate(sp):
            box = [float(v) for v in rng.uniform(2, 20, 4).round(1)]
            ann = {"id": len(anns), "image_id": img_id, "bbox": box, "tokens_positive": tok}
            if img_id == 1 and j == 3:
                ann["iscrowd"] = 1
            anns.append(ann)
    anns.append({**anns[5], "id": len(anns)})                    # an exact duplicate
    anns.append({**anns[0], "id": len(anns), "bbox": [1, 1, 0, 5]})  # no area
    path = root / "ann.json"
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return path


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_grounding_dataset_matches_jax(tmp_path, fraction):
    path = _write_grounding(tmp_path)
    kw = dict(imgsz=64, fraction=fraction, max_labels=8)
    want = JaxGroundingDataset(str(tmp_path / "images"), str(path), **kw)
    got = GroundingDataset(str(tmp_path / "images"), str(path), **kw)
    assert got.im_files == want.im_files and len(got) == (3 if fraction == 1 else 1)
    np.testing.assert_array_equal(got.shapes, want.shapes)
    for g, w in zip(got.labels, want.labels):
        assert g["texts"] == w["texts"]
        for k in ("cls", "bboxes", "tags"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got.labels[0]["texts"] == [["person"], ["boat"], ["car"], ["object"]]
    for i in range(len(got)):
        g, w = got[i], want[i]
        for k in ("img", "cls", "bboxes", "mask"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    batch = next(iter(DataLoader(got, len(got), workers=1, shuffle=False)))
    assert batch["img"].shape == (len(got), 64, 64, 3) and batch["mask"].sum() >= 3


@pytest.mark.parametrize("cls, name", [(port_world.YOLOWorld, "tinyworld.yaml"),
                                       ("RTDETR", "tinyrtdetr.yaml")])
def test_info_and_profile_run(cls, name):
    """`info(detailed=True)` and `profile()` (a meta-device forward under FlopCounterMode,
    whose module tracker refuses a view of a parameter as an input) on World and RT-DETR."""
    if cls == "RTDETR":
        from sar_yolo_tpu_torch import RTDETR as cls
    m = cls(name, device="cpu")
    table = m.info(detailed=True, verbose=False).splitlines()
    assert table[-1].split()[1] in ("WorldDetect", "RTDETRDecoder")
    info = m.profile(imgsz=64, n_iter=1)
    assert info["gflops"] > 0 and info["params"] == sum(p.numel() for p in m.model.parameters())
