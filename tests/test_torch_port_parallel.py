"""Data parallelism of the PyTorch port against the JAX package's mesh (CPU, gloo).

(i)/(ii) Train steps of tinyjde and tinydet (imgsz 64, global batch 8, SGD) on two ranks,
    spawned by `parallel.spawn` (`engine/trainer.py::train_steps`: each rank its 4 rows,
    DDP, global BatchNorm statistics, the global batch's loss), against JAX's trainer on a
    `mesh_shape=[2]` mesh over the same batches: every step's loss items and cb_counts, and
    after 3 steps the BN statistics, parameters and EMA, with `assert_trajectories_match`'s
    tolerances; the two ranks' parameters, statistics and EMA equal to each other exactly.
    The same on a loss with no discrete decision (`probe_functional`), float32 and float64,
    each gradient against the one-process step's.
(iii) The device augmentation under two ranks (simulated: each rank's `to_device` on its rows
    with `rank_and_world` set): the ranks' augmented batches, concatenated, equal
    `device_train_augment` of the global batch with `partner_span = B // 2` on the same draws.
(iv) `predict_batched(mesh_shape=[2])` of every task (tinydet, tinyjde, tinypose, tinyseg,
    tinyobb, tinycls) against the port unsharded and against JAX's `mesh_shape=[2]`.
(v) `YOLO.val(mesh_shape=[2])` equals the unsharded val; a batch that does not split warns
    and runs on one device, as JAX's validator does.
(vi) Refusals: a `tp` axis (`mesh_shape=[2, 2]`), a batch that does not split over the ranks,
    a mesh larger than the devices, a mesh_shape trainer outside a process group.
(vii) `process_shard` and `sync_flag` against JAX's; `host_local_batch_to_global` on two gloo
    ranks, each with its half of a batch, against JAX's on the same batch;
    `YOLO.train(mesh_shape=[2])` runs two gloo ranks end to end (the epoch's validation and checkpoints on rank 0).
"""

import jax
import numpy as np
import pytest
import torch

from sar_yolo_tpu.parallel import mesh as jax_mesh
from sar_yolo_tpu.parallel import shard_batch as jax_shard_batch
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.data.device_augment import device_train_augment, draw_params
from sar_yolo_tpu_torch.engine.trainer import TRAINERS, train_steps
from sar_yolo_tpu_torch.parallel import mesh as port_mesh
from sar_yolo_tpu_torch.parallel import get_mesh, process_shard, shard_batch, spawn, sync_flag
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import jax_and_port_yolo, jax_jde_trainer, one_torch_thread  # noqa: F401


def _common(model: str) -> dict:
    return dict(model=model, data="synthetic", imgsz=64, batch=8, nbs=8, workers=1,
                max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0, lr0=1e-3,
                device_augment=False)


@pytest.mark.parametrize("task,model", [("jde", "tinyjde.yaml"), ("detect", "tinydet.yaml")])
def test_two_rank_steps_match_jax_mesh(task, model, tmp_path, monkeypatch):
    common = _common(model)
    jtr = jax_jde_trainer({**common, "mesh_shape": [2], "plots": False, "val": False,
                           "save": False, "project": str(tmp_path)}, seed=11,
                          monkeypatch=monkeypatch, task=task)
    assert jtr.mesh.devices.shape == (2,)
    start = from_jax_variables(jax.device_get({"params": jtr.state.params,
                                               "batch_stats": jtr.state.batch_stats}))
    state, batches, jitems, jcb = jtr.state, [], [], []
    jtr.train_loader.set_epoch(0)
    for _, batch in zip(range(3), jtr.train_loader):
        state, _, it = jtr._train_step(state, jax_shard_batch(jtr.mesh, batch), jtr._mosaic_on)
        batches.append(batch)
        jitems.append(np.asarray(it))
        jcb.append(np.asarray(state.cb_counts))
    out = spawn(train_steps, (TRAINERS[task], {**common, "mesh_shape": [2],
                                               "project": str(tmp_path)}, batches, start),
                devices=["cpu", "cpu"])
    assert out["rank_spread"] == 0.0  # the two replicas are equal
    assert out["gathered_bytes"] > 0
    for i, (got, want) in enumerate(zip(out["items"], jitems)):
        got = got.numpy()
        if i == 0 and task == "jde":
            np.testing.assert_allclose(got[[0, 1, 2, 4]], want[[0, 1, 2, 4]], rtol=1e-5)
            np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5 * 0.5)  # clr 0.5
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5 if i == 0 else 1e-2,
                                       err_msg=f"loss items, step {i + 1}")
        np.testing.assert_allclose(out["cb_counts"][i].numpy(), jcb[i], rtol=1e-5, atol=1e-9)
    want = from_jax_variables(jax.device_get({"params": state.params,
                                              "batch_stats": state.batch_stats}))
    moved = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        tol = 1e-4 * w.abs().max().item()
        np.testing.assert_allclose(out["state"][key].numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=key)
        moved += int((out["state"][key] - start[key]).abs().max() > tol)
    assert moved > len(want) // 3, f"only {moved} tensors moved"
    ema = from_jax_variables(jax.device_get({"params": state.ema_params}))
    for name, e in out["ema"].items():
        np.testing.assert_allclose(e.numpy(), ema[name].numpy(), rtol=0,
                                   atol=1e-4 * ema[name].abs().max().item(), err_msg=name)


@pytest.mark.parametrize("float64", [False, True])
def test_two_rank_probe_gradients_match_one_process(float64, tmp_path):
    """The data-parallel step on a loss with no discrete decision in it (`probe_functional`):
    two gloo ranks' gradients against the one-process step's, tensor by tensor, within 1e-4
    (float32; 1.6e-5 measured) or 1e-10 (float64; 2.9e-14 measured) of the tensor's largest
    magnitude, or of 1e-9 of the model's largest gradient (those a later BN makes zero)."""
    common = {**_common("tinyjde.yaml"), "project": str(tmp_path)}
    tr = TRAINERS["jde"](common, device="cpu")
    tr.setup()
    tr.train_loader.set_epoch(0)
    batch = next(iter(tr.train_loader))
    start = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    args = ([batch], start, 0, float64, 7)
    one = train_steps(0, "cpu", TRAINERS["jde"], common, *args)["grads"][0]
    two = spawn(train_steps, (TRAINERS["jde"], {**common, "mesh_shape": [2]}, *args),
                devices=["cpu", "cpu"])["grads"][0]
    g_max = max(g.abs().max().item() for g in one.values())
    worst = max((two[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-9 * g_max)
                for n, g in one.items())
    assert worst <= (1e-10 if float64 else 1e-4), worst


def test_device_augment_over_two_ranks(tmp_path, monkeypatch):
    tr = TRAINERS["jde"]({**_common("tinyjde.yaml"), "device_augment": True, "copy_paste": 0.0,
                          "mixup": 0.5, "project": str(tmp_path)}, device="cpu")
    tr.setup()
    assert tr.device_augment and tr._mosaic_on
    tr.train_loader.set_epoch(0)
    batch = next(iter(tr.train_loader))
    B, S = batch["img"].shape[:2]
    params = draw_params(np.random.default_rng((0, 0, 5)), B, S, tr.aug_hyp, True,
                         partner_span=B // 2, M=batch["bboxes"].shape[1])
    full = device_train_augment({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                                params, tr.aug_hyp, mosaic=True, partner_span=B // 2)
    tr.world = 2
    parts = []
    for rank in (0, 1):
        monkeypatch.setattr(port_mesh, "rank_and_world", lambda r=rank: (r, 2))
        parts.append(tr.to_device(shard_batch(batch), 5))
    for k in ("cls", "bboxes", "mask", "tags"):
        got = torch.cat([p[k] for p in parts])
        assert torch.equal(got, full[k]), k
    got = torch.cat([p["img"] for p in parts])
    assert torch.equal(got, full["img"].permute(0, 3, 1, 2))


@pytest.mark.parametrize("cfg", ["tinydet.yaml", "tinyjde.yaml", "tinypose.yaml",
                                 "tinyseg.yaml", "tinyobb.yaml", "tinycls.yaml"])
def test_sharded_serving_all_tasks(cfg):
    jyolo, pyolo = jax_and_port_yolo(cfg, 3, bias_init=cfg != "tinycls.yaml")
    frames = np.random.default_rng(0).integers(0, 256, (4, 48, 64, 3), np.uint8)
    kw = dict(imgsz=64, conf=0.01)
    one = pyolo.predict_batched(frames, **kw)
    two = pyolo.predict_batched(frames, mesh_shape=[2], **kw)
    want = jyolo.predict_batched(frames, mesh_shape=[2], **kw)
    one, two, want = (jax.tree.leaves(o) for o in (one, two, want))
    assert len(one) == len(two) == len(want) and len(two[0]) == 4
    for a, b, w in zip(one, two, want):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(w, np.float32),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("cfg", ["tinydet.yaml", "tinyjde.yaml", "tinypose.yaml",
                                 "tinyseg.yaml", "tinyobb.yaml", "tinycls.yaml"])
def test_sharded_val_equals_unsharded(cfg, tmp_path):
    m = YOLO(cfg, device="cpu")
    kw = dict(imgsz=32, batch=4, workers=1, project=str(tmp_path), verbose=False)
    one, two = m.val(**kw), m.val(mesh_shape=[2], **kw)
    one.pop("speed/ms_per_image", None), two.pop("speed/ms_per_image", None)
    assert set(one) == set(two) and one
    for k in one:
        assert one[k] == pytest.approx(two[k], rel=1e-6, abs=1e-9), k


def test_val_warns_where_the_batch_does_not_split(tmp_path, monkeypatch):
    from sar_yolo_tpu_torch.engine import validator
    warned = []
    monkeypatch.setattr(validator.LOGGER, "warning", warned.append)
    m = YOLO("tinydet.yaml", device="cpu")
    kw = dict(imgsz=32, batch=3, workers=1, project=str(tmp_path), verbose=False)
    got = m.val(mesh_shape=[2], **kw)
    assert any("running single-device" in w for w in warned)
    one = m.val(**kw)
    assert {k: v for k, v in got.items() if not k.startswith("speed")} == \
        {k: v for k, v in one.items() if not k.startswith("speed")}


def test_refusals(tmp_path):
    kw = dict(model="tinydet.yaml", data="synthetic", imgsz=32, project=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TRAINERS["detect"]({**kw, "mesh_shape": [2, 2]}, device="cpu")
    with pytest.raises(NotImplementedError, match="tp axis"):
        YOLO("tinydet.yaml", device="cpu").predict_batched(
            np.zeros((4, 32, 32, 3), np.uint8), mesh_shape=[2, 2], imgsz=32)
    with pytest.raises(ValueError, match="does not split"):
        YOLO("tinydet.yaml", device="cpu").train(**kw, batch=3, mesh_shape=[2])
    with pytest.raises(ValueError, match="YOLO.train"):
        TRAINERS["detect"]({**kw, "batch": 4, "mesh_shape": [2]}, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        get_mesh([2], devices=[torch.device("cpu")])
    with pytest.raises(ValueError, match="does not split"):
        YOLO("tinydet.yaml", device="cpu").predict_batched(
            np.zeros((3, 32, 32, 3), np.uint8), mesh_shape=[2], imgsz=32)


@pytest.mark.parametrize("n,world,seed", [(7, 1, None), (7, 2, None), (10, 3, 3), (8, 2, 5)])
def test_process_shard_and_sync_flag_match_jax(n, world, seed, monkeypatch):
    for rank in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(port_mesh, "rank_and_world", lambda r=rank: (r, world))
        np.testing.assert_array_equal(process_shard(n, seed), jax_mesh.process_shard(n, seed))
    monkeypatch.undo()
    for v in (True, False):
        assert sync_flag(v) == jax_mesh.sync_flag(v) == v


def _gather_halves(rank: int, device, batch: dict) -> dict:
    """One rank of the test below: its rows of `batch`, all-gathered again."""
    return port_mesh.host_local_batch_to_global(shard_batch(batch))


def test_host_local_batch_to_global_matches_jax():
    rng = np.random.default_rng(4)
    batch = {"img": rng.integers(0, 256, (8, 5, 6, 3), np.uint8),
             "bboxes": rng.random((8, 3, 4), np.float32),
             "mask": torch.from_numpy(rng.integers(0, 2, (8, 3)))}
    got = spawn(_gather_halves, (batch,), devices=["cpu", "cpu"])
    want = jax_mesh.host_local_batch_to_global(
        jax_mesh.get_mesh([2]), {k: np.asarray(v) for k, v in batch.items()})
    assert isinstance(got["img"], np.ndarray) and torch.is_tensor(got["mask"])
    for k, v in want.items():
        assert v.sharding.spec[0] == "dp"
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(batch[k]), err_msg=k)


def test_yolo_train_on_two_ranks(tmp_path):
    m = YOLO("tinydet.yaml", device="cpu")
    metrics = m.train(data="synthetic", imgsz=32, batch=8, epochs=1, workers=1, max_labels=16,
                      mesh_shape=[2], project=str(tmp_path))
    assert m.trainer is None and {"train/box", "fitness", "metrics/mAP50(B)"} <= set(metrics)
    assert (tmp_path / "detect" / "detect" / "weights" / "best").exists()
    assert (tmp_path / "detect" / "detect" / "results.csv").read_text().count("\n") == 2
    assert not (tmp_path / "detect" / "detect2").exists()  # one run directory for both ranks
    frames = np.random.default_rng(0).integers(0, 256, (2, 32, 48, 3), np.uint8)
    assert np.isfinite(m.predict_batched(frames, imgsz=32, conf=0.01)).all()
    served = YOLO(str(tmp_path / "detect" / "detect" / "weights" / "best"), device="cpu")
    np.testing.assert_array_equal(served.predict_batched(frames, imgsz=32, conf=0.01),
                                  m.predict_batched(frames, imgsz=32, conf=0.01))
