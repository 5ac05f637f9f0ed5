"""Checkpoints, resume and `YOLO(checkpoint)` of the PyTorch port (tinyjde at 64 px, CPU).

`save_checkpoint` / `load_checkpoint` round-trip; `weights/last`, `best` and
`epoch{n}` under `save` and `save_period`; two epochs uninterrupted against one epoch
then `resume` for one, on the device route (synthetic data, mosaic then letterbox)
and on the host route (a dataset folder with the host augmentation): parameters, EMA,
BN statistics, optimizer state (an accumulator left mid-way included) and `cb_counts`
equal exactly; `time` stops the loop; `YOLO(ckpt).predict_batched` equals the trained
object's; a JAX checkpoint written by Orbax, converted by
`tools/torch_port_jax_checkpoint.py`, serves as JAX's `YOLO(ckpt_dir)` does within the
tolerances of `test_predict_batched_matches_jax` (boxes and scores 1e-3, embeddings
1e-3, states 1e-5, classes equal) and resumes with a fresh optimizer.
"""

import json

import numpy as np
import pytest
import torch

from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.engine import trainer as trainer_module
from sar_yolo_tpu_torch.engine.trainer import JDETrainer
from sar_yolo_tpu_torch.utils.checkpoint import is_checkpoint, load_checkpoint, save_checkpoint
from torch_port_common import (convert_jax_checkpoint, one_torch_thread,  # noqa: F401
                               write_jax_checkpoint, write_jde_dataset)

TINY = dict(model="tinyjde.yaml", imgsz=64, batch=8, workers=2, max_labels=8, val=False,
            optimizer="SGD", warmup_epochs=0.0, exist_ok=True)


def _frames(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (2, 72, 128, 3), dtype=np.uint8)


def test_save_and_load_round_trip(tmp_path):
    state = {"model": {"w": torch.randn(3, 2), "n": torch.tensor(4)}, "acc": [torch.ones(2), None],
             "step": 7, "opt": {"lr": 0.5, "nesterov": True}}
    meta = {"epoch": 2, "best_fitness": -float("inf"), "names": {0: "person"}, "path": tmp_path}
    save_checkpoint(tmp_path / "ck", state, meta)
    assert is_checkpoint(tmp_path / "ck") and not is_checkpoint(tmp_path)
    got, gmeta = load_checkpoint(tmp_path / "ck")
    assert torch.equal(got["model"]["w"], state["model"]["w"]) and got["model"]["n"].item() == 4
    assert torch.equal(got["acc"][0], state["acc"][0]) and got["acc"][1] is None
    assert (got["step"], got["opt"]) == (7, state["opt"])
    assert gmeta == {"epoch": 2, "best_fitness": -float("inf"), "names": {"0": "person"},
                     "path": str(tmp_path)}


def _state(tr) -> dict:
    """Everything the next train step reads, on the CPU."""
    opt = tr.optimizer.state_dict()
    return {"model": tr.model.state_dict(), "ema": tr.ema, "cb": tr.cb_counts,
            "momenta": [s["momentum_buffer"] for s in opt["opt"]["state"].values()],
            "acc": opt["acc"], "counters": (opt["micro"], opt["updates"], tr.step),
            "rng": tr.generator.get_state()}


def _assert_equal_states(got, want):
    assert got["counters"] == want["counters"]
    assert got["model"].keys() == want["model"].keys()
    for k, w in want["model"].items():
        assert torch.equal(got["model"][k], w), k
    for name in ("ema", "momenta", "acc"):
        assert len(got[name]) == len(want[name]) > 0
        assert all(torch.equal(a, b) for a, b in zip(got[name], want[name])), name
    assert torch.equal(got["cb"], want["cb"]) and got["cb"].abs().sum() > 0
    assert torch.equal(got["rng"], want["rng"])


@pytest.mark.parametrize("route", ["device", "host"])
def test_resume_equals_the_uninterrupted_run(route, tmp_path):
    """nbs 24 at batch 8: 3 micro-steps an update, so epochs of 8 (synthetic) or 4 (the
    folder) batches end with an update part accumulated."""
    if route == "device":
        kw = dict(data="synthetic", device_augment=True, copy_paste=0.0, mixup=0.5)
    else:
        kw = dict(data=write_jde_dataset(tmp_path / "data", 32, 2), copy_paste=0.5)
    common = dict(TINY, epochs=2, close_mosaic=1, nbs=24, project=str(tmp_path), **kw)
    full = JDETrainer({**common, "name": "full", "save_period": 1}, device="cpu")
    full.train()
    assert full.device_augment == (route == "device") and full.optimizer.micro > 0
    assert not full._mosaic_on and not getattr(full.train_set, "mosaic_enabled", False)
    wdir = tmp_path / "jde" / "full" / "weights"
    assert sorted(p.name for p in wdir.iterdir()) == ["best", "epoch1", "epoch2", "last"]
    meta = json.loads((wdir / "epoch1" / "run_meta.json").read_text())
    assert (meta["epoch"], meta["step"], meta["nc"], meta["task"]) == (0, full.nb, full.meta["nc"],
                                                                      "jde")
    resumed = JDETrainer({**common, "name": "resumed", "resume": str(wdir / "epoch1")}, device="cpu")
    resumed.setup()
    assert resumed.epoch == 1 and resumed.best_fitness == meta["best_fitness"]
    resumed.train()
    _assert_equal_states(_state(resumed), _state(full))
    assert not (tmp_path / "jde" / "resumed" / "weights" / "epoch2").exists()  # save_period -1
    assert is_checkpoint(tmp_path / "jde" / "resumed" / "weights" / "last")


def test_yolo_checkpoint_serves_the_trained_weights_and_time_stops(tmp_path, monkeypatch):
    m = YOLO("tinyjde.yaml", device="cpu")
    m.train(data="synthetic", epochs=3, time=1e-12, project=str(tmp_path), name="t",
            **{k: v for k, v in TINY.items() if k != "model"})
    assert m.trainer.epoch == 0  # the time limit ended the loop after the first epoch
    best = tmp_path / "jde" / "t" / "weights" / "best"
    assert m.ckpt_dir == str(best) and sorted(p.name for p in best.parent.iterdir()) == ["best", "last"]
    served = YOLO(str(best), device="cpu")
    assert served.task == "jde" and served.names == {0: "class0", 1: "class1", 2: "class2"}
    assert served.overrides["time"] == 1e-12 and "model" not in served.overrides
    frames = _frames()
    want = m.predict_batched(frames, imgsz=64, conf=0.001)
    got = served.predict_batched(frames, imgsz=64, conf=0.001)
    assert (want[..., 4] > 0).any()
    np.testing.assert_array_equal(got, want)
    saved = []
    monkeypatch.setattr(trainer_module.JDETrainer, "save_model", lambda self, imp: saved.append(1))
    YOLO("tinyjde.yaml", device="cpu").train(data="synthetic", epochs=1, save=False,
                                            project=str(tmp_path), name="nosave",
                                            **{k: v for k, v in TINY.items() if k != "model"})
    assert not saved and not (tmp_path / "jde" / "nosave" / "weights").exists()


def test_converted_jax_checkpoint_serves_and_resumes(tmp_path):
    payload = write_jax_checkpoint(tmp_path / "jax_ckpt", {"imgsz": 64, "plots": False})
    convert_jax_checkpoint(tmp_path / "jax_ckpt", tmp_path / "port_ckpt")
    frames = _frames(3)
    kw = dict(imgsz=96, conf=0.001, iou=0.7, max_det=50)
    want = np.asarray(JaxYOLO(str(tmp_path / "jax_ckpt")).predict_batched(frames, **kw))
    served = YOLO(str(tmp_path / "port_ckpt"), device="cpu")
    # the train args are kept (`plots` too); the task is recorded, as JAX's YOLO records it
    assert served.overrides == {"imgsz": 64, "plots": False, "task": "jde"}
    got = served.predict_batched(frames, **kw)
    assert got.shape == want.shape
    for b in range(len(frames)):
        g, w = got[b][got[b, :, 4] > 0], want[b][want[b, :, 4] > 0]
        assert len(g) == len(w) > 0
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 6:38], w[:, 6:38], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 38:], w[:, 38:], rtol=0, atol=1e-5)
    warnings = []
    tr = JDETrainer({**TINY, "data": "synthetic", "single_cls": True, "epochs": 6,
                     "resume": str(tmp_path / "port_ckpt"), "project": str(tmp_path)}, device="cpu")
    trainer_module.LOGGER.warning, orig = warnings.append, trainer_module.LOGGER.warning
    try:
        tr.setup()
    finally:
        trainer_module.LOGGER.warning = orig
    assert any("no optimizer state" in w for w in warnings)
    assert (tr.epoch, tr.step, tr.best_fitness, tr.optimizer.updates) == (5, 40, 0.25, 0)
    np.testing.assert_array_equal(tr.cb_counts.numpy(), payload["cb_counts"])
    ema = dict(zip((n for n, _ in tr.model.named_parameters()), tr.ema))
    assert torch.equal(ema["blocks.0.conv.weight"],
                       torch.tensor(payload["ema_params"]["blocks_0"]["conv"]["kernel"]
                                    .transpose(3, 2, 0, 1)))
