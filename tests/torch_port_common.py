"""Shared helpers of the `test_torch_port_*.py` files (the PyTorch port against the JAX package)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_jde_dataset(root, n_train: int, n_val: int, seed: int = 0) -> dict:
    """A YOLO-format JDE dataset of PNG frames (smooth colours, 64x96 and 96x64) with
    1-6 persons a frame in 6-column labels under `root`; returns its dataset dict."""
    import cv2
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = (64, 96) if i % 3 else (96, 64)
            small = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
            cv2.imwrite(str(root / "images" / split / f"{i:03d}.png"),
                        cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR))
            rows = [f"0 {rng.uniform(.2, .8):.6f} {rng.uniform(.2, .8):.6f} "
                    f"{rng.uniform(.08, .3):.6f} {rng.uniform(.08, .3):.6f} {rng.integers(0, 9)}"
                    for _ in range(int(rng.integers(1, 7)))]
            (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return {"path": str(root), "train": "images/train", "val": "images/val", "names": {0: "person"}}


def jax_and_port_yolo(cfg: str, seed: int, bias_init: bool = False, cls_gain: float = 1.0,
                      box_gain: float = 1.0, calibrate: int | None = None):
    """JAX and port YOLO objects (the port's on the CPU) of `cfg` with the same
    numpy-filled weights; `bias_init`: the head's class bias init (scores near 0.01);
    `cls_gain`, `box_gain`: the class and box logits' last convolutions scaled, so that
    scores spread and boxes stay near their anchors. `calibrate`: every BN's statistics
    set to those of 4 seeded random images of that side (one train-mode forward of the
    port with momentum 1), in both packages; without it a deep model's activations
    fade through the depth and its outputs hardly depend on the image."""
    import jax
    import jax.numpy as jnp

    from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
    from sar_yolo_tpu.nn.tasks import bias_init_head, infer_strides
    from sar_yolo_tpu_torch import YOLO
    jyolo = JaxYOLO(cfg)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jyolo.model.init(jax.random.PRNGKey(0), x, train=False))
    jyolo.meta["strides"] = infer_strides(jyolo.model, jyolo.meta)
    variables = fill_variables(shapes, np.random.default_rng(seed))
    if bias_init:
        variables = jax.device_get(bias_init_head(variables, jyolo.meta))
    head = variables["params"][max(variables["params"], key=lambda k: int(k.split("_")[1]))]
    for name, sub in head.items():
        if name.startswith("cv3_") and name.endswith("_pred"):
            sub["kernel"] = sub["kernel"] * np.float32(cls_gain)
        if name.startswith("cv2_") and name.endswith("_pred"):
            sub["kernel"] = sub["kernel"] * np.float32(box_gain)
    jyolo.variables = variables
    pyolo = YOLO(cfg, device="cpu")
    pyolo.load_jax_variables(variables)
    if calibrate:
        _calibrate_bn(variables, pyolo, calibrate)
    return jyolo, pyolo


def _calibrate_bn(variables, pyolo, imgsz: int):
    """BN statistics of 4 seeded random images (`chip_smoke.calibrate_bn` on the port),
    written into the port and into `variables["batch_stats"]` in place."""
    from chip_smoke import calibrate_bn
    from sar_yolo_tpu_torch.utils.convert import _flatten, _module_path
    model = pyolo.model
    calibrate_bn(model, torch.rand(4, 3, imgsz, imgsz, generator=torch.Generator().manual_seed(0)))
    state = model.state_dict()
    for (*scope, leaf), _ in list(_flatten(variables["batch_stats"])):
        node = variables["batch_stats"]
        for key in scope:
            node = node[key]
        node[leaf] = state[f"{_module_path(tuple(scope))}.running_{leaf}"].numpy().copy()
    pyolo._fused = None


def write_jax_checkpoint(path, train_args: dict) -> dict:
    """A JAX tinyjde checkpoint at `path` (`save_model`'s payload and metadata; numpy-filled
    weights with the head's bias init, so that the class scores spread and few rows pass
    NMS); returns its payload."""
    import jax
    import jax.numpy as jnp

    from sar_yolo_tpu.nn.tasks import bias_init_head, build_model, infer_strides
    from sar_yolo_tpu.utils.checkpoint import save_checkpoint
    model, meta = build_model("tinyjde.yaml")
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    meta["strides"] = infer_strides(model, meta)
    variables = jax.device_get(bias_init_head(fill_variables(shapes, np.random.default_rng(5)), meta))
    ema = jax.device_get(bias_init_head(fill_variables(shapes, np.random.default_rng(6)), meta))["params"]
    payload = {"params": variables["params"], "ema_params": ema,
               "batch_stats": variables["batch_stats"],
               "cb_counts": np.arange(6, dtype=np.float32), "opt_state": {}}
    metadata = {"epoch": 4, "best_fitness": 0.25, "train_args": {"model": "tinyjde.yaml", **train_args},
                "model_yaml": meta["yaml"], "task": "jde", "nc": 1,
                "strides": meta["strides"], "step": 40}
    save_checkpoint(path, payload, metadata)
    return payload


def convert_jax_checkpoint(src, dst):
    """`tools/torch_port_jax_checkpoint.py`'s `convert`."""
    import importlib.util
    from pathlib import Path
    tool = Path(__file__).resolve().parents[1] / "tools" / "torch_port_jax_checkpoint.py"
    spec = importlib.util.spec_from_file_location("torch_port_jax_checkpoint", tool)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.convert(src, dst)


def close_to_max(got, want, what=""):
    """|got - want| <= 1e-4 of want's largest magnitude (the tolerance of gradients and parameters)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30), err_msg=what)


def jax_jde_trainer(overrides: dict, seed: int, monkeypatch, task: str = "jde"):
    """The JAX package's JDETrainer (DetectionTrainer, PoseTrainer, SegmentTrainer,
    OBBTrainer or ClassificationTrainer for task 'detect', 'pose', 'segment', 'obb' or
    'classify') after
    `_setup_train`, its weights from `fill_variables` and the head's bias init
    (so that the class term does not swamp the others).

    The real init (about 20 s for yolov13n-JDE on this CPU) is swapped for
    `jax.eval_shape` + `fill_variables`, and Flax's Dropout for the identity:
    no RNG stream of the port can reproduce JAX's masks.
    """
    import flax.linen
    import jax
    import jax.numpy as jnp

    from sar_yolo_tpu.engine import trainer as jax_trainer_module
    from sar_yolo_tpu.nn.tasks import bias_init_head, infer_strides

    def init_model(model, meta, rng, imgsz=640):
        x = jnp.zeros((1, imgsz, imgsz, 3), jnp.float32)
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
        meta["strides"] = infer_strides(model, meta)
        variables = fill_variables(shapes, np.random.default_rng(seed))
        return jax.device_get(bias_init_head(variables, meta))

    monkeypatch.setattr(jax_trainer_module, "init_model", init_model)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    cls = {"jde": jax_trainer_module.JDETrainer, "detect": jax_trainer_module.DetectionTrainer,
           "pose": jax_trainer_module.PoseTrainer,
           "segment": jax_trainer_module.SegmentTrainer, "obb": jax_trainer_module.OBBTrainer,
           "classify": jax_trainer_module.ClassificationTrainer}[task]
    trainer = cls(overrides=overrides)
    trainer._setup_train()
    return trainer


def port_trainer_like(jtr, overrides: dict):
    """The port's trainer of the JAX trainer's task on the CPU with its weights, dropout off."""
    import jax

    from sar_yolo_tpu_torch.engine.trainer import TRAINERS
    from sar_yolo_tpu_torch.nn.modules.conv import Dropout
    from sar_yolo_tpu_torch.utils.convert import from_jax_variables

    variables = jax.device_get({"params": jtr.state.params, "batch_stats": jtr.state.batch_stats})
    ptr = TRAINERS[jtr.task](overrides, device="cpu")
    ptr.setup(state_dict=from_jax_variables(variables))
    for m in ptr.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return ptr


def assert_trajectories_match(jtr, ptr, steps: int = 10, param_tol: float = 1e-4):
    """`steps` train steps of both trainers on the JAX loader's batches.

    Tolerances. Step 1 (same weights, same batch): every loss item within 1e-5
    relative (detect, pose, segment, and JDE's but one), the JDE triplet item within 1e-5 absolute per unit of its gain (it
    is a difference of distances on the unit sphere, which are of order 1).
    Later steps: every item within 1e-2 relative, because float32 rounding
    (about 1e-7) drifts through the steps and the assigner's top-k and the
    triplet miner's hardest / semi-hard picks turn it into jumps. The
    class-balanced counts at every step within 1e-5 relative. After the last
    step the BN statistics, the parameters and the EMA within `param_tol` of
    each tensor's largest magnitude, and at least a third of the tensors moved
    by more than that.
    """
    import jax

    from sar_yolo_tpu.parallel import shard_batch
    from sar_yolo_tpu_torch.utils.convert import from_jax_variables

    start = {k: v.clone() for k, v in ptr.model.state_dict().items()}
    state = jtr.state
    jtr.train_loader.set_epoch(0)
    for i, batch in zip(range(steps), jtr.train_loader):
        state, _, jitems = jtr._train_step(state, shard_batch(jtr.mesh, batch), jtr._mosaic_on)
        _, pitems = ptr.train_step(batch)
        got, want = pitems.numpy(), np.asarray(jitems)
        if i == 0 and ptr.task != "jde":  # detect, pose, segment: no triplet item
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg="loss items, step 1")
        elif i == 0:
            np.testing.assert_allclose(got[[0, 1, 2, 4]], want[[0, 1, 2, 4]], rtol=1e-5,
                                       err_msg="loss items, step 1")
            np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5 * ptr.args.clr,
                                       err_msg="triplet item, step 1")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-2, err_msg=f"loss items, step {i + 1}")
        np.testing.assert_allclose(ptr.cb_counts.numpy(), np.asarray(state.cb_counts), rtol=1e-5,
                                   atol=1e-9, err_msg=f"cb_counts, step {i + 1}")
    assert ptr.step == steps == int(state.step)
    want = from_jax_variables(jax.device_get({"params": state.params,
                                              "batch_stats": state.batch_stats}))
    got = ptr.model.state_dict()
    moved = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        tol = param_tol * w.abs().max().item()
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0, atol=tol, err_msg=key)
        moved += int((got[key] - start[key]).abs().max() > tol)
    assert moved > len(want) // 3, f"only {moved} tensors moved"
    ema = from_jax_variables(jax.device_get({"params": state.ema_params}))
    for (name, _), e in zip(ptr.model.named_parameters(), ptr.ema):
        w = ema[name]
        np.testing.assert_allclose(e.numpy(), w.numpy(), rtol=0,
                                   atol=param_tol * w.abs().max().item(), err_msg=f"ema {name}")


def fill_variables(tree, rng):
    """Numpy values for every leaf of a JAX variables tree of ShapeDtypeStructs.

    Every parameter and BN statistic moves away from its init value (the
    FullPAD gate and the A2C2f gamma included), so no branch hides behind a
    zero or an identity.
    """
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out[key] = fill_variables(val, rng)
            continue
        shape = tuple(val.shape)
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)  # the JAX conv init's range
        elif key in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif key == "gate":
            a = rng.uniform(0.5, 1.0, shape)
        elif key == "prototype_base":
            a = rng.standard_normal(shape) * np.sqrt(2.0 / sum(shape))
        else:  # bias, mean, gamma
            a = rng.normal(0.0, 0.1, shape)
        out[key] = a.astype(np.float32)
    return out
