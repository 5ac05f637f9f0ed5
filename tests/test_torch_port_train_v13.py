"""The JDE train step of the PyTorch port against the JAX package on yolov13n-JDE.

At imgsz 64, batch 2, from the same `fill_variables` weights, on the JAX
loader's batches. yolov13n-JDE is the model whose A2C2f area attention,
HyperACE, FullPAD and DSC3k2 blocks tinyjde lacks, so these two tests are the
check of their backward.

`test_yolov13n_first_step_gradient_matches_jax`: the whole first-step gradient
of a float64 copy of the port against JAX's float32 gradient on the same batch.
The port runs in float64 because at this size few anchors are foreground and
the state loss's gradient runs through a ReLU in the state MLP at those
anchors: a pre-activation within float32 rounding of zero sends a float32
gradient through one side of the kink or the other, and two float32
gradients part by percents. Float64 lands on the side of the exact
computation. Tolerances: the whole gradient within 1e-3 relative L2 (it lies
1.6e-4 away); each tensor within 1e-4 of its largest magnitude or 4 times
the spread of JAX's own gradient when its weights are perturbed by 1e-7
relative (3 draws), whichever is larger. The spread decides for the tensors
whose gradient is near zero and made of rounding: the biases of the BNs that
feed the A2C2f residual sums, where JAX's gradient moves by more than its own
size under the perturbation.

`test_yolov13n_ten_steps_match_jax`: 10 SGD steps. Before each step the port
takes the JAX trainer's parameters; it carries its own BN statistics, EMA,
momentum buffers and class-balanced counts through the 10 steps. The
parameters are handed over because a free-running float32 trajectory crosses
the kinks above; the learning rate is 1e-4, where the last update's
difference stays inside the parameter tolerance. At that rate the 10 updates
move only a fifth of the parameter tensors (116 of 508) by more than the
tolerance, so this test holds the BN statistics, the EMA, the counts and the
optimizer's bookkeeping; the gradient test above holds the gradients.
Tolerances: loss items 1e-4 relative (the triplet item 1e-5 absolute per unit
of its gain); class-balanced counts 1e-5 relative; after the last step the BN
running statistics, the EMA and the parameters within 1e-4 of each tensor's
largest magnitude.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.parallel import shard_batch
from sar_yolo_tpu.utils.loss import jde_loss
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import jax_jde_trainer, one_torch_thread, port_trainer_like  # noqa: F401

COMMON = dict(model="yolov13n-JDE.yaml", data="synthetic", imgsz=64, batch=2, nbs=2, workers=1,
              max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0, lr0=1e-4)


@pytest.fixture(scope="module")
def jtr(tmp_path_factory):
    """The JAX trainer, built once for the file (its real init and compile dominate)."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield jax_jde_trainer({**COMMON, "mesh_shape": [1], "plots": False, "val": False,
                               "save": False, "project": str(tmp_path_factory.mktemp("runs"))},
                              seed=11, monkeypatch=monkeypatch)


def _close_to_max(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * want.abs().max().item(), err_msg=what)


def test_yolov13n_first_step_gradient_matches_jax(jtr):
    jtr.train_loader.set_epoch(0)
    batch = next(iter(jtr.train_loader))
    meta, batch_stats = jtr.meta, jtr.state.batch_stats
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        feats, _ = jtr.model.apply({"params": params, "batch_stats": batch_stats},
                                   jb["img"].astype(jnp.float32) / 255.0, train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jde_loss(feats, jb, jtr.args, nc=meta["nc"], reg_max=meta["reg_max"],
                        strides=tuple(meta["strides"]), embed_dim=meta["embed_dim"],
                        state_classes=meta["state_classes"],
                        cb_counts=jnp.zeros(meta["state_classes"])).total

    grad = jax.jit(jax.grad(loss))
    params = jax.device_get(jtr.state.params)
    want = from_jax_variables({"params": jax.device_get(grad(params))})
    rng = np.random.default_rng(0)
    perturbed = [from_jax_variables({"params": jax.device_get(grad(jax.tree.map(
        lambda p: (p * (1 + 1e-7 * rng.standard_normal(p.shape))).astype(np.float32), params)))})
        for _ in range(3)]

    ptr = port_trainer_like(jtr, COMMON)
    model = copy.deepcopy(ptr.model).double()
    b = ptr.to_device(batch)
    ptr.loss(model(b["img"].double()), b)[0].backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()

    def flat(g):
        return torch.cat([g[n].double().flatten() for n in got])

    rel_l2 = ((flat(got) - flat(want)).norm() / flat(want).norm()).item()
    assert rel_l2 < 1e-3, f"gradient {rel_l2:.3g} from JAX's (relative L2)"
    for name, w in want.items():
        w = w.double()
        spread = max((q[name].double() - w).abs().max().item() for q in perturbed)
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=max(1e-4 * w.abs().max().item(), 4 * spread),
                                   err_msg=f"gradient of {name}")


def test_yolov13n_ten_steps_match_jax(jtr):
    ptr = port_trainer_like(jtr, COMMON)
    start = {k: v.clone() for k, v in ptr.model.state_dict().items()}
    state = jtr.state
    jtr.train_loader.set_epoch(0)
    for i, batch in zip(range(10), jtr.train_loader):
        params = from_jax_variables({"params": jax.device_get(state.params)})
        ptr.model.load_state_dict(params, strict=False)
        state, _, jitems = jtr._train_step(state, shard_batch(jtr.mesh, batch), jtr._mosaic_on)
        _, pitems = ptr.train_step(batch)
        got, want = pitems.numpy(), np.asarray(jitems)
        np.testing.assert_allclose(got[[0, 1, 2, 4]], want[[0, 1, 2, 4]], rtol=1e-4,
                                   err_msg=f"loss items, step {i + 1}")
        np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5 * ptr.args.clr,
                                   err_msg=f"triplet item, step {i + 1}")
        np.testing.assert_allclose(ptr.cb_counts.numpy(), np.asarray(state.cb_counts), rtol=1e-5,
                                   atol=1e-9, err_msg=f"cb_counts, step {i + 1}")
    assert ptr.step == 10 == int(state.step)
    assert (want > 1e-5).all()  # every term live at the last step
    want = from_jax_variables(jax.device_get({"params": state.params,
                                              "batch_stats": state.batch_stats}))
    got = ptr.model.state_dict()
    for key, w in want.items():
        if not key.endswith("num_batches_tracked"):
            _close_to_max(got[key], w, key)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    moved = [k for k in stats if (got[k] - start[k]).abs().max() > 1e-2 * want[k].abs().max()]
    assert len(moved) > len(stats) // 2  # the statistics moved well beyond the tolerance
    names = [n for n, _ in ptr.model.named_parameters()]
    moved = [k for k in names if (got[k] - start[k]).abs().max() > 1e-4 * want[k].abs().max()]
    assert len(moved) > len(names) // 5, f"{len(moved)} of {len(names)} parameters moved"
    ema = from_jax_variables(jax.device_get({"params": state.ema_params}))
    for (name, _), e in zip(ptr.model.named_parameters(), ptr.ema):
        _close_to_max(e, ema[name], f"ema {name}")
