"""Detect, JDE, pose, segment, OBB and classify training on one device (port of
`sar_yolo_tpu/engine/trainer.py`).

`BaseTrainer` holds the loop; `DetectionTrainer` (the v8 loss: box, cls, dfl),
`JDETrainer` (box, cls, dfl, the triplet embedding term and the class-balanced state
term), `PoseTrainer` (box, pose, kobj, cls, dfl), `SegmentTrainer` (box, seg, cls,
dfl), `OBBTrainer` (box, cls, dfl of the rotated loss), `ClassificationTrainer`
(cross-entropy) and `RTDETRTrainer` (the Hungarian-matched DETR loss: cls, bbox, giou, with
contrastive-denoising queries) give it the task's loss and validator. A YOLO-World model
trains as a detect model (its text rows are a parameter). Data: a YOLO-format dataset (a
dataset YAML file or dict; 5-column detect labels, 6-column JDE labels with the track id,
keypoint or polygon rows), a class-folder tree (classify) or the synthetic set (OBB trains
on it alone, as in the JAX package). A pose model takes its dataset's
`kpt_shape` (as Ultralytics rebuilds the head; the JAX package leaves the model's and
fails where they differ). Where the hyperparameters allow it
(`_device_augment_enabled`: detect, JDE or pose; no rotation, shear, perspective,
copy-paste or mosaic9), the host only letterboxes and
the train step augments the uint8 batch on the device (`data/device_augment.py`),
with draws keyed by (seed, epoch, batch index); otherwise the host augments
(`data/augment.py`). Mosaic is off for the last `close_mosaic` epochs on either route.

The JAX package's optax chain, `MultiSteps(chain(clip_by_global_norm(10),
multi_transform({decay, nodecay, bias})), every_k=accumulate)`, becomes a
`torch.optim` SGD (nesterov, momentum warmup) or AdamW over three param
groups whose lr and momentum are set before each update. Gradients of
`accumulate` micro-steps are averaged first, then clipped; the schedules count
updates. The EMA covers parameters only and ticks every micro-step; BN
statistics live in the model. The forward runs in train mode, so the A2C2f
attention runs through the CUDA kernel on the card.

With `val` (the default) each epoch ends in a validation of the EMA weights on a
separate eval copy of the model, and the validator's fitness (0.1 mAP50 + 0.9
mAP50-95) decides the best epoch and the patience; -sum(mean loss items) is the
fitness only without validation. Each epoch appends a row to `results.csv` in
the run's save dir and, with `save`, writes the checkpoints `weights/last`,
`weights/best` on improvement and `weights/epoch{n}` every `save_period` epochs
(`utils/checkpoint.py`); `resume` continues a run from one, exactly where the
uninterrupted run would be (the dropout stream included).

Precision is the JAX package's rule: bf16 compute over float32 parameters exactly
when `amp` (the default) or `half` is on and the model's device is CUDA
(`amp_dtype`), after `check_bf16` confirms the bf16 forward tracks the float32 one
(otherwise a warning and float32). The images enter the model in its compute dtype;
the loss, the optimizer, the EMA and the checkpoints stay float32. `remat` checkpoints
every block but the head; `multi_scale` resizes each batch to a random stride
multiple in [0.5, 1.5] x imgsz on the host before the step (either route);
`profile='trace'` writes a torch.profiler trace of steps 1-3 of epoch 0 to
`save_dir/trace`.

With `plots` (the default), epoch 0's first batch is drawn into train_batch0.png as the
loader gives it (before `multi_scale` and the device augmentation; only 4-column boxes:
not OBB or classify), the dataset's labels into labels.jpg and labels_correlogram.jpg, and
after the last epoch results.csv into results.png (`utils/plotting.py`); a plotting error is
logged, never raised.

`mesh_shape=[W]` trains on W devices, one process each (`parallel/`): under torchrun (its
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT), in a process group made already, or
through `YOLO.train`, which spawns the W ranks (`train_rank`). `batch` stays the global
batch (a batch that does not split over W raises). Each rank loads its `batch / W` rows of
every global batch; the model is wrapped in DistributedDataParallel; train-mode BN takes the
global batch's statistics; the head outputs and the labels are gathered with autograd and
every rank computes the loss of the global batch, so the step is the single process's
step (the triplet miner, the assigner's normalization and the class-balanced counts
included); the device augmentation's and dropout's draws are the global batch's, sliced.
Rank 0 alone validates, plots (its rows of the first batch), writes checkpoints,
results.csv and runs the callbacks; the stop
decision (patience, `time`) is all-reduced. A `tp` axis (`[dp, tp]`, tp > 1) raises.
"""

from __future__ import annotations

import copy
import math
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sar_yolo_tpu_torch.cfg.default import get_cfg, get_save_dir
from sar_yolo_tpu_torch.data.build import DataLoader
from sar_yolo_tpu_torch.data.cv import resize, resize_nearest_cv
from sar_yolo_tpu_torch.data.dataset import (ClassificationDataset, SyntheticDataset, YOLODataset,
                                             check_det_dataset)
from sar_yolo_tpu_torch.data.device_augment import AUG_KEYS, device_train_augment, draw_params
from sar_yolo_tpu_torch.engine.validator import (ClassificationValidator, DetectionValidator,
                                                 JDEValidator, OBBValidator, PoseValidator,
                                                 RTDETRValidator, SegmentValidator)
from sar_yolo_tpu_torch.nn.modules.conv import set_compute_dtype, set_generator
from sar_yolo_tpu_torch.nn.modules.transformer import draw_cdn
from sar_yolo_tpu_torch.nn.tasks import build_model, init_weights
from sar_yolo_tpu_torch.parallel import mesh as parallel
from sar_yolo_tpu_torch.utils import LOGGER, select_device
from sar_yolo_tpu_torch.utils.callbacks import HasCallbacks
from sar_yolo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sar_yolo_tpu_torch.utils.checks import check_bf16
from sar_yolo_tpu_torch.utils.detr_loss import detr_loss
from sar_yolo_tpu_torch.utils.loss import (classification_loss, detection_loss, jde_loss, obb_loss,
                                           pose_loss, segmentation_loss)
from sar_yolo_tpu_torch.utils.plotting import plot_images, plot_labels, plot_results

CLIP_NORM = 10.0
ADAM_ALIASES = ("Adam", "AdamW", "NAdam", "RAdam")  # all optax.adamw in the JAX package


def amp_dtype(args, device: torch.device) -> torch.dtype:
    """The train compute dtype: bf16 where `half` or `amp` is on and the device is CUDA
    (the JAX package's bf16 on its accelerator), float32 elsewhere."""
    return torch.bfloat16 if (args.half or args.amp) and device.type == "cuda" else torch.float32


def build_lr_schedule(args, nb: int, lr0: float, warm_start: float = 0.0):
    """lr at an update count: linear or cosine decay per epoch of nb updates, after a
    linear warmup from `warm_start` over max(round(warmup_epochs * nb), 100) updates."""
    nw = max(round(args.warmup_epochs * nb), 100) if args.warmup_epochs > 0 else 0
    lrf, epochs = args.lrf, max(args.epochs, 1)

    def schedule(step: int) -> float:
        epoch_floor = math.floor(step / nb)
        if args.cos_lr:
            base = lrf + 0.5 * (1 - lrf) * (1 + math.cos(math.pi * min(epoch_floor, epochs) / epochs))
        else:
            base = max(1 - epoch_floor / epochs, 0) * (1.0 - lrf) + lrf
        base = lr0 * base
        if step < nw:
            return warm_start + (base - warm_start) * min(max(step / nw, 0.0), 1.0)
        return base

    return schedule


def group_label(name: str, p: torch.Tensor) -> str:
    """The JAX package's three groups by leaf name: conv and dense weights (Flax
    `kernel`) decay; every bias is 'bias'; BN scales, the FullPAD gate, the A2C2f
    gamma and the hyperedge prototypes are 'nodecay'."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "bias"
    if leaf == "weight" and p.ndim > 1:
        return "decay"
    return "nodecay"


class RMSProp(torch.optim.Optimizer):
    """optax's `chain(add_decayed_weights(wd), rmsprop(lr, momentum=m))` per group:
    g' = g + wd p; nu = 0.1 g'^2 + 0.9 nu (nu starts at 0); u = -lr g' / sqrt(nu + 1e-8);
    t = u + m t; p = p + t. torch.optim.RMSprop differs on every point (alpha 0.99, eps
    outside the root, momentum before the learning rate)."""

    DECAY, EPS = 0.9, 1e-8  # optax.rmsprop's defaults

    def __init__(self, params, momentum: float):
        super().__init__(params, dict(lr=0.0, momentum=momentum, weight_decay=0.0))

    @torch.no_grad()
    def step(self):
        d = self.DECAY
        for group in self.param_groups:
            lr, m, wd = group["lr"], group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"], state["trace"] = torch.zeros_like(p), torch.zeros_like(p)
                g = p.grad + wd * p if wd else p.grad
                nu = state["nu"].copy_((1 - d) * g.square() + d * state["nu"])
                u = torch.rsqrt(nu + self.EPS) * g * (-lr)
                t = state["trace"].copy_(u + m * state["trace"])
                p.add_(t)


class Optimizer:
    """Global-norm clip, then SGD, AdamW (also for Adam, NAdam and RAdam, which the JAX
    package maps to optax.adamw) or optax's RMSProp over the decay / nodecay / bias
    groups, one update per `accumulate` micro-steps (call `step` after every backward).

    `schedules` are the lr schedules of groups pg0 (decay), pg1 (nodecay), pg2 (bias).
    """

    def __init__(self, args, nb: int, nc: int, model: torch.nn.Module):
        name, lr0, momentum = args.optimizer, args.lr0, args.momentum
        if name == "auto":
            lr_fit = round(0.002 * 5 / (4 + nc), 6)
            name, lr0, momentum = ("SGD", 0.01, 0.9) if args.epochs * nb > 10000 else \
                ("AdamW", lr_fit, 0.9)
        self.accumulate = accumulate = max(round(args.nbs / args.batch), 1)
        wd = args.weight_decay * args.batch * accumulate / args.nbs
        nb_upd = max(nb // accumulate, 1)
        base = build_lr_schedule(args, nb_upd, lr0)
        self.schedules = (base, base, build_lr_schedule(args, nb_upd, lr0,
                                                        warm_start=args.warmup_bias_lr))
        nw = max(round(args.warmup_epochs * nb_upd), max(round(100 / accumulate), 1)) \
            if args.warmup_epochs > 0 else 0
        wm = args.warmup_momentum
        self.momentum = (lambda u: momentum) if nw == 0 else \
            (lambda u: wm + (momentum - wm) * min(max(u / nw, 0.0), 1.0))

        groups = {"decay": [], "nodecay": [], "bias": []}
        for pname, p in model.named_parameters():
            groups[group_label(pname, p)].append(p)
        spec = [{"params": groups["decay"], "weight_decay": wd},
                {"params": groups["nodecay"], "weight_decay": 0.0},
                {"params": groups["bias"], "weight_decay": 0.0}]
        if name == "SGD":
            self.opt = torch.optim.SGD(spec, lr=0.0, momentum=momentum, nesterov=True)
        elif name in ADAM_ALIASES:
            self.opt = torch.optim.AdamW(spec, lr=0.0, betas=(momentum, 0.999), eps=1e-8)
        elif name == "RMSProp":
            self.opt = RMSProp(spec, momentum=momentum)
        else:
            raise NotImplementedError(f"optimizer '{name}' is not part of this port yet")
        self.name = name
        self.params = [p for g in spec for p in g["params"]]
        self.acc = [torch.zeros_like(p) for p in self.params] if accumulate > 1 else None
        self.micro = 0    # micro-steps since the last update
        self.updates = 0  # updates so far: the schedules' count
        LOGGER.info(f"optimizer: {self.name}(lr={lr0}, momentum={momentum}) wd={wd:.5f} "
                    f"accumulate={accumulate} groups=(decay, nodecay, bias@{args.warmup_bias_lr})")

    def state_dict(self) -> dict:
        """The torch optimizer's state, the counters and the gradient accumulator."""
        return {"opt": self.opt.state_dict(), "micro": self.micro, "updates": self.updates,
                "acc": self.acc}

    def load_state_dict(self, state: dict):
        self.opt.load_state_dict(state["opt"])
        self.micro, self.updates = int(state["micro"]), int(state["updates"])
        if state["acc"] is not None:
            self.acc = [a.to(p.device) for a, p in zip(state["acc"], self.params)]

    @torch.no_grad()
    def step(self) -> bool:
        """Consume the parameters' gradients; returns True where the parameters moved."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.acc is not None:  # running mean of the micro-step gradients
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.micro + 1))
            torch._foreach_add_(self.acc, delta)
            self.micro = (self.micro + 1) % self.accumulate
            if self.micro:
                return False
            grads = self.acc
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        clip = norm >= CLIP_NORM  # optax: g / |g| * 10, no epsilon
        torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clip, CLIP_NORM, 1.0))
        for p, g in zip(self.params, grads):
            p.grad = g
        u = self.updates
        for group, schedule in zip(self.opt.param_groups, self.schedules):
            group["lr"] = schedule(u)
            if self.name == "SGD":
                group["momentum"] = self.momentum(u)
        self.opt.step()
        self.updates += 1
        if self.acc is not None:
            self.acc = [torch.zeros_like(p) for p in self.params]
        return True


def _explicit_on(v) -> bool:
    """True only for an explicit opt-in spelling ('auto' and None are not on)."""
    return v in (True, "True", "true", "on", 1)


class BaseTrainer(HasCallbacks):
    """Trains a model of the subclass's `task` on one device; a subclass gives the task,
    its `loss_names`, its `validator_cls` and its `loss`.

    Callbacks (`add_callback(event, f)`; `f(trainer)`) run at the JAX trainer's points:
    on_pretrain_routine_start / _end around `setup`, on_train_start, then per epoch
    on_train_epoch_start, on_train_batch_start / _end around each step,
    on_train_epoch_end (the epoch's losses in `tloss`, `metrics` still the last
    epoch's), on_fit_epoch_end (after the validation and the checkpoints: `metrics`,
    `fitness`), and on_train_end; on_model_save after each `save_model`."""

    task: str
    loss_names: tuple
    validator_cls: type

    def __init__(self, overrides: dict | None = None, device=None):
        self.args = get_cfg(overrides)
        self.args.task = self.task  # recorded in the checkpoints' train args
        self.device = select_device(device)
        self.rank, self.world, self.ddp = 0, 1, None
        if self.args.mesh_shape:
            self._join_mesh(parallel.mesh_devices_count(self.args.mesh_shape))
        self.save_dir = get_save_dir(self.args, self.task)
        if self.world > 1:  # rank 0's run directory on every rank
            obj = [str(self.save_dir)]
            dist.broadcast_object_list(obj, 0)
            self.save_dir = Path(obj[0])
        self.args.save_dir = str(self.save_dir)  # the validator writes there too
        self.wdir = self.save_dir / "weights"
        self.csv = self.save_dir / "results.csv"
        self.model = self.eval_model = None
        self.validator = self.validator_cls()
        self.metrics, self.fitness, self.best_fitness = {}, None, -math.inf
        self.epoch = 0
        self.tloss = None  # the current epoch's mean loss items, from on_train_epoch_end
        self.init_callbacks()

    def _join_mesh(self, n: int):
        """Join the process group of a `mesh_shape=[n]` run (torchrun's environment, or the
        group made already) and take this rank's device (cuda:LOCAL_RANK for a bare 'cuda')."""
        if n > 1 and not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
            raise ValueError(f"mesh_shape {list(self.args.mesh_shape)}: train through "
                             "YOLO.train, which starts the ranks, or under torchrun "
                             f"--nproc_per_node {n}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.rank, self.world = parallel.init_distributed(self.device)
        if self.world != n:
            raise ValueError(f"mesh_shape {list(self.args.mesh_shape)} in a process group of "
                             f"{self.world} ranks")
        if self.args.batch % n:
            raise ValueError(f"batch {self.args.batch} does not split over the {n} ranks of "
                             f"mesh_shape {list(self.args.mesh_shape)}")

    def wrap_ddp(self):
        """Wrap the model in DistributedDataParallel (again after its parameters change
        dtype: DDP's gradient buckets take the dtype they find)."""
        # the train graph is the same every step (static shapes, no branch on the data or the
        # step), so DDP learns in the first step which parameters get no gradient (YOLO-World
        # v1's ImagePoolingAttn) instead of walking the autograd graph in every step
        self.ddp = torch.nn.parallel.DistributedDataParallel(
            self.model, device_ids=[self.device.index] if self.device.type == "cuda" else None,
            broadcast_buffers=False, static_graph=True)

    def run_callbacks(self, event: str):
        if self.rank == 0:  # rank 0 alone runs them under data parallelism
            super().run_callbacks(event)

    def loss(self, feats, batch: dict):
        """(total, items, new cb_counts) of the head maps on a device batch."""
        raise NotImplementedError

    def get_dataset(self):
        """(train set, val set, info) for args.data: a dataset YAML file or dict, or the
        synthetic sets (None or 'synthetic'; 5 keypoints a pose instance, as the JAX
        package's). Synthetic data trains un-augmented unless `device_augment=True`."""
        data, args = self.args.data, self.args
        if data is None or str(data).startswith("synthetic"):
            nc = 3
            kw = dict(imgsz=args.imgsz, nc=nc, max_labels=args.max_labels, task=self.task,
                      kpt_shape=(5, 3))
            train = SyntheticDataset(n=max(64, int(args.batch or 16)), **kw)
            train.device_augment = _explicit_on(args.device_augment) and \
                self._device_augment_enabled()
            val = SyntheticDataset(n=16, seed=1, **kw)
            return train, val, {"nc": nc, "names": {i: f"class{i}" for i in range(nc)},
                                "kpt_shape": (5, 3)}
        info = check_det_dataset(data)
        kw = dict(imgsz=args.imgsz, hyp=args, use_tags=self.task == "jde",
                  max_labels=args.max_labels, single_cls=args.single_cls, task=self.task,
                  kpt_shape=tuple(info.get("kpt_shape", (17, 3))), flip_idx=info.get("flip_idx"))
        train = YOLODataset(info["train"], augment=True, fraction=args.fraction, cache=args.cache,
                            device_augment=self._device_augment_enabled(), **kw)
        val = YOLODataset(info.get("val") or info["train"], augment=False, **kw)
        return train, val, info

    def _device_augment_enabled(self) -> bool:
        """Whether the train step augments on the device (the JAX package's
        `_device_augment_enabled`): unless device_augment is off, whenever the task is
        detect, JDE or pose and the hyperparameters are expressible there (no
        rotation, shear, perspective, copy-paste or mosaic9; mosaic probability 0 or 1).
        Asked for where they are not, it warns and the host augments."""
        v = self.args.device_augment
        if v in (False, "False", "false", "off", 0):
            return False
        g = lambda k: float(getattr(self.args, k) or 0)  # noqa: E731
        expressible = (self.task in ("detect", "jde", "pose") and g("degrees") == 0
                       and g("shear") == 0 and g("perspective") == 0 and g("copy_paste") == 0 and g("mosaic9") == 0
                       and g("mosaic") in (0.0, 1.0))
        if _explicit_on(v) and not expressible:
            LOGGER.warning("device_augment=True but the hyperparameters need the host "
                           "(degrees/shear/perspective/copy_paste/mosaic9/fractional mosaic "
                           "or a task without plain boxes); using host augmentation")
        return expressible

    def setup(self, state_dict: dict | None = None):
        """Data, model, optimizer and EMA; then `resume`'s checkpoint, if any. `state_dict`
        replaces the seeded initialization."""
        self.run_callbacks("on_pretrain_routine_start")
        args = self.args
        self.train_set, self.val_set, self.data = self.get_dataset()
        nc = 1 if args.single_cls else self.data["nc"]
        dtype = amp_dtype(args, self.device)
        kpt_shape = tuple(self.data.get("kpt_shape", (17, 3))) if self.task == "pose" else None
        model, self.meta = build_model(args.model, nc=nc, dtype=dtype, kpt_shape=kpt_shape,
                                       dropout=float(args.dropout or 0.0))
        if self.meta["task"] != self.task:
            raise ValueError(f"'{args.model}' is a {self.meta['task']} model, not a "
                             f"{self.task} model")
        if state_dict is None:
            init_weights(model, self.meta, torch.Generator().manual_seed(args.seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = parallel.replicate(model.to(self.device).train())
        # every rank takes the same precision: any rank's divergence decides for all
        if dtype == torch.bfloat16 and \
                parallel.sync_flag(not check_bf16(self.model, imgsz=min(args.imgsz, 64))):
            LOGGER.warning("bf16 forward diverges from f32 on this model; falling back to f32 "
                           "compute (AMP disabled)")
            set_compute_dtype(self.model, torch.float32)
        self.model.remat = bool(args.remat)
        if args.remat:
            LOGGER.info("remat=True: per-block activation checkpointing (larger batches at "
                        "~1/3 extra backward FLOPs)")
        self.eval_model = None  # validate's copy, made at the first validation
        self.generator = torch.Generator(device=self.device).manual_seed(args.seed + 1)  # dropout
        set_generator(self.model, self.generator)
        self.cb_counts = torch.zeros(self.meta.get("state_classes") or 1, device=self.device)
        if args.batch == -1:
            args.batch = self._autobatch()
        self.train_loader = DataLoader(self.train_set, args.batch, workers=args.workers,
                                       seed=args.seed, rank=self.rank, world=self.world)
        if dist.is_initialized() and args.mesh_shape:
            self.wrap_ddp()
        self.gathered_bytes = 0  # bytes each rank receives for the loss, the last step
        self.nb = max(len(self.train_loader), 1)
        self.optimizer = Optimizer(args, self.nb, nc, self.model)
        self.accumulate = self.optimizer.accumulate
        self.ema = [p.detach().clone() for p in self.model.parameters()]
        self.step = 0  # micro-steps so far
        self.epoch = 0
        self.device_augment = bool(getattr(self.train_set, "device_augment", False))
        self._mosaic_on = self.device_augment and float(args.mosaic or 0) > 0
        self.aug_hyp = {k: float(getattr(args, k) or 0) for k in AUG_KEYS}
        if getattr(self.train_set, "flip_idx", None) is not None:
            self.aug_hyp["flip_idx"] = tuple(int(i) for i in self.train_set.flip_idx)
        self._ms_rng = np.random.default_rng(args.seed + 7)  # multi_scale's sizes
        self._trace = None      # the active torch.profiler capture of profile='trace'
        self._traced = False
        if self.device_augment:
            LOGGER.info("device_augment: mosaic/affine/HSV/flip run in the train step on the "
                        "device (the host decodes and letterboxes only)")
        if args.resume:
            self._resume()
        self.run_callbacks("on_pretrain_routine_end")

    def _autobatch(self) -> int:
        """batch=-1 (`utils/autobatch.py`): on CUDA, the bytes of a forward, loss and backward
        of the model on the first train samples at the probe batches (the model's state and
        the dropout and denoising streams put back after), the EMA and two optimizer
        moments beside them."""
        from sar_yolo_tpu_torch.utils.autobatch import PROBE_BATCHES, check_train_batch_size
        if self.device.type != "cuda":
            return check_train_batch_size(device=self.device)
        first = next(iter(DataLoader(self.train_set, max(PROBE_BATCHES), workers=self.args.workers,
                                     shuffle=False, drop_last=False)))
        state = copy.deepcopy(self.model.state_dict())
        gens = [g for g in (self.generator, getattr(self, "dn_generator", None)) if g is not None]
        rngs = [g.get_state() for g in gens]

        def step_peak(b: int) -> int:
            part = {k: v[:b] for k, v in first.items() if isinstance(v, (np.ndarray, list))}
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in part.items()
                     if isinstance(v, np.ndarray)}
            batch["img"] = (batch["img"].permute(0, 3, 1, 2).float() / 255.0).to(
                self.model.compute_dtype)
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
            total = self.loss(*self.gather_global(self.forward(batch), batch))[0]
            total.backward()
            peak = torch.cuda.max_memory_allocated(self.device) - base
            self.model.zero_grad(set_to_none=True)
            return peak

        try:
            fixed = 3 * sum(p.numel() * p.element_size() for p in self.model.parameters())
            return check_train_batch_size(step_peak, self.device, fixed=fixed)
        finally:
            self.model.load_state_dict(state)
            for g, rng in zip(gens, rngs):
                g.set_state(rng)
            torch.cuda.empty_cache()

    def aug_params(self, batch: dict, i: int):
        """The device augmentation's draws for batch i of this epoch, from a generator keyed
        by (seed, epoch, i): a resumed run draws what the uninterrupted run drew. Under data
        parallelism, the global batch's draws with mosaic partners within each rank's rows
        (the JAX package's `partner_span = B // dp`), this rank's rows of them, the partner
        indices counted from its first row."""
        b, S = batch["img"].shape[:2]
        B = b * self.world
        p = draw_params(np.random.default_rng((self.args.seed, self.epoch, i)), B, S,
                        self.aug_hyp, self._mosaic_on, partner_span=b,
                        M=batch["bboxes"].shape[1])
        rows = parallel.local_rows(B)
        return type(p)(*(t[rows] for t in p))._replace(sel=p.sel[rows] - rows.start)

    def to_device(self, batch: dict, i: int = 0) -> dict:
        """Numpy batch i of the epoch -> device tensors, its uint8 NHWC images -> NCHW in
        [0, 1] in the model's compute dtype; on the device route augmented there first."""
        dtype = self.model.compute_dtype
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device, non_blocking=True)
               for k, v in batch.items()}
        if self.device_augment:
            out = device_train_augment(out, self.aug_params(out, i).to(self.device), self.aug_hyp,
                                       mosaic=self._mosaic_on, partner_span=out["img"].shape[0],
                                       dtype=dtype)
            out["img"] = out["img"].permute(0, 3, 1, 2)
        else:
            out["img"] = (out["img"].permute(0, 3, 1, 2).float() / 255.0).to(dtype)
        return out

    def _multi_scale(self, batch: dict) -> dict:
        """The JAX package's multi-scale training: the whole numpy batch resized (OpenCV's
        INTER_LINEAR, `data/cv.py`) to a random multiple of the grid stride in
        [0.5, 1.5] x imgsz, drawn from a generator seeded with seed + 7. The boxes are
        normalized, so the labels stay as they are; segment masks follow at sz / 4 by
        OpenCV's INTER_NEAREST."""
        gs = max(int(max(self.meta["strides"])), 32)
        imgsz = self.args.imgsz
        sz = int(self._ms_rng.integers(int(imgsz * 0.5), int(imgsz * 1.5) + gs) // gs * gs)
        if sz == batch["img"].shape[1]:
            return batch
        out = {**batch, "img": np.stack([resize(im, (sz, sz)) for im in np.asarray(batch["img"])])}
        if "masks" in out and out["masks"].ndim == 3:
            out["masks"] = np.stack([resize_nearest_cv(m, (sz // 4, sz // 4)) for m in out["masks"]])
        return out

    def _start_trace(self):
        """Start profile='trace''s torch.profiler capture (CPU, and CUDA on the card)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                                         else [])
        self._trace, self._traced = profile(activities=acts), True  # one capture per run
        self._trace.start()

    def _stop_trace(self):
        """Close the active capture, if any, and write it to save_dir/trace as a Chrome
        trace; safe on the exception path (a capture never outlives its steps)."""
        if self._trace is None:
            return
        trace, self._trace = self._trace, None
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            trace.stop()
            out = self.save_dir / "trace" / "train_steps.pt.trace.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            trace.export_chrome_trace(str(out))
            LOGGER.info(f"torch.profiler trace written to {out}")
        except Exception as e:  # noqa: BLE001 — tracing is best-effort
            LOGGER.warning(f"profile='trace': closing the capture failed: {e}")

    @torch.no_grad()
    def update(self, cb_counts):
        """After the backward: the optimizer, the EMA (d = 0.9999 (1 - exp(-step/2000)),
        in float32), the class-balanced counts and the step count."""
        self.optimizer.step()
        self.model.zero_grad(set_to_none=True)
        self.step += 1
        d = float(np.float32(0.9999) * (np.float32(1.0) -
                                        np.exp(np.float32(-self.step) / np.float32(2000.0))))
        params = [p.detach() for p in self.model.parameters()]
        torch._foreach_mul_(self.ema, d)
        torch._foreach_add_(self.ema, params, alpha=1.0 - d)
        self.cb_counts = cb_counts

    @property
    def net(self):
        """The module the train forward runs: the DDP wrapper under data parallelism."""
        return self.ddp or self.model

    def forward(self, batch: dict):
        """The train-mode forward of a device batch."""
        return self.net(batch["img"])

    def feats_batch_dim(self, t: torch.Tensor):
        """The batch dim of a leaf of the head's train outputs (None: none)."""
        return 0

    def gather_global(self, feats, batch: dict):
        """Under data parallelism, the global batch's head outputs (with autograd) and label
        leaves (every tensor of the batch but the images); their bytes, one rank's receipt, in
        `gathered_bytes`."""
        if self.world == 1:
            return feats, batch
        b = batch["img"].shape[0]
        labels = {k: v for k, v in batch.items()
                  if k != "img" and torch.is_tensor(v) and v.dim() and len(v) == b}
        feats = parallel.gather_tree(feats, self.feats_batch_dim)
        labels = parallel.gather_tree(labels)
        self.gathered_bytes = sum(t.numel() * t.element_size() * (self.world - 1) // self.world
                                  for t in torch.utils._pytree.tree_leaves((feats, labels))
                                  if torch.is_tensor(t))
        return feats, {**batch, **labels}

    def train_step(self, batch: dict, i: int = 0):
        """One micro-step on numpy batch i of the epoch (this rank's rows of it). Returns
        (total, items), both on the device: the global batch's."""
        b = self.to_device(batch, i)
        total, items, cb = self.loss(*self.gather_global(self.forward(b), b))
        total.backward()
        self.update(cb)
        return total.detach(), items

    def train(self) -> dict:
        """The epoch loop: mean loss items per epoch, then validation and its fitness
        (-sum(items) without `val`), the checkpoints, patience and the `time` limit; returns
        the last epoch's metrics."""
        if self.model is None:
            self.setup()
        args = self.args
        patience = args.patience or math.inf
        last_improve = 0
        t_start = time.time()
        self.run_callbacks("on_train_start")
        for epoch in range(self.epoch, args.epochs):
            self.epoch = epoch
            self.run_callbacks("on_train_epoch_start")
            if args.close_mosaic and epoch >= max(args.epochs - args.close_mosaic, 0) \
                    and (getattr(self.train_set, "mosaic_enabled", False) or self._mosaic_on):
                LOGGER.info("Closing dataloader mosaic")
                self.train_set.mosaic_enabled = False
                self._mosaic_on = False
            self.train_loader.set_epoch(epoch)
            te, total, n = time.time(), None, 0
            for i, batch in enumerate(self.train_loader):
                self.run_callbacks("on_train_batch_start")
                if epoch == 0 and i == 0 and args.plots and self.rank == 0:
                    self._plot_first_batch(batch)
                if args.multi_scale:
                    batch = self._multi_scale(batch)
                # profile='trace': steps 1-3 of epoch 0 (step 0 when the epoch has one batch)
                if str(args.profile).lower() == "trace" and epoch == 0 and not self._traced \
                        and (i == 1 or len(self.train_loader) <= 1):
                    self._start_trace()
                try:
                    _, items = self.train_step(batch, i)
                except BaseException:
                    self._stop_trace()
                    raise
                if i >= 3:
                    self._stop_trace()
                total = items if total is None else total + items
                n += 1
                self.run_callbacks("on_train_batch_end")
            self._stop_trace()  # an epoch of under 4 batches
            mloss = (total / max(n, 1)).cpu().numpy()
            u = self.step // self.accumulate
            self.lr = {f"lr/pg{i}": s(u) for i, s in enumerate(self.optimizer.schedules)}
            losses = {f"train/{k}": float(v) for k, v in zip(self.loss_names, mloss)}
            LOGGER.info(f"epoch {epoch + 1}/{args.epochs}  " +
                        "  ".join(f"{k}={v:.4f}" for k, v in zip(self.loss_names, mloss)) +
                        f"  lr={self.lr['lr/pg0']:.5f}  {time.time() - te:.1f}s")
            self.tloss = losses
            self.run_callbacks("on_train_epoch_end")
            self.metrics = dict(losses)
            self.fitness = -float(mloss.sum())
            if args.val and self.rank == 0:
                vmetrics = self.validate()
                self.metrics.update(vmetrics)
                self.fitness = vmetrics.get("fitness", self.fitness)
            improved = self.fitness > self.best_fitness
            if improved:
                self.best_fitness, last_improve = self.fitness, epoch
            if self.rank == 0:
                self._save_csv_row(epoch, losses, self.lr["lr/pg0"])
                if args.save:
                    self.save_model(improved)
            self.run_callbacks("on_fit_epoch_end")
            early = self.rank == 0 and not improved and epoch - last_improve >= patience
            late = bool(args.time) and (time.time() - t_start) / 3600 > args.time
            if parallel.sync_flag(early or late):
                LOGGER.info(f"EarlyStopping: no improvement in {patience} epochs" if early else
                            f"Stopping: over the time limit of {args.time} hours")
                break
        if args.plots and self.rank == 0:
            try:
                plot_results(self.csv)
            except Exception as e:  # noqa: BLE001 — plots never fail a run
                LOGGER.warning(f"plot_results failed: {e}")
        self.run_callbacks("on_train_end")
        LOGGER.info(f"Training complete in {(time.time() - t_start) / 3600:.3f} hours")
        return self.metrics

    def _plot_first_batch(self, batch: dict):
        """train_batch0.png of a batch with 4-column boxes, and the train set's label
        statistics (labels.jpg, labels_correlogram.jpg) where it has labels."""
        try:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            if "bboxes" in batch and batch["bboxes"].ndim == 3 and batch["bboxes"].shape[-1] == 4:
                plot_images(batch, self.save_dir / "train_batch0.png")
            labels = [lb for lb in getattr(self.train_set, "labels", None) or ()
                      if len(lb.get("bboxes", ()))]
            if labels:
                plot_labels(np.concatenate([np.asarray(lb["bboxes"], np.float32).reshape(-1, 4)
                                            for lb in labels]),
                            np.concatenate([np.asarray(lb["cls"]).reshape(-1) for lb in labels]),
                            names=self.data.get("names"), save_dir=self.save_dir)
        except Exception as e:  # noqa: BLE001 — plots never fail a run
            LOGGER.warning(f"plot_images failed: {e}")

    @torch.no_grad()
    def validate(self) -> dict:
        """Validate the EMA parameters with the live BN statistics, on an eval copy of the
        model: the trained model, its BN statistics and its dropout stream stay as they are."""
        if self.eval_model is None:
            self.eval_model = copy.deepcopy(self.model)
        self.eval_model.load_state_dict(self.model.state_dict())
        for p, e in zip(self.eval_model.parameters(), self.ema):
            p.copy_(e)
        return self.validator(model=self.eval_model.eval(), meta=self.meta, dataset=self.val_set,
                              args=self.args, data=self.data)

    def _save_csv_row(self, epoch: int, losses: dict, lr: float):
        """Append the epoch's losses, validation metrics and lr to results.csv."""
        self.save_dir.mkdir(parents=True, exist_ok=True)
        row = {"epoch": epoch, **losses, **{k: v for k, v in self.metrics.items()
                                            if not k.startswith("train/")}, "lr": lr}
        header = not self.csv.exists()
        with self.csv.open("a") as f:
            if header:
                f.write(",".join(row.keys()) + "\n")
            f.write(",".join(f"{v:.6g}" if isinstance(v, float) else str(v)
                             for v in row.values()) + "\n")

    def save_model(self, improved: bool):
        """weights/last, weights/best where `improved`, weights/epoch{n} every save_period
        epochs. The state: the model's state dict (parameters and BN statistics), the EMA by
        parameter name, cb_counts, the optimizer, the dropout generator; the metadata: the
        JAX package's run_meta.json keys and the class names."""
        state = {"model": self.model.state_dict(),
                 "ema": {n: e for (n, _), e in zip(self.model.named_parameters(), self.ema)},
                 "cb_counts": self.cb_counts, "optimizer": self.optimizer.state_dict(),
                 "rng": self.generator.get_state(),
                 "ms_rng": self._ms_rng.bit_generator.state}
        if getattr(self, "dn_generator", None) is not None:  # RT-DETR's denoising draws
            state["dn_rng"] = self.dn_generator.get_state()
        metadata = {"epoch": self.epoch, "best_fitness": float(self.best_fitness),
                    "train_args": vars(self.args), "model_yaml": self.meta["cfg"],
                    "task": self.task, "nc": self.meta["nc"], "strides": self.meta["strides"],
                    "step": self.step, "names": self.data["names"]}
        save_checkpoint(self.wdir / "last", state, metadata)
        if improved:
            save_checkpoint(self.wdir / "best", state, metadata)
        if self.args.save_period > 0 and (self.epoch + 1) % self.args.save_period == 0:
            save_checkpoint(self.wdir / f"epoch{self.epoch + 1}", state, metadata)
        self.run_callbacks("on_model_save")

    def _resume(self):
        """Restore `resume`'s checkpoint (True: this run's weights/last) and continue at the
        epoch after it. Without optimizer state (a converted JAX checkpoint) the optimizer
        starts fresh, as the JAX package's resume does."""
        path = self.args.resume if isinstance(self.args.resume, (str, Path)) else self.wdir / "last"
        state, metadata = load_checkpoint(path)
        self.epoch = int(metadata.get("epoch", -1)) + 1
        self.best_fitness = float(metadata.get("best_fitness", -math.inf))
        self.step = int(metadata.get("step", 0))
        self.model.load_state_dict(state["model"])
        self.ema = [state["ema"][n].to(self.device) for n, _ in self.model.named_parameters()]
        self.cb_counts = state["cb_counts"].to(self.device)
        if state.get("optimizer") is not None:
            self.optimizer.load_state_dict(state["optimizer"])
        else:
            LOGGER.warning("resume: the checkpoint has no optimizer state; momentum and the "
                           "schedule counters start fresh")
        if state.get("rng") is not None:
            self.generator.set_state(state["rng"])
        if state.get("ms_rng") is not None:
            self._ms_rng.bit_generator.state = state["ms_rng"]
        if state.get("dn_rng") is not None and getattr(self, "dn_generator", None) is not None:
            self.dn_generator.set_state(state["dn_rng"])
        LOGGER.info(f"Resumed from {path} at epoch {self.epoch}")

    @torch.no_grad()
    def ema_model(self) -> torch.nn.Module:
        """The model with the EMA parameters and the live BN statistics, in eval mode."""
        for p, e in zip(self.model.parameters(), self.ema):
            p.copy_(e)
        return self.model.eval()


class DetectionTrainer(BaseTrainer):
    """Trains a detect model: the v8 loss (box, cls, dfl; v10: its dual assignment), the
    detect validator.

    Examples:
        >>> tr = DetectionTrainer({"model": "yolov8n.yaml", "data": "coco8.yaml", "imgsz": 64,
        ...                        "batch": 2, "epochs": 1}, device="cpu")
        >>> metrics = tr.train()
    """

    task = "detect"
    loss_names = ("box", "cls", "dfl")
    validator_cls = DetectionValidator

    def loss(self, feats, batch: dict):
        """The v8 loss; a v10 head's train maps take the dual-assignment sum of the JAX
        package: the one2many maps' loss at TAL top-k 10 plus the one2one maps' at top-k 1
        (totals and items added)."""
        meta = self.meta
        kw = dict(nc=meta["nc"], reg_max=meta["reg_max"], strides=tuple(meta["strides"]))
        if meta.get("head") == "v10Detect":
            m = detection_loss(feats["one2many"], batch, self.args, tal_topk=10, **kw)
            o = detection_loss(feats["one2one"], batch, self.args, tal_topk=1, **kw)
            return m.total + o.total, m.items + o.items, self.cb_counts
        out = detection_loss(feats, batch, self.args, **kw)
        return out.total, out.items, self.cb_counts


class JDETrainer(BaseTrainer):
    """Trains a JDE model: the v13 JDE loss (box, cls, dfl, emb, state), the JDE validator.

    Examples:
        >>> tr = JDETrainer({"model": "tinyjde.yaml", "data": "path/to/SARD.yaml", "imgsz": 64,
        ...                  "batch": 2, "epochs": 1}, device="cpu")
        >>> metrics = tr.train()
    """

    task = "jde"
    loss_names = ("box", "cls", "dfl", "emb", "state")
    validator_cls = JDEValidator

    def loss(self, feats, batch: dict):
        meta = self.meta
        out = jde_loss(feats, batch, self.args, nc=meta["nc"], reg_max=meta["reg_max"],
                       strides=tuple(meta["strides"]), embed_dim=meta["embed_dim"],
                       state_classes=meta["state_classes"] or 1, cb_counts=self.cb_counts)
        return out.total, out.items, out.cb_counts


class PoseTrainer(BaseTrainer):
    """Trains a pose model: the v8 pose loss (box, pose, kobj, cls, dfl), the pose validator.

    Examples:
        >>> tr = PoseTrainer({"model": "tinypose.yaml", "data": "synthetic", "imgsz": 64,
        ...                   "batch": 2, "epochs": 1}, device="cpu")
        >>> metrics = tr.train()
    """

    task = "pose"
    loss_names = ("box", "pose", "kobj", "cls", "dfl")
    validator_cls = PoseValidator

    def loss(self, feats, batch: dict):
        meta = self.meta
        out = pose_loss(feats, batch, self.args, nc=meta["nc"], reg_max=meta["reg_max"],
                        strides=tuple(meta["strides"]), kpt_shape=tuple(meta["kpt_shape"]))
        return out.total, out.items, self.cb_counts


class SegmentTrainer(BaseTrainer):
    """Trains a segment model: the v8 segmentation loss (box, seg, cls, dfl), the segment
    validator.

    Examples:
        >>> tr = SegmentTrainer({"model": "tinyseg.yaml", "data": "synthetic", "imgsz": 64,
        ...                      "batch": 2, "epochs": 1}, device="cpu")
        >>> metrics = tr.train()
    """

    task = "segment"
    loss_names = ("box", "seg", "cls", "dfl")
    validator_cls = SegmentValidator

    def loss(self, feats, batch: dict):
        meta = self.meta
        out = segmentation_loss(feats, batch, self.args, nc=meta["nc"], reg_max=meta["reg_max"],
                                strides=tuple(meta["strides"]), nm=meta["nm"])
        return out.total, out.items, self.cb_counts


class OBBTrainer(BaseTrainer):
    """Trains an OBB model: the rotated v8 loss (box 1 - probiou, cls, dfl), the OBB
    validator. Data: the synthetic set (`data="synthetic"`); a YOLO-format dataset raises
    (`YOLODataset(task="obb")`), as the JAX package has no OBB label branch.

    Examples:
        >>> tr = OBBTrainer({"model": "tinyobb.yaml", "data": "synthetic", "imgsz": 64,
        ...                  "batch": 2, "epochs": 1}, device="cpu")
        >>> metrics = tr.train()
    """

    task = "obb"
    loss_names = ("box", "cls", "dfl")
    validator_cls = OBBValidator

    def loss(self, feats, batch: dict):
        meta = self.meta
        out = obb_loss(feats, batch, self.args, nc=meta["nc"], reg_max=meta["reg_max"],
                       strides=tuple(meta["strides"]))
        return out.total, out.items, self.cb_counts


class ClassificationTrainer(BaseTrainer):
    """Trains a classify model: the mean cross-entropy of the logits, the top-1 / top-5
    validator. Data: a folder with `train/` and `val/` or `test/` class-folder splits
    (`ClassificationDataset`; without `train/` the folder itself, and the train split
    validates where neither val nor test exists), or the synthetic set.

    Examples:
        >>> tr = ClassificationTrainer({"model": "tinycls.yaml", "data": "path/to/folder",
        ...                             "imgsz": 64, "batch": 4, "epochs": 1}, device="cpu")
        >>> metrics = tr.train()
    """

    task = "classify"
    loss_names = ("loss",)
    validator_cls = ClassificationValidator

    def get_dataset(self):
        data = self.args.data
        if data and Path(str(data)).is_dir():
            root = Path(str(data))
            train_dir = root / "train" if (root / "train").is_dir() else root
            val_dir = next((root / s for s in ("val", "test") if (root / s).is_dir()), train_dir)
            train = ClassificationDataset(train_dir, imgsz=self.args.imgsz, augment=True,
                                          hyp=self.args)
            val = ClassificationDataset(val_dir, imgsz=self.args.imgsz, augment=False)
            return train, val, {"nc": len(train.names), "names": train.names}
        return super().get_dataset()

    def loss(self, logits, batch: dict):
        out = classification_loss(logits, batch)
        return out.total, out.items, self.cb_counts


class RTDETRTrainer(DetectionTrainer):
    """Trains an RT-DETR model (a detect model with an RTDETRDecoder head): the DETR loss
    (cls, bbox, giou; `utils/detr_loss.py`) with contrastive-denoising queries built from the
    padded ground truth, the RT-DETR validator. The denoising draws of each step come from
    the trainer's generator on the device (seed + 3; `cdn_draws`), kept in the checkpoints.

    Examples:
        >>> tr = RTDETRTrainer({"model": "tinyrtdetr.yaml", "data": "synthetic", "imgsz": 64,
        ...                     "batch": 2, "epochs": 1}, device="cpu")
        >>> metrics = tr.train()
    """

    loss_names = ("cls", "bbox", "giou")
    validator_cls = RTDETRValidator

    def setup(self, state_dict: dict | None = None):
        self.dn_generator = torch.Generator(device=self.device).manual_seed(self.args.seed + 3)
        super().setup(state_dict)
        if self.meta.get("head") != "RTDETRDecoder":
            raise ValueError(f"'{self.args.model}' has no RTDETRDecoder head")

    def cdn_draws(self, batch: dict) -> dict:
        """The denoising queries' draws for a device batch (`draw_cdn`): under data
        parallelism, this rank's rows of the global batch's draws."""
        B, M = batch["cls"].shape
        rows = parallel.local_rows(B * self.world)
        return {k: v[rows] for k, v in draw_cdn(B * self.world, M, self.meta["nc"],
                                                self.dn_generator, self.device).items()}

    def feats_batch_dim(self, t: torch.Tensor):
        """The decoder layers' outputs (L, B, ...) batch at dim 1, the encoder's at 0;
        `pos_flag` (DN,) has none."""
        return 1 if t.dim() == 4 else None if t.dim() == 1 else 0

    def forward(self, batch: dict):
        gt = {k: batch[k] for k in ("cls", "bboxes", "mask")}
        return self.net(batch["img"], gt, self.cdn_draws(batch))

    def loss(self, outputs, batch: dict):
        out = detr_loss(outputs, batch)
        return out.total, out.items, self.cb_counts


TRAINERS = {"detect": DetectionTrainer, "jde": JDETrainer, "pose": PoseTrainer,
            "segment": SegmentTrainer, "obb": OBBTrainer, "classify": ClassificationTrainer}


def train_rank(rank: int, device, trainer_cls, overrides: dict, callbacks: dict) -> dict | None:
    """One rank of `YOLO.train(mesh_shape=[N])` under `parallel.spawn`: the trainer's whole
    run on `device` (rank 0 with `callbacks`, {event: [functions]}). Rank 0 returns the
    metrics, the model with the EMA parameters (its state dict on the CPU and compute dtype),
    the meta, the class names and the weights directory."""
    tr = trainer_cls(overrides, device=device)
    for event, fns in callbacks.items():
        for fn in fns:
            tr.add_callback(event, fn)
    metrics = tr.train()
    if rank:
        return None
    model = tr.ema_model()
    return {"metrics": metrics, "state": {k: v.cpu() for k, v in model.state_dict().items()},
            "compute_dtype": model.compute_dtype, "meta": tr.meta, "names": tr.data["names"],
            "wdir": str(tr.wdir)}


def probe_functional(feats, seed: int, rows=None) -> torch.Tensor:
    """sum(t * r) over the floating leaves of head outputs, r standard normal from `seed`
    (the same on every rank for the same shapes): a loss whose gradient holds no discrete
    decision (no assignment, no mining), so that float32 rounding alone separates two
    data-parallel paths. `rows`: the batch's order, r[rows] along dim 0."""
    leaves = [t for t in torch.utils._pytree.tree_leaves(feats)
              if torch.is_tensor(t) and t.is_floating_point()]
    total = 0.0
    for i, t in enumerate(leaves):
        r = torch.randn(t.shape, generator=torch.Generator(t.device).manual_seed(seed + i),
                        device=t.device)
        total = total + (t * (r if rows is None else r[rows]).to(t.dtype)).sum()
    return total


def train_steps(rank: int, device, trainer_cls, overrides: dict, batches: list,
                state_dict: dict | None = None, timed: int = 0, float64: bool = False,
                probe_seed: int | None = None) -> dict:
    """Train steps of a data-parallel trainer on given global numpy batches (each rank takes
    its rows), dropout off. Rank 0 returns every step's loss items, cb_counts and gradient
    (DDP's average, before the update), each rank's
    area-attention launches a step, the model's state dict and EMA after the last, the
    largest difference of any parameter, BN statistic or EMA value between the ranks (0.0:
    the replicas are equal) and the bytes a rank receives for the loss a step; with `timed`,
    also the host ms of that many more steps on the first batch (synchronized) and the ms of
    the model's forward collectives in each (`parallel.timed_collectives`). `float64`: the
    model, its EMA and its compute in float64, the attention on its plain path (the step
    without float32's rounding, to hold the algorithm itself against the one-process step).
    `probe_seed`: the loss is `probe_functional` of the global batch's head outputs."""
    from sar_yolo_tpu_torch.nn.modules.block import AAttn
    from sar_yolo_tpu_torch.nn.modules.conv import Dropout
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    tr = trainer_cls(overrides, device=device)
    tr.setup(state_dict=state_dict)
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        if float64 and isinstance(m, AAttn):
            m.use_flash = False
    if float64:
        tr.model.double()
        tr.ema = [e.double() for e in tr.ema]
        if tr.ddp is not None:
            tr.wrap_ddp()
    if probe_seed is not None:
        def probe(feats, batch):
            total = probe_functional(feats, probe_seed)
            return total, total.detach().reshape(1), tr.cb_counts
        tr.loss = probe
    items, cb_counts, launches, grads = [], [], [], []
    update = tr.optimizer.step

    def step():
        grads.append({n: p.grad.detach().cpu().clone() for n, p in tr.model.named_parameters()
                      if p.grad is not None})
        return update()
    tr.optimizer.step = step
    for i, batch in enumerate(batches):
        n0 = flash_area_attention.launches
        _, it = tr.train_step(parallel.shard_batch(batch), i)
        launches.append(flash_area_attention.launches - n0)
        items.append(it.detach().cpu())
        cb_counts.append(tr.cb_counts.detach().cpu().clone())
    flat = torch.cat([t.detach().float().flatten() for t in
                      [*tr.model.state_dict().values(), *tr.ema]])
    parts, by_rank = [flat], [launches]
    if tr.world > 1:
        parts = [torch.empty_like(flat) for _ in range(tr.world)]
        dist.all_gather(parts, flat)
        by_rank = [None] * tr.world
        dist.all_gather_object(by_rank, launches)
    tr.optimizer.step = update
    out = {"items": items, "cb_counts": cb_counts, "grads": grads, "launches_by_rank": by_rank,
           "rank_spread": max((p - parts[0]).abs().max().item() for p in parts),
           "gathered_bytes": tr.gathered_bytes,
           "state": {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()},
           "ema": {n: e.cpu().clone() for (n, _), e in zip(tr.model.named_parameters(), tr.ema)}}
    sync = torch.cuda.synchronize if tr.device.type == "cuda" else (lambda: None)
    out["step_ms"], out["collective_ms"] = [], []
    for _ in range(timed):
        sync()
        t0 = time.perf_counter()
        with parallel.timed_collectives() as seconds:
            tr.train_step(parallel.shard_batch(batches[0]))
        sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["collective_ms"].append(sum(seconds) * 1e3)
    return out
