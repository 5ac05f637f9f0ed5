"""Model graph builder: config dict -> torch module graph (port of `sar_yolo_tpu/nn/tasks.py`).

`parse_model` does the JAX package's channel, depth and width arithmetic and
returns the same LayerSpec records, for the modules of the yolov8, yolo11,
yolov12 and yolov13 detect and JDE graphs and the fork's CBAM variants; a module
the port does not have yet raises NotImplementedError naming it. `GraphModel`
walks the specs with the same save-dict; its layers live in `blocks` (Flax scope
`blocks_<i>`).
"""

from __future__ import annotations

import contextlib
import copy
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sar_yolo_tpu_torch.cfg.models import model_config
from sar_yolo_tpu_torch.nn.modules import block as B
from sar_yolo_tpu_torch.nn.modules import conv as C
from sar_yolo_tpu_torch.nn.modules import head as H
from sar_yolo_tpu_torch.utils import LOGGER


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


@dataclass(frozen=True)
class LayerSpec:
    """One node of the model graph."""

    i: int                 # layer index
    f: Any                 # from: -1, int, or tuple of ints
    name: str              # module name
    args: tuple            # resolved constructor args (after channel arithmetic)
    c2: int                # output channels
    kwargs: tuple = ()     # resolved keyword args as tuple of (k, v)


# modules whose first yaml arg is the (width-scaled) output channel count
_CH_SCALED = {"Conv", "DSConv", "Bottleneck", "C2f", "C3k2", "C3k2_CBAM", "SPPF", "A2C2f",
              "DSC3k2", "DSC3k2_CBAM", "C2PSA"}
# subset that takes an inserted repeat count n
_REPEAT_ARG = {"C2f", "C3k2", "C3k2_CBAM", "A2C2f", "DSC3k2", "DSC3k2_CBAM", "C2PSA"}
_C3K2_FAMILY = {"C3k2", "DSC3k2", "C3k2_CBAM", "DSC3k2_CBAM"}
_HEADS = {"Detect", "JDE"}


def _resolve_arg(a, names: dict):
    if isinstance(a, str):
        if a in names:
            return names[a]
        low = a.lower()
        if low in {"true", "false", "none"}:
            return {"true": True, "false": False, "none": None}[low]
    return a


def parse_model(d: dict, ch: int = 3):
    """Compile a config dict into (LayerSpecs, save list, meta), as the JAX package does."""
    legacy = True
    max_channels = float("inf")
    nc = d.get("nc", 80)
    scales = d.get("scales")
    depth, width = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0)
    scale = d.get("scale", "")
    if scales:
        if not scale:
            scale = tuple(scales.keys())[0]
            LOGGER.warning(f"WARNING: no model scale passed, assuming scale='{scale}'")
        depth, width, max_channels = scales[scale]

    names = {"nc": nc, "kpt_shape": d.get("kpt_shape"), "state_classes": d.get("state_classes")}
    chs = [ch]
    specs: list[LayerSpec] = []
    save: list[int] = []
    meta: dict[str, Any] = {"nc": nc, "scale": scale, "reg_max": 16}
    act = d.get("activation")
    if act:
        key = str(act).removeprefix("nn.").replace("(", "").replace(")", "").lower()
        if key not in C.ACTIVATIONS:
            raise KeyError(f"unsupported activation '{act}' in model config")
        meta["act"] = key

    for i, (f, n, m, args) in enumerate(d["backbone"] + d["head"]):
        args = [_resolve_arg(a, names) for a in args]
        n = max(round(n * depth), 1) if n > 1 else n
        kwargs: dict[str, Any] = {}

        if m in _CH_SCALED:
            c2 = make_divisible(min(args[0], max_channels) * width, 8)
            args = [c2, *args[1:]]
            if m in _REPEAT_ARG:
                args.insert(1, n)
                n = 1
            if m in _C3K2_FAMILY:
                legacy = False
                if scale in "lx":  # force c3k / dsc3k inner blocks on large scales
                    if len(args) >= 3:
                        args[2] = True
                    else:
                        args.append(True)
            if m == "A2C2f":
                legacy = False
                if scale in "lx":  # residual=True, mlp_ratio=1.5
                    while len(args) < 4:
                        args.append(True if len(args) == 2 else 1)
                    args += [True, 1.5]
        elif m == "nn.Upsample":
            m = "Upsample"
            args = [int(args[1]), str(args[2])]
            c2 = chs[f]
        elif m == "Concat":
            c2 = sum(chs[x] for x in f)
            args = []
        elif m in _HEADS:
            ch_list = tuple(chs[x] for x in f)
            kwargs["ch"] = ch_list
            kwargs["legacy"] = legacy
            c2 = 0  # heads terminate the graph
            meta["head"] = m
            meta["head_index"] = i
            meta["head_ch"] = ch_list
            meta["nl"] = len(ch_list)
        elif m == "HyperACE":
            legacy = False
            c1 = chs[f[1]]
            c2 = make_divisible(min(args[0], max_channels) * width, 8)
            he = args[1]
            if scale == "n":
                he = int(args[1] * 0.5)
            elif scale == "x":
                he = int(args[1] * 1.5)
            args = [c1, c2, n, he, *args[2:]]
            n = 1
            if scale in "lx":
                args.append(False)  # channel_adjust=False for l/x
        elif m == "DownsampleConv":
            c1 = chs[f]
            c2 = c1 * 2
            args = [c1]
            if scale in "lx":
                args.append(False)
                c2 = c1
        elif m == "FullPAD_Tunnel":
            c2 = chs[f[0]]
            args = []
        elif m == "CBAM":
            c2 = chs[f]
        else:
            raise NotImplementedError(f"layer {i}: module '{m}' is not part of this port yet")
        if n != 1:
            raise NotImplementedError(f"layer {i}: repeated plain module '{m}' (n={n}) is not "
                                      "part of this port yet")

        def _norm(j):
            return j if j == -1 else j % i
        f_norm = tuple(_norm(j) for j in f) if isinstance(f, list) else _norm(f)
        specs.append(LayerSpec(i=i, f=f_norm, name=m, args=tuple(args), c2=c2,
                               kwargs=tuple(sorted(kwargs.items()))))
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            chs = []
        chs.append(c2)

    meta["legacy"] = legacy
    meta["channels"] = chs
    return tuple(specs), tuple(sorted(set(save))), meta


def _build_module(spec: LayerSpec, c_in) -> nn.Module:
    """The torch module for a LayerSpec; c_in is its input channels (a tuple for lists)."""
    a, kw, name = spec.args, dict(spec.kwargs), spec.name
    if name == "Conv":
        return C.Conv(c_in, *a)
    if name == "DSConv":
        return C.DSConv(c_in, *a)
    if name == "Upsample":
        return C.Upsample(*a)
    if name == "Concat":
        return C.Concat()
    if name == "Bottleneck":
        return B.Bottleneck(c_in, *a)
    if name == "C2f":
        return B.C2f(c_in, *a)
    if name == "C3k2":
        return B.C3k2(c_in, *a)
    if name == "C3k2_CBAM":
        return B.C3k2_CBAM(c_in, *a)
    if name == "C2PSA":
        return B.C2PSA(c_in, *a)
    if name == "SPPF":
        return B.SPPF(c_in, *a)
    if name == "A2C2f":
        return B.A2C2f(c_in, *a)
    if name == "DSC3k2":
        return B.DSC3k2(c_in, *a)
    if name == "DSC3k2_CBAM":
        return B.DSC3k2_CBAM(c_in, *a)
    if name == "CBAM":
        return C.CBAM(c_in, *a)
    if name == "HyperACE":
        return B.HyperACE(c_in, *a)
    if name == "DownsampleConv":
        return B.DownsampleConv(*a)
    if name == "FullPAD_Tunnel":
        return B.FullPAD_Tunnel()
    if name == "Detect":
        return H.Detect(nc=a[0], ch=kw["ch"], legacy=kw["legacy"])
    if name == "JDE":
        return H.JDE(nc=a[0], embed_dim=a[1] if len(a) > 1 else 128,
                     state_classes=a[2] if len(a) > 2 else None,
                     ch=kw["ch"], legacy=kw["legacy"])
    raise NotImplementedError(f"module '{name}' is not part of this port yet")


class GraphModel(nn.Module):
    """Runs a parsed layer graph with an explicit save-dict; returns the head's per-level maps.

    `remat`: in train mode every block but the head runs under activation
    checkpointing (the JAX package's `nn.remat` per block): its activations are
    recomputed in the backward. The recomputation draws the same dropout masks
    and leaves the BN running statistics alone, so a step equals the plain one.
    """

    def __init__(self, specs: tuple, save: tuple, act: str = "silu"):
        super().__init__()
        self.specs, self.save = specs, frozenset(save)
        self.remat = False
        self.compute_dtype = torch.float32
        outs: list[int] = []
        blocks = []
        with C.default_act(act):
            for s in specs:
                prev = outs[-1] if outs else 3  # RGB input
                if s.f == -1:
                    c_in = prev
                elif isinstance(s.f, int):
                    c_in = outs[s.f]
                else:
                    c_in = tuple(prev if j == -1 else outs[j] for j in s.f)
                blocks.append(_build_module(s, c_in))
                outs.append(s.c2)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        saved = {}
        out = x
        for spec, blk in zip(self.specs, self.blocks):
            f = spec.f
            if f == -1:
                inp = out
            elif isinstance(f, int):
                inp = saved[f]
            else:
                inp = [out if j == -1 else saved[j] for j in f]
            remat = self.remat and self.training and spec is not self.specs[-1]
            out = _checkpointed(blk, inp) if remat else blk(inp)
            if spec.i in self.save:
                saved[spec.i] = out
        return out


def _checkpointed(blk: nn.Module, inp):
    """blk(inp) under activation checkpointing. The dropout generators of blk are
    rewound to their state at this call for the recomputation and put back after it,
    and the recomputation leaves the BN running statistics as they are."""
    gens = list({id(m.generator): m.generator for m in blk.modules()
                 if isinstance(m, C.Dropout) and m.generator is not None}.values())
    at_call = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        for g, st in zip(gens, at_call):
            g.set_state(st)
        try:
            with C.frozen_bn_stats():
                yield
        finally:
            for g, st in zip(gens, now):
                g.set_state(st)

    return checkpoint(blk, inp, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute()))


def build_model(name: str | dict, nc: int | None = None, dtype=torch.float32):
    """Build a GraphModel from a model name ('yolov13n-JDE.yaml') or a config dict (a
    checkpoint's `model_yaml`, the JAX package's included). Returns (model, meta).

    `nc` replaces the config's class count (the trainer builds the model for
    its dataset's). `dtype` is the compute dtype (the JAX `build_model`'s
    `dtype`): parameters stay float32. The model is on the CPU, in eval mode,
    with torch's default weights until `init_weights` runs; meta["strides"]
    comes from a forward probe.
    """
    d = copy.deepcopy(name) if isinstance(name, dict) else model_config(name)
    if nc is not None:
        d["nc"] = nc
    specs, save, meta = parse_model(d)
    meta["cfg"] = d
    meta["task"] = {"JDE": "jde", "Detect": "detect"}[specs[-1].name]
    head = specs[-1]
    if head.name == "JDE":
        meta["embed_dim"] = head.args[1] if len(head.args) > 1 else 128
        meta["state_classes"] = head.args[2] if len(head.args) > 2 else None
    model = GraphModel(specs, save, act=meta.get("act", "silu")).eval()
    C.set_compute_dtype(model, dtype)
    meta["strides"] = infer_strides(model)
    return model, meta


@torch.no_grad()
def infer_strides(model: GraphModel, imgsz: int = 64) -> list[int]:
    """Per-level strides from a forward probe on a zero image of side imgsz."""
    p = next(model.parameters())
    feats = model(torch.zeros(1, 3, imgsz, imgsz, dtype=p.dtype, device=p.device))
    return [imgsz // f.shape[2] for f in feats]


@torch.no_grad()
def init_weights(model: GraphModel, meta: dict, generator: torch.Generator):
    """Seeded initialization with the JAX package's initializers, then the head bias init.

    Conv kernels: uniform(+-1/sqrt(fan_in)); Linear: normal(0, 1/sqrt(fan_in)); biases 0;
    BN: identity statistics; FullPAD gate 0; A2C2f gamma 0.01;
    prototype_base: xavier uniform. Draws on the CPU from `generator`.
    """
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            bound = fan_in ** -0.5
            mod.weight.copy_(torch.rand(mod.weight.shape, generator=generator) * 2 * bound - bound)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            std = mod.in_features ** -0.5
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
            mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, B.FullPAD_Tunnel):
            mod.gate.zero_()
        elif isinstance(mod, B.A2C2f) and mod.residual:
            mod.gamma.fill_(0.01)
        elif isinstance(mod, B.AdaHyperedgeGen):
            e, d = mod.prototype_base.shape
            bound = (6.0 / (e + d)) ** 0.5
            mod.prototype_base.copy_(
                torch.rand((e, d), generator=generator) * 2 * bound - bound)
    bias_init_head(model, meta)


@torch.no_grad()
def bias_init_head(model: GraphModel, meta: dict):
    """Box pred bias -> 1.0; cls pred bias -> log(5 / nc / (640 / stride)^2)."""
    head = model.blocks[meta["head_index"]]
    for i, s in enumerate(meta["strides"]):
        head._sub(f"cv2_{i}_pred").bias.fill_(1.0)
        head._sub(f"cv3_{i}_pred").bias.fill_(math.log(5 / meta["nc"] / (640 / s) ** 2))
