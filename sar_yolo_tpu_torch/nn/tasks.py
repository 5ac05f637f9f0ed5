"""Model graph builder: config dict -> torch module graph (port of `sar_yolo_tpu/nn/tasks.py`).

`parse_model` does the JAX package's channel, depth and width arithmetic and
returns the same LayerSpec records, for the modules of the yolov3-v13 detect
graphs (v10's NMS-free head included), the JDE graphs and the fork's CBAM
variants, the pose, segment, OBB and classify graphs, the PPHGNetV2 / ResNet backbone
blocks, RT-DETR (AIFI, RTDETRDecoder) and YOLO-World (C2fAttn, ImagePoolingAttn,
WorldDetect); a module the port does not
have yet raises NotImplementedError naming it. `GraphModel` walks the specs with
the same save-dict (a CBLinear's tuple of chunks included); its layers live in
`blocks` (Flax scope `blocks_<i>`), and a plain module repeated n times is a
`Repeat` whose copies take Flax's automatic names (`Conv_0`, `Conv_1`, ...).

A World graph owns one `text_embeddings` parameter (n, E): each C2fAttn reads the
running text copy, which an ImagePoolingAttn replaces (the image passes through it), and
WorldDetect always reads the original rows. An RT-DETR graph hands `batch_gt` and the CDN
draws to its decoder in train mode.
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
from sar_yolo_tpu_torch.nn.modules import transformer as T
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
_CH_SCALED = {"Conv", "DWConv", "DSConv", "Bottleneck", "SPPF", "C2", "C2f", "C3", "C3k",
              "C3k2", "C3k2_CBAM", "A2C2f", "DSC3k2", "DSC3k2_CBAM", "RepC3", "PSA", "C2PSA",
              "SCDown", "C2fCIB", "GhostConv", "Conv2", "ConvTranspose2d", "SPP",
              "RepNCSPELAN4", "ELAN1", "AConv", "ADown", "SPPELAN", "GhostBottleneck",
              "C3Ghost", "RepConv", "Classify", "C2fAttn"}
# subset that takes an inserted repeat count n
_REPEAT_ARG = {"C2", "C2f", "C3", "C3k", "C3k2", "C3k2_CBAM", "A2C2f", "DSC3k2", "DSC3k2_CBAM",
               "RepC3", "C2PSA", "C2fCIB", "C3Ghost", "C2fAttn"}
_C3K2_FAMILY = {"C3k2", "DSC3k2", "C3k2_CBAM", "DSC3k2_CBAM"}
# torch-layer yaml aliases -> module names
_NN_ALIAS = {"nn.ConvTranspose2d": "ConvTranspose2d", "nn.MaxPool2d": "MaxPool2d",
             "nn.ZeroPad2d": "ZeroPad2d", "nn.Identity": "Identity"}
TASK_BY_HEAD = {"Detect": "detect", "JDE": "jde", "v10Detect": "detect", "Pose": "pose",
                "Segment": "segment", "OBB": "obb", "Classify": "classify",
                "RTDETRDecoder": "detect", "WorldDetect": "detect"}
_WORLD = {"C2fAttn", "ImagePoolingAttn", "WorldDetect"}  # the modules that read the text rows
_HEADS = set(TASK_BY_HEAD) - {"Classify"}  # the multi-level heads; Classify is width-scaled
# modules whose output has the input's channels
_PASS_THROUGH = {"CBAM", "MaxPool2d", "Identity"}


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
        m = _NN_ALIAS.get(m, m)
        args = [_resolve_arg(a, names) for a in args]
        n = max(round(n * depth), 1) if n > 1 else n
        kwargs: dict[str, Any] = {}

        if m in _CH_SCALED:
            c2 = args[0]
            if m == "Classify":
                meta["head"] = m
                meta["head_index"] = i
            if not (m == "Classify" and c2 == nc):  # the class count is not width-scaled
                c2 = make_divisible(min(c2, max_channels) * width, 8)
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
            if m == "C2fAttn":  # the embed channels and head count scale too
                args[2] = make_divisible(min(args[2], max_channels // 2) * width, 8)
                args[3] = int(max(round(min(args[3], max_channels // 2 // 32)) * width, 1)
                              if args[3] > 1 else args[3])
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
        elif m == "AIFI":
            c2 = chs[f]  # args: [cm, num_heads]
        elif m in _HEADS:
            ch_list = tuple(chs[x] for x in f)
            kwargs["ch"] = ch_list
            kwargs["legacy"] = legacy
            if m == "Segment" and len(args) > 2:  # the proto channels npr are width-scaled
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
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
        elif m == "ImagePoolingAttn":  # updates the text rows; the first input passes through
            kwargs["ch"] = tuple(chs[x] for x in f)
            c2 = chs[f[0]]
        elif m == "HGStem":
            c2 = args[1]  # [cm, c2]
        elif m == "HGBlock":
            c2 = args[1]
            args.insert(3, n)  # (cm, c2, k, n, lightconv, shortcut)
            n = 1
        elif m == "ResNetLayer":
            # [c1, c2, s, is_first, n, (e)]: c2 is not width-scaled; the output is e * c2
            c2 = args[1] if args[3] else args[1] * (args[5] if len(args) > 5 else 4)
        elif m == "CBLinear":
            c2 = tuple(args[0])  # the chunk sizes, not width-scaled
            args = [c2, *args[1:]]
        elif m == "CBFuse":
            c2 = chs[f[-1]]
            args = [tuple(args[0])]
        elif m == "Index":
            c2 = args[0]
            args = [c2, args[1] if len(args) > 1 else 0]
        elif m == "ZeroPad2d":
            c2 = chs[f]
            args = [tuple(args[0])]
        elif m in _PASS_THROUGH:
            c2 = chs[f]
        else:
            raise NotImplementedError(f"layer {i}: module '{m}' is not part of this port yet")
        if n != 1:  # a plain module repeated n times (v3's Bottlenecks, v6's Convs)
            kwargs["repeat"] = n
            n = 1

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


# modules built as Module(c_in, *args): the input's channels, then the spec's args
_C_IN_FIRST = {"Conv": C.Conv, "DWConv": C.DWConv, "DSConv": C.DSConv, "CBAM": C.CBAM,
               "GhostConv": C.GhostConv, "Conv2": C.Conv2, "RepConv": C.RepConv,
               "ConvTranspose2d": C.ConvTranspose2d, "Bottleneck": B.Bottleneck, "C2": B.C2,
               "C2f": B.C2f, "C3": B.C3, "C3k": B.C3k, "C3k2": B.C3k2, "C3k2_CBAM": B.C3k2_CBAM,
               "C2PSA": B.C2PSA, "SPPF": B.SPPF, "A2C2f": B.A2C2f, "DSC3k2": B.DSC3k2,
               "DSC3k2_CBAM": B.DSC3k2_CBAM, "HyperACE": B.HyperACE, "PSA": B.PSA,
               "SCDown": B.SCDown, "C2fCIB": B.C2fCIB, "SPP": B.SPP, "GhostBottleneck":
               B.GhostBottleneck, "C3Ghost": B.C3Ghost, "RepNCSPELAN4": B.RepNCSPELAN4,
               "ELAN1": B.ELAN1, "AConv": B.AConv, "ADown": B.ADown, "SPPELAN": B.SPPELAN,
               "CBLinear": B.CBLinear, "HGStem": B.HGStem, "HGBlock": B.HGBlock,
               "RepC3": B.RepC3, "C2fAttn": B.C2fAttn}
# modules built from the spec's args alone
_ARGS_ONLY = {"Upsample": C.Upsample, "Concat": C.Concat, "DownsampleConv": B.DownsampleConv,
              "FullPAD_Tunnel": B.FullPAD_Tunnel, "Index": C.Index, "MaxPool2d": C.MaxPool2d,
              "ZeroPad2d": C.ZeroPad2d, "Identity": C.Identity, "CBFuse": B.CBFuse}


class Repeat(nn.Sequential):
    """n copies of one plain module in sequence, named as Flax names them (`Conv_0`, ...)."""

    def __init__(self, spec: LayerSpec, c_in, n: int):
        super().__init__()
        for j in range(n):
            m = _build_module(spec, c_in if j == 0 else spec.c2)
            self.add_module(f"{type(m).__name__}_{j}", m)


def _build_module(spec: LayerSpec, c_in, dropout: float = 0.0) -> nn.Module:
    """The torch module for a LayerSpec; c_in is its input channels (a tuple for lists);
    `dropout` is a Classify head's."""
    a, kw, name = spec.args, dict(spec.kwargs), spec.name
    n = kw.pop("repeat", None)
    if n:
        return Repeat(LayerSpec(spec.i, spec.f, name, a, spec.c2, tuple(sorted(kw.items()))),
                      c_in, n)
    if name in _C_IN_FIRST:
        return _C_IN_FIRST[name](c_in, *a)
    if name in _ARGS_ONLY:
        return _ARGS_ONLY[name](*a)
    if name == "ResNetLayer":  # the YAML's c1 (a[0]) is not the input's channels
        return B.ResNetLayer(c_in, *a[1:])
    if name == "Detect":
        return H.Detect(nc=a[0], ch=kw["ch"], legacy=kw["legacy"])
    if name == "v10Detect":  # the depthwise cls branch whatever `legacy` says, as in JAX
        return H.v10Detect(nc=a[0], ch=kw["ch"], legacy=False)
    if name == "JDE":
        return H.JDE(nc=a[0], embed_dim=a[1] if len(a) > 1 else 128,
                     state_classes=a[2] if len(a) > 2 else None,
                     ch=kw["ch"], legacy=kw["legacy"])
    if name == "Pose":
        return H.Pose(nc=a[0], kpt_shape=tuple(a[1]) if len(a) > 1 else (17, 3),
                      ch=kw["ch"], legacy=kw["legacy"])
    if name == "Segment":
        return H.Segment(nc=a[0], nm=a[1] if len(a) > 1 else 32, npr=a[2] if len(a) > 2 else 256,
                         ch=kw["ch"], legacy=kw["legacy"])
    if name == "OBB":
        return H.OBB(nc=a[0], ne=a[1] if len(a) > 1 else 1, ch=kw["ch"], legacy=kw["legacy"])
    if name == "Classify":  # a list input is concatenated on channels
        return H.Classify(sum(c_in) if isinstance(c_in, tuple) else c_in, a[0], dropout=dropout)
    if name == "AIFI":
        return T.AIFI(c_in, *a)
    if name == "RTDETRDecoder":  # tinyrtdetr-style trimmed args: [nc, hd, nq, ndl]
        extra = dict(zip(("hd", "nq", "ndl"), a[1:4]))
        return T.RTDETRDecoder(nc=a[0], ch=kw["ch"], **extra)
    if name == "ImagePoolingAttn":
        return B.ImagePoolingAttn(ec=a[0] if a else 256, ch=kw["ch"])
    if name == "WorldDetect":
        return H.WorldDetect(nc=a[0], embed_dim=a[1] if len(a) > 1 else 512,
                             with_bn=bool(a[2]) if len(a) > 2 else False,
                             ch=kw["ch"], legacy=kw["legacy"])
    raise NotImplementedError(f"module '{name}' is not part of this port yet")


class GraphModel(nn.Module):
    """Runs a parsed layer graph with an explicit save-dict; returns the head's per-level maps
    (a Segment head: the (maps, protos) pair; a Classify head: (B, nc) logits).

    `remat`: in train mode every block but the head runs under activation
    checkpointing (the JAX package's `nn.remat` per block): its activations are
    recomputed in the backward. The recomputation draws the same dropout masks
    and leaves the BN running statistics alone, so a step equals the plain one.
    """

    def __init__(self, specs: tuple, save: tuple, act: str = "silu", dropout: float = 0.0):
        super().__init__()
        self.specs, self.save = specs, frozenset(save)
        self.remat = False
        self.compute_dtype = torch.float32
        self.fused = False  # set by nn/fuse.py::fuse_model
        self.quant = ""     # "int8": the fused Convs run int8 (nn/modules/conv.py::quantize_int8)
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
                blocks.append(_build_module(s, c_in, dropout))
                outs.append(s.c2)
        self.blocks = nn.ModuleList(blocks)
        if any(s.name in _WORLD for s in specs):  # the text rows, (nc, E) until set_classes
            heads = [s for s in specs if s.name == "WorldDetect"]
            embed = heads[0].args[1] if heads and len(heads[0].args) > 1 else 512
            self.text_embeddings = nn.Parameter(torch.zeros(specs[-1].args[0], embed))

    def forward(self, x, batch_gt: dict | None = None, cdn_draws: dict | None = None,
                embed: tuple = ()):
        """The head's output; an RT-DETR head in train mode takes `batch_gt` and `cdn_draws`
        (`nn/modules/transformer.py::draw_cdn`) for its denoising queries. `embed` (layer
        indices): the mean over H and W of each listed layer's output, concatenated over
        the channels, (B, sum of C), returned after layer max(embed) without running the
        layers after it."""
        saved = {}
        embeds: list = []
        out = x
        last = self.specs[-1]
        txt = txt0 = getattr(self, "text_embeddings", None)
        if txt0 is not None:  # a copy: a view of the parameter would look like a leaf
            txt = txt0[None].repeat(x.shape[0], 1, 1)
        for spec, blk in zip(self.specs, self.blocks):
            f = spec.f
            if f == -1:
                inp = out
            elif isinstance(f, int):
                inp = saved[f]
            else:
                inp = [out if j == -1 else saved[j] for j in f]
            remat = self.remat and self.training and spec is not last
            run = (lambda *a: _checkpointed(blk, *a)) if remat else blk
            if spec is last and spec.name == "RTDETRDecoder" and batch_gt is not None:
                out = blk(inp, batch_gt, cdn_draws)
            elif spec.name == "C2fAttn":
                out = run(inp, txt)
            elif spec.name == "ImagePoolingAttn":
                txt, out = run(inp, txt), inp
            elif spec.name == "WorldDetect":
                out = blk(inp, txt0)
            else:
                out = run(inp)
            if spec.i in self.save:
                saved[spec.i] = out
            if embed and spec.i in embed:
                embeds.append(out.mean((2, 3)))
                if spec.i == max(embed):
                    return torch.cat(embeds, -1)
        return out


def _checkpointed(blk: nn.Module, *inp):
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

    return checkpoint(blk, *inp, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute()))


def build_model(name: str | dict, nc: int | None = None, dtype=torch.float32,
                kpt_shape: tuple | None = None, dropout: float = 0.0):
    """Build a GraphModel from a model name ('yolov13n-JDE.yaml') or a config dict (a
    checkpoint's `model_yaml`, the JAX package's included). Returns (model, meta).

    `nc` replaces the config's class count (the trainer builds the model for
    its dataset's), `kpt_shape` a pose config's keypoint shape (the trainer's, for a
    dataset whose keypoints differ, as Ultralytics rebuilds the head). `dtype` is the compute dtype (the JAX `build_model`'s
    `dtype`): parameters stay float32. `dropout`: a Classify head's (the trainer's
    `dropout`). The model is on the CPU, in eval mode,
    with torch's default weights until `init_weights` runs; meta["strides"]
    comes from a forward probe.
    """
    d = copy.deepcopy(name) if isinstance(name, dict) else model_config(name)
    if nc is not None:
        d["nc"] = nc
    if kpt_shape is not None:
        d["kpt_shape"] = list(kpt_shape)
    specs, save, meta = parse_model(d)
    meta["cfg"] = d
    meta["task"] = TASK_BY_HEAD[specs[-1].name]
    head = specs[-1]
    if head.name == "JDE":
        meta["embed_dim"] = head.args[1] if len(head.args) > 1 else 128
        meta["state_classes"] = head.args[2] if len(head.args) > 2 else None
    if head.name == "Pose":
        meta["kpt_shape"] = tuple(head.args[1]) if len(head.args) > 1 else (17, 3)
    if head.name == "Segment":
        meta["nm"] = head.args[1] if len(head.args) > 1 else 32
    model = GraphModel(specs, save, act=meta.get("act", "silu"), dropout=dropout).eval()
    C.set_compute_dtype(model, dtype)
    if head.name == "Classify":
        meta["strides"] = []
    elif head.name == "RTDETRDecoder":  # nominal: the decoder regresses normalized boxes
        meta["strides"] = [8, 16, 32]
    else:
        meta["strides"] = infer_strides(model)
    return model, meta


@torch.no_grad()
def infer_strides(model: GraphModel, imgsz: int = 64) -> list[int]:
    """Per-level strides from a forward probe on a zero image of side imgsz."""
    p = next(model.parameters())
    feats = model(torch.zeros(1, 3, imgsz, imgsz, dtype=p.dtype, device=p.device))
    if isinstance(feats, tuple):  # Segment: (maps, protos)
        feats = feats[0]
    return [imgsz // f.shape[2] for f in feats]


@torch.no_grad()
def init_weights(model: GraphModel, meta: dict, generator: torch.Generator):
    """Seeded initialization with the JAX package's initializers, then the head bias init.

    Conv kernels: uniform(+-1/sqrt(fan_in)); Linear: normal(0, 1/sqrt(fan_in)); biases 0;
    BN: identity statistics; FullPAD gate 0; A2C2f gamma 0.01;
    prototype_base: xavier uniform; LayerNorm: ones and zeros; Embed: normal(0,
    1/sqrt(rows)); World text rows: normal(0, 0.02); RT-DETR: score-head biases -4.6 and the
    deformable offsets' ring pattern. Draws on the CPU from `generator`.
    """
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
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
        elif isinstance(mod, T.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, T.Embed):
            n = mod.embedding.shape[0]
            mod.embedding.copy_(torch.randn(mod.embedding.shape, generator=generator) * n ** -0.5)
        elif isinstance(mod, B.MaxSigmoidAttnBlock):
            mod.bias.zero_()
    for mod in model.modules():  # after the Linear init above
        if isinstance(mod, T.RTDETRDecoder):
            mod.reset_heads()
        elif isinstance(mod, H.WorldDetect):
            for i in range(mod.nl):
                getattr(mod, f"cv4_{i}_bias").fill_(-10.0)
                getattr(mod, f"cv4_{i}_logit_scale").fill_(-1.0 if mod.with_bn else
                                                           math.log(1 / 0.07))
    if getattr(model, "text_embeddings", None) is not None:
        t = model.text_embeddings
        t.copy_(torch.randn(t.shape, generator=generator) * 0.02)
    bias_init_head(model, meta)


@torch.no_grad()
def bias_init_head(model: GraphModel, meta: dict):
    """Box pred bias -> 1.0; cls pred bias -> log(5 / nc / (640 / stride)^2), in both branch
    copies of a v10Detect. As in the JAX package, a Classify, RT-DETR or World head keeps its
    init."""
    head = model.blocks[meta["head_index"]]
    if isinstance(head, (H.Classify, H.WorldDetect, T.RTDETRDecoder)):
        return
    prefixes = ("", "o2o_") if isinstance(head, H.v10Detect) else ("",)
    for i, s in enumerate(meta["strides"]):
        for pre in prefixes:
            head._sub(f"{pre}cv2_{i}_pred").bias.fill_(1.0)
            head._sub(f"{pre}cv3_{i}_pred").bias.fill_(math.log(5 / meta["nc"] / (640 / s) ** 2))
