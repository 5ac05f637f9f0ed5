"""Area attention: the hand-written CUDA kernel, its plain PyTorch version and its build.

`flash_area_attention(q, k, v, num_heads, area)` has the contract of the JAX
package's `sar_yolo_tpu/ops/pallas/flash_attention.py::flash_area_attention`:
q, k, v are (B, N, C) with C = num_heads * 32; the N tokens split into `area`
contiguous chunks and attention runs inside each chunk, per head.

The function is the registered operator `torch.ops.sar_yolo_tpu_torch.flash_area_attention`
(`torch.library.custom_op`), so that `torch.export` keeps one node of it per call and an
exported program runs the kernel on the card:

* A CPU tensor goes through `area_attention_plain`.
* A CUDA tensor launches the kernel of `csrc/flash_area_attention.cu`, or
  raises. There is no fallback. Its products run on the tensor cores: split
  TF32 (three TF32 products per float32 product) for float32, bf16 for bfloat16.
* Under fake tensors (tracing, the `meta` device) the output is an empty tensor
  in the layout the kernel's launch gives: token-contiguous for views of NCHW maps.
* The backward recomputes through the plain version in the inputs' dtype (as
  the JAX package's custom VJP does); there is no backward kernel.
* `flash_area_attention.launches` counts kernel launches, and
  `flash_area_attention.launches_by_dtype` splits them into float32 and bfloat16.

The kernel is built with nvcc at first use into `sar_yolo_tpu_torch/build/`
(a plain C interface, loaded with ctypes) and cached there under a hash of its
sources and the nvcc command line.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from sar_yolo_tpu_torch.ops.cuda import nvcc

HEAD_DIM = 32
# the kernel's tiling (csrc/flash_area_attention.cu): query rows per warp, warps
# per block, row pitch of the staged K/V tiles, stages
_TQ, _WARPS, _PITCH, _STAGES = 16, 8, 136, 2
_SMS = 132  # H100 SXM
SOURCE = nvcc.CSRC / "flash_area_attention.cu"
_MAX_GRID_Z = 65535


def area_attention_plain(q, k, v, num_heads: int, area: int):
    """Plain PyTorch area attention (math of `sar_yolo_tpu/nn/modules/block.py::area_attention`)."""
    B, N, C = q.shape
    hd = C // num_heads
    Ba, Na = B * area, N // area
    q = q.reshape(Ba, Na, num_heads, hd)
    k = k.reshape(Ba, Na, num_heads, hd)
    v = v.reshape(Ba, Na, num_heads, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    attn = attn.float().softmax(-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, C)


def build() -> tuple[Path, str]:
    """Compile the kernel for sm_90a if its library is not built yet (`nvcc.build`).
    Returns (library path, compiler output, which holds ptxas's registers, shared
    memory and spills of each kernel)."""
    return nvcc.build(SOURCE)


class _Library:
    """The loaded kernel library (loaded once per process, on first launch)."""

    handle = None

    @classmethod
    def get(cls):
        if cls.handle is None:
            cls.load(build()[0])
        return cls.handle

    @classmethod
    def load(cls, path: Path):
        """Load the kernel library at `path` and use it from now on."""
        handle = ctypes.CDLL(str(path))
        for fn in (handle.flash_area_attention_f32, handle.flash_area_attention_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        handle.flash_area_attention_plan.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                 ctypes.POINTER(ctypes.c_int)]
        handle.flash_area_attention_plan.restype = None
        handle.flash_area_attention_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        handle.flash_area_attention_blocks_per_sm.restype = ctypes.c_int
        cls.handle = handle


def launch_geometry(shape, area: int, num_heads: int, strides, offsets, dtype) -> dict:
    """The kernel's launch geometry, a mirror of `plan()` in the .cu source.

    shape: (B, N, C); strides: the (batch, token, channel) strides of k and v;
    offsets: the element offsets of k's and v's first elements past a 16-byte
    boundary (their storage offsets, for storages that start on one).
    Returns the grid, the warps per block, the warps that split one query
    tile's keys, the staging copy width in bytes (16, 8 or 4: cp.async of
    token-contiguous K and V; 0: element copies) and the dynamic
    shared-memory bytes.
    """
    B, N, _ = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    na = N // area

    def fits(st, off, w):  # every chunk start of this tensor is w-byte aligned
        return st[1] == 1 and all(x * itemsize % w == 0 for x in (off, st[0], st[2], na))

    stage_bytes = next((w for w in (16, 8, 4)
                        if all(fits(st, off, w) for st, off in zip(strides, offsets))), 0)
    q_tiles = -(-na // _TQ)
    # 8 warps a block: the more query tiles, the more of them a block takes and
    # the fewer warps split one tile's keys
    tiles = q_tiles * num_heads * B * area
    splits = 1 if tiles >= 6 * _SMS else 2 if tiles >= 2 * _SMS else 4
    qt = _WARPS // splits
    smem = max(_STAGES * 2 * HEAD_DIM * _PITCH * itemsize, _WARPS * _TQ * (HEAD_DIM + 2) * 4)
    return {"grid": (-(-q_tiles // qt), num_heads, B * area), "warps": _WARPS, "splits": splits,
            "stage_bytes": stage_bytes, "smem_bytes": smem}


def geometry_of(q, k, v, num_heads: int, area: int) -> dict:
    """`launch_geometry` of these tensors."""
    return launch_geometry(q.shape, area, num_heads, (k.stride(), v.stride()),
                           [t.data_ptr() % 16 // t.element_size() for t in (k, v)], q.dtype)


def library_geometry(q, k, v, num_heads: int, area: int) -> dict:
    """The geometry that the built library's `plan()` gives these CUDA tensors."""
    out = (ctypes.c_int * 7)()
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride(), *q.stride())
    B, N, _ = q.shape
    _Library.get().flash_area_attention_plan(k.data_ptr(), v.data_ptr(), q.element_size(), B, N,
                                             area, num_heads, strides, out)
    return {"grid": tuple(out[:3]), "warps": out[3], "splits": out[4], "stage_bytes": out[5],
            "smem_bytes": out[6]}


def blocks_per_sm(geometry: dict, dtype) -> int:
    """Resident blocks per SM of the kernel launched with `geometry` (CUDA occupancy query)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _Library.get().flash_area_attention_blocks_per_sm(
        itemsize, geometry["stage_bytes"], geometry["warps"], geometry["smem_bytes"])


def _launch(q, k, v, num_heads: int, area: int):
    """Run the CUDA kernel on CUDA tensors; raise on anything it does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_area_attention: {name} is on {t.device}, "
                             f"expected the CUDA device of q ({q.device})")
        if t.dtype != q.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_area_attention: {name} has dtype {t.dtype}; "
                            "q, k, v must all be float32 or all bfloat16")
        if t.shape != q.shape or t.dim() != 3:
            raise ValueError(f"flash_area_attention: {name} has shape {tuple(t.shape)}, "
                             f"expected (B, N, C) equal to q's {tuple(q.shape)}")
        # one of the two inner axes must be unit-stride, so that neighbouring
        # threads read neighbouring addresses; token-contiguous K and V are
        # staged with cp.async as far as their alignment allows
        if t.stride(2) != 1 and t.stride(1) != 1:
            raise ValueError(f"flash_area_attention: {name} has strides {t.stride()}; "
                             "its channel or token axis must be contiguous")
    B, N, C = q.shape
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"flash_area_attention: C={C} with {num_heads} heads gives head dim "
                         f"{C / num_heads}; the kernel takes head dim {HEAD_DIM} only")
    if area < 1 or N % area or N == 0:
        raise ValueError(f"flash_area_attention: N={N} does not split into {area} areas")
    if max(B * area, num_heads) > _MAX_GRID_Z:
        raise ValueError(f"flash_area_attention: B*area={B * area} or heads={num_heads} "
                         f"exceeds the grid limit {_MAX_GRID_Z}")
    out = _empty_output(q)
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride(), *out.stride())
    lib = _Library.get()
    fn = lib.flash_area_attention_f32 if q.dtype == torch.float32 else \
        lib.flash_area_attention_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, N, area, num_heads, strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_area_attention: kernel launch failed with CUDA error {rc}")
    flash_area_attention.launches += 1
    flash_area_attention.launches_by_dtype[str(q.dtype).removeprefix("torch.")] += 1
    return out


def _empty_output(q):
    """The kernel's output for q: q's layout, token-contiguous for views of NCHW maps."""
    B, N, C = q.shape
    if q.stride(1) == 1 and q.stride(2) != 1:
        return q.new_empty((B, C, N)).transpose(1, 2)
    return q.new_empty((B, N, C))


@torch.library.custom_op("sar_yolo_tpu_torch::flash_area_attention", mutates_args=(),
                         device_types="cpu")
def _area_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                       area: int) -> torch.Tensor:
    return _empty_output(q).copy_(area_attention_plain(q, k, v, num_heads, area))


_area_attention_op.register_kernel("cuda")(_launch)
_area_attention_op.register_fake(lambda q, k, v, num_heads, area: _empty_output(q))


def _save_inputs(ctx, inputs, output):
    q, k, v, ctx.num_heads, ctx.area = inputs
    ctx.save_for_backward(q, k, v)


def _backward(ctx, grad):
    q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
    with torch.enable_grad():
        out = area_attention_plain(q, k, v, ctx.num_heads, ctx.area)
    gq, gk, gv = torch.autograd.grad(out, (q, k, v), grad)
    return gq, gk, gv, None, None


_area_attention_op.register_autograd(_backward, setup_context=_save_inputs)


def flash_area_attention(q, k, v, num_heads: int, area: int = 1):
    """Area attention on (B, N, C) tensors: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Returns (B, N, C)."""
    return _area_attention_op(q, k, v, num_heads, area)


def reset_launches():
    """Set the launch counts (the total and each dtype's) to 0."""
    flash_area_attention.launches = 0
    flash_area_attention.launches_by_dtype = {"float32": 0, "bfloat16": 0}


reset_launches()  # kernel launches in this process
