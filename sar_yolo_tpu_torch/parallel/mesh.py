"""Device meshes and data parallelism, one process per device (port of
`sar_yolo_tpu/parallel/mesh.py`).

The JAX package runs the whole train step as one SPMD program over a `dp` mesh of the
devices one process sees. PyTorch's idiom for that is one process per device, as the
reference fork does it (Ultralytics re-executes itself under `torch.distributed.run` and
wraps the model in DistributedDataParallel): each rank holds a replica, loads its
`B / W` rows of every global batch, and the step stays the global batch's step:

* train-mode BatchNorm reduces sum(x), sum(x^2) and the count over every rank
  (`nn/modules/conv.py::BatchNorm2d`), as the JAX package's BN reduces over the sharded
  global batch;
* the loss is the global batch's: the head outputs and the labels are gathered with
  autograd and every rank computes the task's loss on all of them (`engine/trainer.py`);
* DDP averages the gradients (each rank's is W times its share of the global one).

The model's own collectives (BatchNorm's and the loss's gathers) run in a process group of
their own (`model_group`), so that their order never meets DDP's bucketed all-reduces of
the default group.

`init_distributed` reads torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), or takes the address, rank and world size: NCCL for CUDA devices, gloo for
the CPU. `spawn` starts one process per device with torch.multiprocessing (each joins a
group at tcp://127.0.0.1:<free port>) and returns rank 0's result: `YOLO.train(mesh_shape=
[N])` uses it when no process group exists.

Serving and validation need no processes: one process holds a replica of the fused model
on each mesh device, splits the batch and concatenates the outputs in order
(`engine/predictor.py`, `engine/validator.py`).
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

_MODEL_GROUP = [None]  # the model's collectives: every rank of the default group


def mesh_devices_count(mesh_shape) -> int:
    """The data-parallel size of `mesh_shape` ([dp] or [dp, 1]); a `tp` axis over 1
    raises: it would shard the convolutions (FSDP2 over a `tp` sub-mesh, ROADMAP Queue A)."""
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) > 1 and math.prod(shape[1:]) > 1:
        raise NotImplementedError(f"mesh_shape {list(shape)}: a tp axis (sharded convolutions, "
                                  "FSDP2 over a tp sub-mesh) is not part of this port yet; "
                                  "see ROADMAP.md Queue A")
    return shape[0] if shape else 1


def get_mesh(mesh_shape=None, devices=None) -> list[torch.device]:
    """The devices of a `mesh_shape` mesh (a list of torch.devices): by default the visible
    CUDA devices. Raises ValueError where the mesh needs more devices than exist."""
    devices = list(devices) if devices is not None else \
        [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices) if mesh_shape is None else mesh_devices_count(mesh_shape)
    if n > len(devices):
        raise ValueError(f"mesh_shape {list(mesh_shape)} needs {n} devices, have {len(devices)}")
    return devices[:n]


def model_mesh(mesh_shape, device) -> list[torch.device]:
    """The mesh of a model on `device`: the visible CUDA devices for a CUDA model; for a
    CPU model, the CPU once per mesh device (as the JAX package's virtual CPU devices)."""
    device = torch.device(device)
    if device.type == "cpu":
        return get_mesh(mesh_shape, [device] * mesh_devices_count(mesh_shape))
    return get_mesh(mesh_shape)


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device="cpu", backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None) -> tuple[int, int]:
    """Join the default process group, from torchrun's environment or the arguments, and make
    the model's group. NCCL for a CUDA device, gloo for the CPU, unless `backend` says.
    A no-op where a group exists or the world is one process. Returns (rank, world size)."""
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0) if rank is None else rank)
        world_size = int(os.environ.get("WORLD_SIZE", 1) if world_size is None else world_size)
        if world_size <= 1 and init_method is None:
            return 0, 1
        backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    model_group()
    return rank_and_world()


def model_group():
    """The process group of the model's collectives (all ranks; made once, collectively)."""
    if _MODEL_GROUP[0] is None and dist.is_initialized():
        _MODEL_GROUP[0] = dist.new_group(backend=dist.get_backend())
    return _MODEL_GROUP[0]


def destroy():
    """Leave the process group (and drop the model's)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _MODEL_GROUP[0] = None


_CLOCK = [None]  # while `timed_collectives` runs: the seconds of each forward collective


@contextlib.contextmanager
def timed_collectives():
    """While active, each forward collective of the model (BatchNorm's all-reduce, the loss's
    gathers) runs between two device synchronizations and appends its seconds to the list
    this yields (their backward collectives and DDP's gradient all-reduce are not timed)."""
    _CLOCK[0] = seconds = []
    try:
        yield seconds
    finally:
        _CLOCK[0] = None


def _clocked(fn, x):
    if _CLOCK[0] is None:
        return fn(x)
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn(x)
    sync()
    _CLOCK[0].append(time.perf_counter() - t0)
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the ranks, with autograd (the gradient of each rank's input is the sum
    of every rank's output gradient)."""
    from torch.distributed.nn.functional import all_reduce
    return _clocked(lambda t: all_reduce(t, group=model_group()), x)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: the collectives behind
    `all_gather`'s backward write into buffers shaped like the incoming gradients as if they
    were contiguous (a channels-last gradient of a head map came back scrambled)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in rank order, with autograd (the gradient of
    each rank's rows is the sum of every rank's gradient of them)."""
    from torch.distributed.nn.functional import all_gather
    parts = _clocked(lambda t: all_gather(t.contiguous(), group=model_group()), x)
    return torch.cat([_ContiguousGrad.apply(p) for p in parts], 0)


def gather_tree(tree, batch_dim=lambda t: 0):
    """`gather_rows` of every tensor leaf of a nested list / tuple / dict along the dim that
    `batch_dim(leaf)` names (None: a leaf without a batch dim, kept as it is)."""
    if isinstance(tree, torch.Tensor):
        d = batch_dim(tree)
        return tree if d is None else gather_rows(tree.movedim(d, 0)).movedim(0, d)
    if isinstance(tree, dict):
        return {k: gather_tree(v, batch_dim) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, batch_dim) for v in tree)
    return tree


def local_rows(n_global: int) -> slice:
    """This rank's rows of a global batch of n_global (contiguous, rank order)."""
    rank, world = rank_and_world()
    if n_global % world:
        raise ValueError(f"a batch of {n_global} does not split over {world} ranks")
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)


def process_shard(n_samples: int, shuffle_seed=None) -> np.ndarray:
    """The sample indices this rank owns (the JAX package's per-process split): a
    contiguous ceil(n / W) share, the tail padded by wrap-around so every rank gets as
    many."""
    rank, world = rank_and_world()
    per = -(-n_samples // world)
    idx = np.arange(n_samples)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(idx)
    idx = np.concatenate([idx, idx[: per * world - n_samples]])
    return idx[rank * per: (rank + 1) * per]


def shard_batch(batch: dict) -> dict:
    """This rank's rows of every leaf of a global batch dict (numpy arrays or tensors) that
    has the batch's length; other leaves as they are."""
    n = len(next(v for v in batch.values() if hasattr(v, "shape") and len(v.shape)))
    rows = local_rows(n)
    return {k: v[rows] if hasattr(v, "shape") and len(v.shape) and len(v) == n else v
            for k, v in batch.items()}


def host_local_batch_to_global(batch: dict) -> dict:
    """Every rank's batch dict concatenated along dim 0 (an all-gather over the default
    group; numpy leaves come back as numpy)."""
    if rank_and_world()[1] == 1:
        return batch
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        cat = torch.cat(parts, 0)
        out[k] = cat.cpu().numpy() if isinstance(v, np.ndarray) else cat
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Broadcast every parameter and buffer of `module` from rank `src`, in place."""
    if rank_and_world()[1] > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)
    return module


def sync_flag(value: bool) -> bool:
    """Whether any rank says True (an all-reduce of the maximum over the default group)."""
    if rank_and_world()[1] == 1:
        return bool(value)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    flag = torch.tensor([1.0 if value else 0.0], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item() > 0)


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _precision() -> dict:
    """The numerics switches a spawned rank takes from its parent (TF32, cuDNN's
    determinism and autotuning, float32 matmul precision)."""
    return {"cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "deterministic": torch.backends.cudnn.deterministic,
            "benchmark": torch.backends.cudnn.benchmark,
            "matmul_precision": torch.get_float32_matmul_precision()}


def _rank_main(rank: int, fn, args: tuple, devices: list, backend, port: int, threads: int,
               precision: dict, queue):
    """One spawned rank: its threads, numerics switches and device, the group,
    fn(rank, device, *args); rank 0 sends its result (torch.save'd) or every rank its
    traceback."""
    torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32 = precision["cudnn_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = precision["matmul_tf32"]
    torch.backends.cudnn.deterministic = precision["deterministic"]
    torch.backends.cudnn.benchmark = precision["benchmark"]
    torch.set_float32_matmul_precision(precision["matmul_precision"])
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        init_distributed(device, backend, f"tcp://127.0.0.1:{port}", rank, len(devices))
        out = fn(rank, device, *args)
        if rank == 0:
            buf = io.BytesIO()
            torch.save(out, buf)
            queue.put(("ok", buf.getvalue()))
    except BaseException:
        queue.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        destroy()


def spawn(fn, args: tuple = (), devices=None, backend: str | None = None):
    """Run fn(rank, device, *args) in one new process per device of `devices` (default: the
    visible CUDA devices), joined in one process group (NCCL for CUDA devices, gloo for the
    CPU, unless `backend` says), each with this process's TF32, cuDNN and matmul-precision
    switches; returns rank 0's result (loaded on the CPU). `fn` must be a module-level
    function; a failure in any rank raises here with its traceback."""
    import torch.multiprocessing as mp
    devices = [str(d) for d in (devices if devices is not None else get_mesh())]
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    threads = max(1, torch.get_num_threads() // len(devices))
    procs = mp.start_processes(_rank_main, args=(fn, args, devices, backend, free_port(), threads,
                                                 _precision(), queue),
                               nprocs=len(devices), join=False, start_method="spawn")
    result, errors = None, []

    def drain():
        nonlocal result
        while not queue.empty():
            kind, payload = queue.get()
            if kind == "ok":
                result = torch.load(io.BytesIO(payload), map_location="cpu", weights_only=False)
            else:
                errors.append(payload)
    try:
        while not procs.join(timeout=0.5):
            drain()
    except Exception as e:
        drain()
        raise RuntimeError("a spawned rank failed:\n" + "\n".join(errors or [str(e)])) from e
    drain()
    if errors:
        raise RuntimeError("a spawned rank failed:\n" + "\n".join(errors))
    return result
