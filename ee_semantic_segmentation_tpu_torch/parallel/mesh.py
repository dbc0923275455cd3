"""Data parallelism over several GPUs: the process group, batch shards and
the collectives of the data-parallel path.

Port of ``ee_semantic_segmentation_tpu/parallel/mesh.py``.  The JAX
package runs one program over a mesh of chips and lets GSPMD insert the
collectives; here each GPU is one process (launched by ``torchrun``, that
is ``python -m torch.distributed.run``), and every collective is an
explicit call in this module on the process group of a :class:`DataMesh`,
NCCL on the card and gloo on the CPU.  The names follow the JAX module:

* :func:`initialize_multihost` joins the process group (the counterpart of
  ``jax.distributed.initialize``) and returns the mesh, or None for a
  plain single process;
* :func:`make_mesh` is the mesh of an existing group; :func:`make_mesh_2d`
  with ``sp > 1`` (height sharding) raises: it is ROADMAP.md item A6b;
* :func:`shard_batch` takes this rank's rows of a host batch and
  :func:`replicate` broadcasts a module's parameters and buffers from
  rank 0.

Which rows of a batch a rank holds is decided here only
(:func:`row_blocks`): contiguous blocks in rank order.  Training splits a
global batch of B as it is, the first ``B % W`` ranks taking one row more,
so a block may be empty (padding would change the loss); the evaluators
and the masked engine pad it first to a multiple of W with repeats of its
last row, as the JAX package's ``_pad_to_devices`` does, and mask the
padded rows through ``count``.  Concatenating the blocks in rank order
gives the batch back, and the global-batch quantities (BatchNorm
statistics, losses, gradients, confusion counts) are built on that order.
Every rank computes every rank's block from the batch's size, so no
collective is spent on sizes.

Every collective adds one to ``COLLECTIVES[kind]`` where it is issued, so
a caller can check that a data-parallel path really communicated.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVES: Counter = Counter()
LAUNCHER_ENV = ("RANK", "WORLD_SIZE")
A6B = ("height sharding (sp > 1) is ROADMAP.md item A6b: it needs hand-written halo "
       "exchanges for every conv and pool")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A data-parallel group: its process group, world size, this process's
    rank and the device its tensors live on."""

    group: object
    world: int
    rank: int
    device: torch.device

    @property
    def primary(self) -> bool:
        return self.rank == 0


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def is_primary() -> bool:
    """True unless this process is a rank other than 0 of an initialized
    process group: only the primary process writes files and logs."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def initialize_multihost(init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None, *, device: str = "cuda",
                         timeout: datetime.timedelta | None = None) -> DataMesh | None:
    """Join the process group and return its :class:`DataMesh`.

    Explicit arguments, or a launcher's environment (``RANK`` and
    ``WORLD_SIZE``, with ``MASTER_ADDR``/``MASTER_PORT`` for the default
    ``env://`` rendezvous and ``LOCAL_RANK`` for the GPU), mean the caller
    intends several processes, so a failure raises; nothing falls back to
    one process.  With neither this is a single-process no-op and returns
    None: no process group, and every caller takes its one-process path.

    ``device`` is "cuda" (NCCL, the rank's GPU ``cuda:LOCAL_RANK``) or
    "cpu" (gloo); CUDA that is absent raises.  An initialized group is
    reused."""
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if not (explicit or launched()):
        return None
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass --device cpu to run "
                           "the data-parallel path on the CPU (gloo)")
    if not dist.is_initialized():
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=init_method or "env://",
                                world_size=world_size, rank=rank, **kw)
    return make_mesh()


def make_mesh() -> DataMesh:
    """The mesh of the default process group, which must be initialized."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost first")
    group = dist.group.WORLD
    nccl = dist.get_backend(group) == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return DataMesh(group, dist.get_world_size(group), dist.get_rank(group), device)


def make_mesh_2d(sp: int = 1) -> DataMesh:
    """The ('data', 'space') mesh: only ``sp == 1``, pure data parallelism."""
    if sp > 1:
        raise NotImplementedError(f"make_mesh_2d(sp={sp}): {A6B}")
    return make_mesh()


def space_size(mesh) -> int:
    """Size of the 'space' axis: 1, the port shards no image height."""
    return 1


def row_blocks(n: int, world: int, pad: bool = False) -> list[tuple[int, int]]:
    """[start, stop) of every rank's rows of a batch of n, in rank order.
    Without ``pad`` the first ``n % world`` blocks have one row more (a
    block may be empty); with ``pad`` every block has ``ceil(n / world)``
    rows of the batch padded with repeats of its last row, so the last
    stops may pass n."""
    if pad:
        m = -(-n // world)
        return [(r * m, (r + 1) * m) for r in range(world)]
    base, extra = divmod(n, world)
    starts = [r * base + min(r, extra) for r in range(world + 1)]
    return list(zip(starts[:-1], starts[1:]))


def block_counts(n: int, count: int, world: int, pad: bool = False) -> list[int]:
    """How many of every rank's rows (:func:`row_blocks`) lie before
    ``count``, the batch's valid rows."""
    return [min(max(count - a, 0), b - a) for a, b in row_blocks(n, world, pad)]


def shard_rows(n: int, mesh: DataMesh, pad: bool = False) -> tuple[int, int]:
    """[start, stop) of this rank's rows of a batch of n."""
    return row_blocks(n, mesh.world, pad)[mesh.rank]


def _take_rows(x, start: int, stop: int):
    """Rows [start, stop) of x, rows past its end repeating its last row."""
    n = x.shape[0]
    rows = x[min(start, n):min(stop, n)]
    extra = stop - max(start, n)
    if extra <= 0:
        return rows
    if isinstance(x, torch.Tensor):
        return torch.cat([rows, x[-1:].expand(extra, *x.shape[1:])])
    return np.concatenate([rows, np.repeat(x[-1:], extra, axis=0)])


def shard_batch(mesh: DataMesh, batch, pad: bool = False):
    """This rank's rows (:func:`shard_rows`) of a host batch: a dict, tuple
    or list of arrays (numpy or tensors) with the batch on their first
    axis, or one array.  0-d entries and non-arrays pass through, except a
    dict's ``count`` of valid rows (all rows if it has none), which becomes
    this rank's (:func:`block_counts`)."""
    items = (list(batch.values()) if isinstance(batch, dict)
             else list(batch) if isinstance(batch, (tuple, list)) else [batch])
    n = next(x.shape[0] for x in items if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim)
    start, stop = shard_rows(n, mesh, pad)

    def take(x):
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
            return _take_rows(x, start, stop)
        return x

    if isinstance(batch, dict):
        out = type(batch)({k: take(v) for k, v in batch.items()})
        out["count"] = block_counts(n, int(batch.get("count", n)), mesh.world, pad)[mesh.rank]
        return out
    if isinstance(batch, (tuple, list)):
        return type(batch)(take(v) for v in batch)
    return take(batch)


def replicate(module: torch.nn.Module, mesh: DataMesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, so every
    rank starts from the same weights; returns the module."""
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            COLLECTIVES["broadcast"] += 1
            dist.broadcast(t.data, src=src, group=mesh.group)
    return module


def barrier(mesh: DataMesh) -> None:
    COLLECTIVES["barrier"] += 1
    if mesh.device.type == "cuda":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def all_reduce(t: torch.Tensor, mesh: DataMesh, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks (sum, max or min), in place; returns it."""
    COLLECTIVES["all_reduce"] += 1
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    dist.all_reduce(t, op=ops[op], group=mesh.group)
    return t


def _gather_list(t: torch.Tensor, mesh: DataMesh) -> list[torch.Tensor]:
    COLLECTIVES["all_gather"] += 1
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(out, t, group=mesh.group)
    return out


def all_gather(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """(W, *t.shape): every rank's ``t`` (equal shapes), in rank order."""
    return torch.stack(_gather_list(t, mesh))


def all_gather_dim(t: torch.Tensor, mesh: DataMesh, sizes: list[int], dim: int = -1):
    """Every rank's ``t`` concatenated along ``dim`` in rank order, where
    rank r's extent along ``dim`` is ``sizes[r]`` (ragged: padded to the
    largest for the collective and trimmed after)."""
    dim = dim % t.ndim
    width = max(sizes)
    if t.shape[dim] < width:
        pad = list(t.shape)
        pad[dim] = width - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    parts = _gather_list(t, mesh)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)


class _GlobalSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the ranks.  Backward: the incoming
    gradient unchanged.  Every rank holds the same global value and the
    same gradient of it, so d(global)/d(x_r) is that gradient on rank r;
    the summed parameter gradients are then those of the global value."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable (identity backward); ``x``
    itself without a mesh."""
    return x if mesh is None else _GlobalSum.apply(x, mesh)


class _GatherCols(torch.autograd.Function):
    """Forward: every rank's columns concatenated in rank order.  Backward:
    this rank's columns of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, mesh, sizes):
        ctx.span = (sum(sizes[: mesh.rank]), sizes[mesh.rank])
        return all_gather_dim(x, mesh, sizes, dim=-1)

    @staticmethod
    def backward(ctx, g):
        start, n = ctx.span
        return g.narrow(-1, start, n), None, None


def gather_cols(x: torch.Tensor, mesh: DataMesh, sizes: list[int]) -> torch.Tensor:
    """Differentiable :func:`all_gather_dim` along the last axis."""
    return _GatherCols.apply(x, mesh, sizes)


def all_reduce_grads(params, mesh: DataMesh) -> None:
    """Sum the gradients of ``params`` over the ranks, one all-reduce per
    dtype over a flat buffer.  Every rank runs the same graph (an empty
    shard included), so the same parameters have gradients on every rank;
    one without (frozen, or on an exit the loss leaves out) is skipped, as
    the optimizer skips it."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
