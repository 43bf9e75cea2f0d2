"""Process groups and the collectives of data parallelism and sharded tiling
(port of ``ssdn_tpu/parallel/__init__.py``).

The JAX package runs one process over a device mesh: a 1-D ``data`` axis
for DP training (XLA derives the gradient all-reduce from the batch's
sharding) and a ``tile`` view of the same devices for sharded tiled
inference. The PyTorch idiom is one process per card, launched by
``torchrun``, joined by a ``torch.distributed`` process group. Where the JAX
API takes ``mesh``, the port takes a ``Group`` (``None``: no distribution),
and the collectives XLA would derive are written out here:

  * ``shard_rows``     the rank's rows of a global batch (``put_batch``);
  * ``mean_grads_``    the gradient psum of ``jit_data_parallel``;
  * ``broadcast_tree_`` the replication of ``replicated`` (rank 0's copy);
  * ``pmean``          ``lax.pmean``;
  * ``all_gather_w``   ``lax.all_gather(..., tiled=True)`` on the W axis;
  * ``ppermute``       ``lax.ppermute``.

Every rank calls every collective in the same order; none of them sits in a
branch that only some ranks take.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ssdn_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the default process group: its ``rank`` of
    ``world``, the ``device`` its tensors live on, and the ``backend``
    ("nccl" or "gloo") that carries them."""

    rank: int
    world: int
    device: torch.device
    backend: str


def init_group(device=None, backend: Optional[str] = None, *,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               init_method: Optional[str] = None) -> Group:
    """Join (or form) the default process group and return this rank's
    ``Group``.

    Reads ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; without
    them it forms a group of world size 1 in this process, as ``make_mesh``
    does with one device. ``device`` defaults to the card (``cuda:LOCAL_RANK``;
    raises without one) and "cuda" without an index means the same;
    ``device="cpu"`` runs on the CPU. ``backend`` defaults to "nccl" on a
    card and "gloo" on the CPU; "gloo" with a CUDA device puts several ranks
    on one card (NCCL refuses two ranks on one GPU). ``init_method``
    defaults to torchrun's ``env://`` (a ``file://`` path also works). If the
    default group already exists it is reused.
    """
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "RANK" in os.environ or init_method is not None:
            dist.init_process_group(
                backend, init_method=init_method or "env://",
                rank=int(os.environ["RANK"]),
                world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout)
        else:
            # no launcher: a group of one, its store in this process
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout)
    group = Group(rank=dist.get_rank(), world=dist.get_world_size(),
                  device=dev, backend=dist.get_backend())
    # the first collective forms the communicators on every rank at once
    # (NCCL's first point-to-point batch must include every rank)
    dist.all_reduce(torch.zeros(1, device=dev))
    return group


def destroy_group() -> None:
    """Leave the default process group (no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(group: Optional[Group]) -> None:
    """Wait for every rank (no-op without a group). An all-reduce rather
    than ``dist.barrier``, which NCCL runs on a device of its own guess."""
    if group is not None:
        dist.all_reduce(torch.zeros(1, device=group.device))


def shard_rows(batch, group: Optional[Group]):
    """The rank's rows of a global batch (``put_batch``'s sharding on the
    leading axis): rows ``[rank * B/n, (rank + 1) * B/n)``. Raises
    ValueError unless the batch divides by the world size, as JAX's
    sharding does."""
    if group is None:
        return batch
    b = batch.shape[0]
    if b % group.world:
        raise ValueError(
            f"batch of {b} rows does not divide over {group.world} ranks")
    k = b // group.world
    return batch[group.rank * k:(group.rank + 1) * k]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _by_dtype(leaves: Sequence[torch.Tensor]):
    groups = {}
    for t in leaves:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def mean_grads_(grads, group: Optional[Group]):
    """Average a gradient tree over the ranks, in place: one flattened
    ``all_reduce`` (SUM, then / world) per dtype. This is the gradient psum
    XLA derives from ``jit_data_parallel``'s shardings. It is written out
    rather than taken from ``nn.parallel.DistributedDataParallel``: the
    port's params are a functional ``{layer: {"w", "b"}}`` tree updated by
    ``TrainStep.apply_grads``, not an ``nn.Module`` whose backward hooks DDP
    could attach to. Returns ``grads``."""
    if group is None:
        return grads
    for leaves in _by_dtype(_leaves(grads)):
        flat = torch.cat([t.reshape(-1) for t in leaves])
        dist.all_reduce(flat)
        flat /= group.world
        o = 0
        for t in leaves:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()
    return grads


def broadcast_tree_(tree, group: Optional[Group], src: int = 0):
    """Overwrite every leaf of a (nested dict) tensor tree with rank
    ``src``'s, in place: one flattened broadcast per dtype. Returns
    ``tree``."""
    if group is None or group.world == 1:
        return tree
    for leaves in _by_dtype(_leaves(tree)):
        flat = torch.cat([t.reshape(-1) for t in leaves])
        dist.broadcast(flat, src)
        o = 0
        for t in leaves:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()
    return tree


def pmean(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """``lax.pmean``: the mean of ``t`` over the ranks (a new tensor)."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / group.world


def all_gather_w(strip: torch.Tensor, group: Optional[Group],
                 dim: int = -2) -> torch.Tensor:
    """Every rank's strip, concatenated in rank order on ``dim`` (the W axis
    of an NHWC tensor by default): ``lax.all_gather(tiled=True)``. Strips
    must have equal shapes."""
    if group is None:
        return strip
    strip = strip.contiguous()
    parts = [torch.empty_like(strip) for _ in range(group.world)]
    dist.all_gather(parts, strip)
    return torch.cat(parts, dim=dim)


def ppermute(t: torch.Tensor, pairs: Iterable[Tuple[int, int]],
             group: Group) -> torch.Tensor:
    """``lax.ppermute``: every (source, destination) pair sends the source
    rank's ``t`` to the destination; a rank that no pair sends to gets
    zeros of ``t``'s shape, dtype and device. A self-pair is a local copy.
    The rank's sends and receive go as one ``dist.batch_isend_irecv``
    (skipped when it has none); slices are made contiguous first.

    gloo's send and receive take CPU tensors only, so on a gloo group a
    CUDA tensor is staged through host memory here, and only here: the
    other collectives of this module take CUDA tensors on gloo as they
    are."""
    rank = group.rank
    out = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
    stage = group.backend == "gloo" and t.device.type != "cpu"
    send = t.contiguous().cpu() if stage else t.contiguous()
    recv = torch.zeros(t.shape, dtype=t.dtype) if stage else out
    ops, got = [], False
    for src, dst in pairs:
        if src == rank and dst == rank:
            out.copy_(t)
        elif src == rank:
            ops.append(dist.P2POp(dist.isend, send, dst))
        elif dst == rank:
            ops.append(dist.P2POp(dist.irecv, recv, src))
            got = True
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if stage and got:
        out.copy_(recv)
    return out
