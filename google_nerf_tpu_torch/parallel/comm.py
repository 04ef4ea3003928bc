"""Collective helpers on torch.distributed (port of
google_nerf_tpu/parallel/comm.py; the reference's LeReS
`Train/lib/utils/comm.py:12-116`).

One process a device, in a process group (parallel/dp.py).  Without a
group every helper answers for a world of one, as JAX's single-host
answers do: world size 1, rank 0, the main process, no barrier.

`all_gather_cat` is the gather of a sharded output onto every rank.
gloo has no all_gather of CUDA tensors (two ranks sharing one card run
over gloo: NCCL refuses two ranks on one device), so there each rank
writes its rows into its slot of a zero buffer and one SUM all-reduce
adds the slots: exact, since every element has one non-zero term.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize(group=None) -> None:
    """A barrier across the group's ranks (`comm.py:32-44`); a no-op at
    world 1."""
    if get_world_size(group) > 1:
        dist.barrier(group=group)


def all_gather_objects(obj: Any, group=None) -> list:
    """Every rank's picklable `obj`, in rank order, on every rank
    (`comm.py:47-87`)."""
    n = get_world_size(group)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def _comm_device(group=None) -> torch.device:
    """The device a collective of the group takes its tensors on."""
    if initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(d: Dict[str, Any], average: bool = True,
                group=None) -> Dict[str, torch.Tensor]:
    """Sum (or mean, `average`) of a dict of scalars over the group's
    ranks, all of them in one all-reduce (`comm.py:90-116`).  Values
    become float32 tensors on the first tensor's device (the backend's
    where there is none)."""
    keys = list(d)
    dev = next((v.device for v in d.values() if torch.is_tensor(v)),
               _comm_device(group))
    vals = torch.stack([torch.as_tensor(d[k], dtype=torch.float32,
                                        device=dev).reshape(())
                        for k in keys])
    n = get_world_size(group)
    if n > 1:
        dist.all_reduce(vals, group=group)
        if average:
            vals = vals / n
    return dict(zip(keys, vals.unbind()))


def reduce_loss_dict(losses: Dict[str, Any],
                     group=None) -> Dict[str, torch.Tensor]:
    """The trainer's logging reduction (`Train/tools/train.py:79-101`):
    the mean over the ranks."""
    return reduce_dict(losses, average=True, group=group)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group's ranks, whose backward is the sum of the
    ranks' gradients (every rank's output is the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the group's ranks, differentiably (SyncBN's
    statistics); x itself without a group."""
    if not initialized():
        return x
    return _AllReduceSum.apply(x, group)


_SUM_EXACT = (torch.float32, torch.float64, torch.int32, torch.int64)


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x (one shape on every rank) concatenated along dim 0
    in rank order, on every rank."""
    n = get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        # a zero buffer with this rank's slot filled, summed over the
        # ranks; narrow types take a wider one (the sum stays exact)
        wide = x.dtype if x.dtype in _SUM_EXACT else (
            torch.float32 if x.dtype.is_floating_point else torch.int64)
        buf = torch.zeros((n,) + tuple(x.shape), dtype=wide,
                          device=x.device)
        buf[get_rank(group)] = x
        dist.all_reduce(buf, group=group)
        return buf.to(x.dtype).reshape((n * x.shape[0],)
                                       + tuple(x.shape[1:]))
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank src's t into every rank's t, in place.  A tensor off the
    backend's device travels through a copy; a bool tensor as bytes."""
    if get_world_size(group) == 1:
        return t
    work = t.view(torch.uint8) if t.dtype == torch.bool else t
    dev = _comm_device(group) if dist.get_backend(group) == "nccl" \
        else work.device
    if work.device == dev and work.is_contiguous():
        dist.broadcast(work, src, group=group)
    else:
        tmp = work.to(dev).contiguous()
        dist.broadcast(tmp, src, group=group)
        work.copy_(tmp)
    return t
