"""Multi-process runtime on ``torch.distributed``.

Port of navc_tpu/parallel/distributed.py. navc_tpu runs one JAX process per
host, each driving several devices under GSPMD; the port runs one process
(rank) per device:

  * ``initialize()`` joins or forms the process group: NCCL for ranks on
    the card, gloo for ranks on the CPU (``backend`` overrides it, e.g.
    gloo for two ranks on one card, which NCCL refuses). Rank r works on
    ``cuda:(r % torch.cuda.device_count())`` (``rank_device``), or on the
    CPU when asked;
  * ``process_index`` / ``process_count`` / ``is_primary`` /
    ``primary_only``: without a process group 0 / 1 / True;
  * the collectives the rest of the port calls: ``all_reduce_`` (in
    place), ``all_reduce`` (differentiable: its backward all-reduces the
    gradient, as GSPMD's transpose of a sum does), ``all_gather``,
    ``broadcast_flag``, ``barrier``. ``COLLECTIVES`` counts them by kind.
    On a gloo group a tensor on the card goes through the host (gloo
    reduces there).

navc_tpu's ``jax_cpu_collectives_implementation`` setting and
``make_global_batch`` have no counterpart: gloo is a backend of
torch.distributed itself, and nothing assembles one global array: a
rank's local batch is its part of the global batch.
"""

from __future__ import annotations

import collections
import functools
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

COLLECTIVES: "collections.Counter[str]" = collections.Counter()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda") -> None:
    """Join (or form) the process group.

    Arguments default to the ``NAVC_COORDINATOR`` (``host:port``, the rank
    0 process listens there), ``NAVC_NUM_PROCESSES`` and ``NAVC_PROCESS_ID``
    environment variables; with no coordinator
    torch's own ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) are read. ``backend`` (``init_process_group``'s
    own) defaults to NCCL when ``device`` is the card and gloo on the CPU.
    A rank on the card makes ``cuda:(rank % device_count)`` its current
    device; without a card that raises. A second call is a no-op."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("NAVC_COORDINATOR")
    if num_processes is None and "NAVC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NAVC_NUM_PROCESSES"])
    if process_id is None and "NAVC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["NAVC_PROCESS_ID"])
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns side effects (checkpoints, logs)."""
    return process_index() == 0


def primary_only(fn):
    """Decorator: run ``fn`` on process 0 only; other ranks get ``None``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None

    return wrapper


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)`` for the card
    (which must be there), else ``device`` itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


def group_backend(group=None) -> Optional[str]:
    """The group's backend ("nccl", "gloo"), None without a process group."""
    return str(dist.get_backend(group)) if dist.is_initialized() else None


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and group_backend(group) == "gloo"


class GroupRef:
    """A process group a module holds: a deep copy of the module shares it
    (a process group cannot be copied)."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group``'s ranks, in place; returns ``t``."""
    COLLECTIVES["all_reduce"] += 1
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """The sum over the group's ranks; its backward is the sum of the
    ranks' gradients, so each rank's backward sees the global term."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable."""
    return _AllReduce.apply(x, group)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(group size, *t.shape): every rank's ``t``, in group-rank order."""
    COLLECTIVES["all_gather"] += 1
    n = dist.get_world_size(group)
    src = t.cpu() if _via_host(t, group) else t.contiguous()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    return torch.stack(outs).to(t.device)


def broadcast_flag(flag: bool, device="cpu") -> bool:
    """Rank 0's ``flag`` on every rank (``device``: where the group's
    backend takes tensors). Without a process group, ``flag``."""
    if not dist.is_initialized():
        return bool(flag)
    COLLECTIVES["broadcast"] += 1
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.broadcast(t, src=0)
    return bool(int(t.item()))


def barrier() -> None:
    """Every rank waits for the others (nothing without a process group)."""
    if dist.is_initialized():
        COLLECTIVES["barrier"] += 1
        dist.barrier()
