"""Collectives of the port's parallel paths, over torch.distributed.

SPMD: one process per rank. The caller initializes the default process group
(torchrun's environment, or `init_process_group` with its own address, world
size and rank); nothing here picks a backend or a device. Every collective
the port runs goes through a `Comm`: all-reduce, all-gather along a dim,
all-to-all, broadcast and the ring shift. The JAX package has no such module:
GSPMD and `shard_map` insert its collectives.

`from_rank0` runs a read (stdin, a prompt) on rank 0 alone and hands its
value to every rank: torchrun's ranks inherit one stdin, and each rank
reading it would split the input between them.

Transport. NCCL takes card tensors as they are. Gloo takes CPU tensors, and
the PyTorch docs list CUDA support for only some of its collectives, so a
card tensor handed to a gloo group is staged through host memory here:
copied to the host, the collective run there, the result copied back. That
is the transport the caller chose by initializing gloo, not a fallback: NCCL
never stages, and `Comm.transport` names what a tensor takes so every result
can state it.

Autograd. The collectives above run outside autograd: the serving path,
under `torch.inference_mode()`, calls them as they are. A training step
goes through the Megatron pair instead, `copy_in` (f: identity forward,
the sum over the group backward) before a column-parallel region and
`reduce_out` (g: the sum forward, identity backward) after a row-parallel
one, and `gather_out` after a column-parallel head (the concatenation
forward, the rank's own slice backward). Each is the plain collective, with
no extra copy, whenever its input takes no gradient. `sum_grads` sums
gradients over a data-parallel group in one flat buffer per dtype.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..core.errors import InvalidConfigError


def require_world(n: int, what: str) -> None:
    """Raise unless the default process group has exactly n ranks: the
    port's counterpart of the JAX package's "only K device(s) visible"."""
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else None)
    if have != n:
        found = ("no process group is initialized" if have is None
                 else f"the process group has {have} rank(s)")
        raise InvalidConfigError(
            f"{what}={n} runs one process per rank: launch with "
            f"`torchrun --nproc-per-node {n}` (or initialize a torch.distributed "
            f"group of {n} ranks); {found}")


@contextlib.contextmanager
def spmd_group(device: Optional[str] = None):
    """Under torchrun (WORLD_SIZE > 1 in the environment), the default
    process group from its environment for the duration, unless the caller
    has initialized one already: gloo for device "cpu", else NCCL with this
    rank on cuda:LOCAL_RANK, which must exist."""
    ours = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if device == "cpu":
            dist.init_process_group("gloo")
        else:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= (torch.cuda.device_count() if torch.cuda.is_available() else 0):
                raise InvalidConfigError(
                    f"rank {os.environ.get('RANK')} runs on cuda:{local}, which this "
                    f"machine does not have; pass --device cpu for gloo on the CPU")
            torch.cuda.set_device(local)
            dist.init_process_group("nccl")
        ours = True
    try:
        yield
    finally:
        if ours:
            dist.destroy_process_group()


def from_rank0(read: Callable[[], Any]) -> Any:
    """read() on rank 0 of the default group alone, and its value on every
    rank (a pickled broadcast); what read() raises on rank 0 (EOFError at
    the end of input) is raised on every rank. With no group, read()."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return read()
    box = [None]
    if dist.get_rank() == 0:
        try:
            box[0] = (True, read())
        except BaseException as e:   # raised on every rank below
            box[0] = (False, e)
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if not ok:
        raise value
    return value


class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.clone(memory_format=torch.contiguous_format)), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: the sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    """The concatenation over the group forward; backward, the rank's own
    slice of the gradient. Every rank computes the same loss from the
    gathered tensor, so each holds the whole gradient already."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.width = comm, dim, x.shape[dim]
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.comm.rank * ctx.width, ctx.width), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class Comm:
    """One process group of the SPMD program and its collectives.

    `ranks` are the group's members as ranks of the default group, in group
    order (None: the whole default group). A group of one rank runs no
    collective: each returns its input.
    """

    def __init__(self, ranks: list[int] | None = None, group=None):
        world = dist.get_world_size()
        self.ranks = list(range(world)) if ranks is None else list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.group = group
        self.backend = dist.get_backend(group)

    def transport(self, device: torch.device | str) -> str:
        """What a tensor on `device` travels by: "nccl", "gloo", or "gloo,
        staged through host memory" for a card tensor on gloo."""
        if self.backend == "gloo" and torch.device(device).type == "cuda":
            return "gloo, staged through host memory"
        return self.backend

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the backend takes: a contiguous host copy of a card
        tensor on gloo (the staging), else x itself made contiguous."""
        if self.backend == "gloo" and x.is_cuda:
            return x.detach().to("cpu", copy=True).contiguous()
        return x.contiguous()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, the same bits on every rank."""
        if self.size == 1:
            return x
        t = self._host(x)
        dist.all_reduce(t, group=self.group)
        return t.to(x.device) if t.device != x.device else t

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's x concatenated along `dim`, in rank order."""
        if self.size == 1:
            return x
        t = self._host(x)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [size, ...]: chunk j goes to rank j; the result's chunk i came
        from rank i."""
        if self.size == 1:
            return x
        t = self._host(x)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out.to(x.device)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Group rank `src`'s x on every rank (x gives the shape elsewhere)."""
        if self.size == 1:
            return x
        t = self._host(x)
        dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t.to(x.device) if t.device != x.device else t

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """x itself; under autograd, its gradient is summed over the group
        (the input of a column-parallel region, Megatron's f)."""
        return _CopyIn.apply(x, self) if self.size > 1 and _tracked(x) else x

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """all_reduce; under autograd, the gradient passes through as it is
        (the output of a row-parallel linear, Megatron's g)."""
        return _ReduceOut.apply(x, self) if self.size > 1 and _tracked(x) else self.all_reduce(x)

    def gather_out(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """all_gather along `dim`; under autograd, the gradient's slice of
        this rank goes back (the output of a column-parallel head)."""
        if self.size > 1 and _tracked(x):
            return _GatherOut.apply(x, self, dim % x.ndim)
        return self.all_gather(x, dim)

    def sum_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each gradient summed over the group (data parallelism): one
        all-reduce of a flat buffer per dtype. Returns new tensors in the
        order given."""
        if self.size == 1:
            return list(grads)
        out: list = [None] * len(grads)
        by_dtype: dict = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault((g.dtype, g.device), []).append(i)
        for idx in by_dtype.values():
            flat = self.all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]))
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return out

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send x to the next rank of the group and return what the previous
        one sent (the last rank sends to the first): JAX's `ppermute` over
        the ring. Both sides are posted before either is waited on, since a
        ring of blocking sends can deadlock."""
        if self.size == 1:
            return x
        t = self._host(x)
        out = torch.empty_like(t)
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        reqs = [dist.isend(t, nxt, group=self.group),
                dist.irecv(out, prv, group=self.group)]
        for r in reqs:
            r.wait()
        return out.to(x.device)
