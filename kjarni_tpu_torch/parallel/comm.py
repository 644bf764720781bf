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
"""

from __future__ import annotations

from typing import Any, Callable

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
