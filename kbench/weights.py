"""Seeded weights for the benchmark's models, made on the device.

Every tensor has the name and shape of the published Hugging Face checkpoint.
The layout, {name pattern: kind}, is the architecture module's (`kinds(cfg)`
of `kbench/arch/<family>.py`, found by `model_type`; a new architecture is a
new file there, with no edit here). A pattern holds one `{}` for a kind with a
tensor in each of a range of layers (`Kind.layers`, every layer by default),
and a second `{}` for a kind with one tensor per expert in each of those
layers (`Kind.experts`): `model.layers.{}.mlp.experts.{}.gate_proj.weight`.

The tensors of one kind are drawn together, in one call of a `torch.Generator`
on the device seeded from (the run's seed, the kind's name pattern), in bf16,
the type they are served in: [*shape] for a pattern without `{}`, [layers,
*shape] with one, [layers, experts, *shape] with two. So a model is a dozen
large draws, and the reference draws any kind again by itself from the seed
alone.

Projections and embeddings are N(0, 0.02) (the published `initializer_range`);
norm weights are 1 + N(0, 0.1), so that a norm the program dropped or
misapplied shows in its outputs.

`SeededWeights` is the one seam between the harness and the program: it stands
in for `weights/safetensors_loader.ModelWeights` while the model is built,
with the same `__contains__`, `get`, `get_f32` and `has_any`.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from . import lookup

PROJ_STD = 0.02
NORM_STD = 0.1
_INDEX = re.compile(r"(?<=\.)\d+(?=\.)")


class Kind(NamedTuple):
    """One kind of tensor: its shape in one layer (and expert), whether it is
    a norm weight, the layers [first, stop) that hold it (None: all), and the
    count of the second index of a pattern with two `{}`."""
    shape: tuple
    is_norm: bool
    layers: Optional[tuple] = None
    experts: Optional[int] = None


def kind_seed(seed: int, pattern: str) -> int:
    """A 63-bit generator seed for one kind of tensor of one run."""
    digest = hashlib.sha256(f"{int(seed)}:{pattern}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def kinds(cfg: dict, kroot: Path = lookup.KROOT) -> dict:
    """Every kind of tensor of cfg's checkpoint: name pattern -> Kind, from
    its architecture module."""
    out = {p: Kind(*k) for p, k in lookup.architecture(cfg, kroot).kinds(cfg).items()}
    for p, k in out.items():
        stack_shape(cfg, p, k)         # raises for a kind its pattern cannot hold
    return out


def layer_range(cfg: dict, kind: Kind) -> tuple:
    return kind.layers or (0, cfg["num_hidden_layers"])


def stack_shape(cfg: dict, pattern: str, kind: Kind) -> tuple:
    """The shape of one kind's draw: its shape behind one index per `{}`."""
    n = pattern.count("{}")
    if n == 0:
        return tuple(kind.shape)
    first, stop = layer_range(cfg, kind)
    if n == 1 and kind.experts is None:
        return (stop - first, *kind.shape)
    if n == 2 and kind.experts is not None:
        return (stop - first, kind.experts, *kind.shape)
    raise ValueError(f"pattern {pattern!r} has {n} indices and experts={kind.experts}")


def draw(cfg: dict, seed: int, pattern: str, device, *, layout: Optional[dict] = None,
         kroot: Path = lookup.KROOT) -> torch.Tensor:
    """One kind of tensor in bf16 on `device`, stacked as `stack_shape` says.
    `layout` is cfg's {pattern: kind} where the caller has it (an
    architecture module passes its own), else it is looked up. The same
    (cfg, seed, pattern, device type) gives the same bits."""
    kind = Kind(*(kinds(cfg, kroot) if layout is None else layout)[pattern])
    g = torch.Generator(device=device).manual_seed(kind_seed(seed, pattern))
    t = torch.randn(stack_shape(cfg, pattern, kind), generator=g, device=device,
                    dtype=torch.bfloat16)
    return t.mul_(NORM_STD).add_(1.0) if kind.is_norm else t.mul_(PROJ_STD)


def split_name(name: str) -> tuple[str, tuple]:
    """A tensor name -> (its kind's pattern, its indices): every all-digit
    part of the dotted name is an index (`model.layers.3.mlp.experts.17.w`
    -> `model.layers.{}.mlp.experts.{}.w`, (3, 17))."""
    return _INDEX.sub("{}", name), tuple(int(i) for i in _INDEX.findall(name))


class SeededWeights:
    """An in-memory checkpoint drawn from the seed on `device`.

    Reading a tensor draws its whole kind once and keeps it until a tensor
    of another kind is read; the port's loader reads one kind over every
    layer at a time, so only one extra kind is ever held. Nothing is written
    to disk."""

    def __init__(self, cfg: dict, seed: int, device, kroot: Path = lookup.KROOT):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self._kinds = kinds(cfg, kroot)
        self._held: tuple[str, torch.Tensor] | None = None
        self.draws = 0

    def _position(self, name: str) -> tuple[str, tuple] | None:
        """(pattern, index into the kind's draw) of a tensor the layout has,
        else None."""
        pattern, idx = split_name(name)
        kind = self._kinds.get(pattern)
        if kind is None:
            return None
        if idx:
            first, stop = layer_range(self.cfg, kind)
            if not first <= idx[0] < stop:
                return None
            if len(idx) == 2 and not 0 <= idx[1] < kind.experts:
                return None
            idx = (idx[0] - first, *idx[1:])
        return pattern, idx

    def __contains__(self, name: str) -> bool:
        return self._position(name) is not None

    def get(self, name: str) -> torch.Tensor:
        at = self._position(name)
        if at is None:
            raise KeyError(f"no tensor {name!r} in the seeded checkpoint")
        pattern, idx = at
        if self._held is None or self._held[0] != pattern:
            self._held = None          # free the last kind before drawing
            self._held = (pattern, draw(self.cfg, self.seed, pattern, self.device,
                                        layout=self._kinds))
            self.draws += 1
        t = self._held[1]
        return t[idx] if idx else t

    def get_f32(self, name: str):
        return self.get(name).float().cpu().numpy()

    def has_any(self, *names: str) -> bool:
        return any(n in self for n in names)

    def release(self) -> None:
        self._held = None
