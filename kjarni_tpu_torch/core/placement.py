"""Device placement and per-stage host offload (port of
kjarni_tpu/core/placement.py; cf. the reference's KjarniDevice::resolve
kjarni/src/common/device.rs:7,21 and ExecutionPlan presets
execution/plan.rs:35).

`resolve_device` maps the port's device argument to a torch device: None
means the card, and a missing card raises; the CPU runs only when asked for.

An `ExecutionPlan` puts the embedding table and/or the lm head in host RAM.
The layer stack always stays on the card. The embedding lookup then runs on
the host (ids to the CPU, `F.embedding` on the host table, the gathered rows
to the card), and the head's matmul too (the final hidden rows to the CPU,
`x @ w` in the head's dtype there, the logits to the card). This frees
vocab_size x hidden x dtype bytes of device memory per offloaded table; only
the gathered rows and the logits cross PCIe.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .errors import InvalidConfigError


def resolve_device(device) -> torch.device:
    """None / "auto" / "cuda" mean the card, and a missing card raises; the
    CPU runs only when asked for."""
    d = torch.device("cuda" if device in (None, "auto", "gpu") else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise InvalidConfigError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise InvalidConfigError(f"unsupported device '{device}'")
    return d


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Where the embedding table and the lm head live: "device" | "host".

    The transformer layer stack always stays on the device; the reference's
    full_cpu preset maps to device="cpu" instead.
    """
    embeddings: str = "device"
    lm_head: str = "device"

    @classmethod
    def resolve(cls, plan: "ExecutionPlan | str | None") -> "ExecutionPlan":
        if plan is None:
            return cls()
        if isinstance(plan, ExecutionPlan):
            return plan
        presets = {
            "device": cls(),
            "full_device": cls(),
            "offload_embeddings": cls(embeddings="host"),
            "offload_head": cls(lm_head="host"),
            "offload_ends": cls(embeddings="host", lm_head="host"),
        }
        if plan not in presets:
            raise InvalidConfigError(
                f"unknown execution plan '{plan}' "
                f"(expected one of {sorted(presets)})")
        return presets[plan]


def to_host_memory(x: torch.Tensor) -> torch.Tensor:
    """A host copy of `x`, page-locked when it comes from the card so that
    later copies out of it run at the PCIe rate."""
    if x.device.type == "cpu":
        return x
    return x.cpu().pin_memory()


def host_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup against a host-resident table: the ids move to the
    host, the rows are gathered there, and only the rows go to the ids'
    device."""
    return F.embedding(ids.cpu(), table).to(ids.device, non_blocking=True)


def host_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """lm-head projection against a host-resident [D, V] matrix: the
    activations go to the host, the matmul runs there in w's dtype, and the
    logits come back to x's device (the gpu_offload_head preset,
    plan.rs:56)."""
    return (x.cpu().to(w.dtype) @ w).to(x.device, non_blocking=True)
