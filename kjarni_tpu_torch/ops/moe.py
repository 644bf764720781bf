"""Mixture-of-experts routing and the experts' grouped GEMM.

A layer's routed rows are sorted by expert on the device, with each expert's
row count and the groups' end offsets computed there too, so that every
projection of every expert is one launch over device offsets: no row count
ever reaches the host, and a forward through the experts makes no host sync.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """x [M, K], its rows sorted by group; w [E, K, N]; offs [E] int32, the
    end row of each group in x (a group may be empty). Returns [M, N], each
    row times its group's w, in x's dtype: one launch of torch's grouped GEMM
    (CUTLASS on sm90 in bf16; on the CPU, and in f32 on the card, torch's
    fallback, which loops over the groups on the host)."""
    return torch._grouped_mm(x, w, offs=offs)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int, norm_topk: bool,
          scaling: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights [N, k] f32, experts [N, k]) of each row of x [N, hid]: the
    softmax over the experts of f32 logits (x @ router, router [hid, E] f32),
    its greedy top-k, renormalised to sum 1 when `norm_topk`, else scaled by
    `scaling`."""
    scores = torch.softmax(x.float() @ router, dim=-1)
    weights, experts = torch.topk(scores, top_k, dim=-1)
    if norm_topk and top_k > 1:
        return weights / (weights.sum(dim=-1, keepdim=True) + 1e-20), experts
    return (weights if scaling == 1.0 else weights * scaling), experts


def sort_rows(experts: torch.Tensor, num_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order [N * k], offs [E] int32) of a routing experts [N, k]: the
    flattened (row, choice) pairs in expert order (stable, so rows keep
    their order inside a group), and each group's end offset."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return order, torch.cumsum(counts, 0, dtype=torch.int32)


def experts_forward(x: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor,
                    gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU over x [N, hid], combined by the router's
    weights [N, k] (experts [N, k]): gate_up [E, 2I, hid] (gate rows, then
    up rows) and down [E, hid, I], both in the checkpoint's [out, in] layout.
    One grouped GEMM for gate and up together, one for down; each expert's
    output is weighted in f32 and the k outputs of a row summed in f32, then
    cast to x's dtype (the published `moe_infer`'s order)."""
    N, k = experts.shape
    E, two_i, _ = gate_up.shape
    order, offs = sort_rows(experts, E)
    rows = x.index_select(0, order // k)
    h = grouped_mm(rows, gate_up.transpose(-2, -1), offs)
    act = F.silu(h[:, :two_i // 2]) * h[:, two_i // 2:]
    y = grouped_mm(act, down.transpose(-2, -1), offs)
    out = torch.empty_like(y).index_copy_(0, order, y)      # back to (row, choice)
    return (out.view(N, k, -1).float() * weights[..., None]).sum(dim=1).to(x.dtype)

