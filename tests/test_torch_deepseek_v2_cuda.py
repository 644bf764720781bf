"""DeepSeek-V2's expert route on the card: torch's grouped GEMM (CUTLASS,
bf16) against a loop over the experts at DeepSeek-V2-Lite's expert widths,
and a forward of a tiny DeepSeek-V2 in bf16 with no host sync (torch's sync
debug mode raises on one). Skipped without a card; on the machine with the
card (which has no jax, hence --noconftest):

    python -m pytest tests/test_torch_deepseek_v2_cuda.py -m cuda --noconftest -q

Tolerance of the grouped route: 2e-2 of the output's largest magnitude; both
sides take bf16 products in f32 and round each expert's output to bf16 once,
in another order of the sums."""

import pytest
import torch

from kbench import model as kmodel
from test_torch_deepseek_v2 import experts_loop
from kjarni_tpu_torch.models import deepseek_v2 as kds
from kjarni_tpu_torch.ops import moe

pytestmark = pytest.mark.cuda

TINY = {"model_type": "deepseek_v2", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 96, "moe_intermediate_size": 32, "num_hidden_layers": 3,
        "num_attention_heads": 4, "n_routed_experts": 8, "n_shared_experts": 1,
        "num_experts_per_tok": 2, "first_k_dense_replace": 1, "kv_lora_rank": 32,
        "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
        "v_head_dim": 16, "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
        "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                         "mscale_all_dim": 0.707},
        "bos_token_id": 1, "eos_token_id": 2, "dtype": "bf16", "source": "a tiny stand-in",
        "reduced": [], "assumed": []}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the grouped GEMM is CUTLASS for sm90")
    return torch.device("cuda")


@pytest.mark.parametrize("tokens", [40, 2048])
@torch.inference_mode()
def test_grouped_route_matches_the_loop_at_published_widths(card, tokens):
    g = torch.Generator(device=card).manual_seed(tokens)
    E, k, hid, inter = 64, 6, 2048, 1408
    x = torch.randn(tokens, hid, generator=g, device=card).to(torch.bfloat16)
    scores = torch.rand(tokens, E, generator=g, device=card)
    scores[:, 3] = -1                                    # expert 3 receives no row
    weights, experts = torch.topk(scores, k, dim=-1)
    gate_up = (torch.randn(E, 2 * inter, hid, generator=g, device=card) * 0.02).bfloat16()
    down = (torch.randn(E, hid, inter, generator=g, device=card) * 0.02).bfloat16()
    got = moe.experts_forward(x, weights, experts, gate_up, down).float()
    want = experts_loop(x, weights, experts, gate_up, down).float()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


@torch.inference_mode()
def test_forward_makes_no_host_sync_on_the_card(card, tmp_path):
    lm = kmodel.build(TINY, 5, 512, "cuda", tmp_path / "m")
    ids = torch.randint(3, 256, (2, 40), device=card)
    ck, cv = lm._new_cache(2, 64)
    pos = torch.tensor([40, 40], device=card)       # a copy from the host: made before
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kds.forward_hidden(lm.params, lm.config, ids, ck, cv, 0)
        kds.forward(lm.params, lm.config, ids[:, :1], ck, cv, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
