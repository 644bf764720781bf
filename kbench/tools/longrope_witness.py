"""A CPU witness for Phi-3's LongRoPE: the port, the plain reference and
transformers' Phi3ForCausalLM on the same seeded weights at a tiny size.

    python3 -m kbench.tools.longrope_witness

Prints the largest logit difference of each pair, with and without
`rope_scaling`, for sequences shorter and longer than
`original_max_position_embeddings` and for two `max_context`s. Needs the
`transformers` package (present in the CPU sandbox, not on the card machine).
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from kbench import model, weights
from kbench.reference.decoder import logits_at

BASE = {"architectures": ["Phi3ForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
        "pad_token_id": 0, "hidden_size": 128, "intermediate_size": 256,
        "max_position_embeddings": 8192, "original_max_position_embeddings": 256,
        "model_type": "phi3", "num_attention_heads": 4, "num_hidden_layers": 2,
        "num_key_value_heads": 4, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "sliding_window": 262144, "tie_word_embeddings": False, "vocab_size": 512}
SEED = 7


def _longrope() -> dict:
    u = np.sort(np.random.default_rng(35).uniform(0.0, 1.0, (2, 16)), axis=1)
    return {"type": "longrope", "short_factor": [1.0 + float(x) ** 4 for x in u[0]],
            "long_factor": [1.0 + 59.0 * float(x) for x in u[1]]}


def _port(hf: dict, ids: list, max_context: int):
    from kjarni_tpu_torch.models import llama
    lm = model.build(dict(hf, dtype="f32", quantize=None), SEED, max_context, "cpu",
                     Path(tempfile.mkdtemp()) / "m")
    ck, cv = llama.init_cache(lm.config, 1, max_context, torch.float32, "cpu")
    return llama.forward_all_logits(lm.params, lm.config, torch.tensor([ids]), ck, cv, 0)[0][0]


def _transformers(hf: dict, ids: list):
    from transformers import Phi3Config, Phi3ForCausalLM
    m = Phi3ForCausalLM(Phi3Config(**{k: v for k, v in hf.items()
                                      if k != "architectures"})).eval()
    sd = {}
    for pat in weights.kinds(hf):
        t = weights.draw(hf, SEED, pat, "cpu").float()
        sd.update({pat.format(i): t[i] for i in range(hf["num_hidden_layers"])}
                  if "{}" in pat else {pat: t})
    m.load_state_dict(sd, strict=False)
    with torch.no_grad():
        return m(torch.tensor([ids])).logits[0]


def main() -> None:
    for scaling in (None, _longrope()):
        hf = dict(BASE, **({"rope_scaling": scaling} if scaling else {}))
        for n, max_context in ((100, 256), (100, 512), (300, 512)):
            ids = [1] + [int(i) for i in np.random.default_rng(1).integers(3, 512, n - 1)]
            ref = logits_at(hf, SEED, [ids], [list(range(n))], "cpu")[0]
            port, tf = _port(hf, ids, max_context), _transformers(hf, ids)
            d = lambda a, b: float((a - b).abs().max())   # noqa: E731
            print(f"rope_scaling {'longrope' if scaling else 'none':8s} tokens {n:3d} "
                  f"max_context {max_context}: |port - ref| {d(port, ref):.2e}  "
                  f"|transformers - ref| {d(tf, ref):.2e}  |port - transformers| "
                  f"{d(port, tf):.2e}  (largest logit {float(ref.abs().max()):.2f})")


if __name__ == "__main__":
    main()
