"""DeepSeek-V2 in the port (models/deepseek_v2.py, ops/moe.py) against the
benchmark's plain f32 reference (kbench/arch/deepseek_v2.py) on the CPU: a
tiny configuration that keeps every mechanism (a dense layer 0, then 8
routed experts at top-2 and a shared expert, a latent of 32, YaRN at factor
40 with its ramp inside the rope dims, no renormalisation), built through
the benchmark's seam (kbench/model.py) with seeded weights.

Tolerance: 1e-3 on logits, f32 program against the f32 reference; the two
differ by the order of f32 sums alone (the program's absorbed decode and
grouped experts reorder them), a few 1e-6 here."""

import math

import numpy as np
import pytest
import torch

from kbench import model as kmodel
from kbench import weights as kweights
from kbench.arch import deepseek_v2 as ref
from kbench.reference.decoder import logits_at
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.generate.continuous import ContinuousEngine
from kjarni_tpu_torch.generate.sampling import GenerationConfig
from kjarni_tpu_torch.models import decoder_lm
from kjarni_tpu_torch.models import deepseek_v2 as kds
from kjarni_tpu_torch.models.llama import causal_bias
from kjarni_tpu_torch.ops import moe

TINY = {"model_type": "deepseek_v2", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 96, "moe_intermediate_size": 32, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4, "n_routed_experts": 8,
        "n_shared_experts": 1, "num_experts_per_tok": 2, "first_k_dense_replace": 1,
        "moe_layer_freq": 1, "kv_lora_rank": 32, "q_lora_rank": None,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
        "norm_topk_prob": False, "routed_scaling_factor": 1.0, "scoring_func": "softmax",
        "topk_method": "greedy", "n_group": 1, "topk_group": 1, "hidden_act": "silu",
        "max_position_embeddings": 163840, "rms_norm_eps": 1e-6, "rope_theta": 10000,
        "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                         "mscale_all_dim": 0.707},
        "attention_bias": False, "tie_word_embeddings": False,
        "bos_token_id": 1, "eos_token_id": 2}
CONF = dict(TINY, dtype="f32", source="a tiny stand-in for the CPU tests", reduced=[],
            assumed=[])
SEED = 2 ** 31 + 2020
TOL = 1e-3
CTX = 512


def _build(tmp_path, **kw):
    return kmodel.build(dict(CONF, **kw), SEED, CTX, "cpu", tmp_path / "model")


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("ds"))


def _reference(seqs, rows):
    return logits_at(TINY, SEED, seqs, rows, "cpu")


def _prompt(n, salt=0):
    g = np.random.default_rng(n + 1000 * salt)
    return [1] + [int(t) for t in g.integers(3, TINY["vocab_size"], n - 1)]


def _gap(a, b):
    return float((a.float() - b.float()).abs().max())


def experts_loop(x, weights, experts, gate_up, down):
    """moe.experts_forward by a host loop over the experts (the published
    `moe_infer`): the plain version the grouped route is held to. It reads
    each expert's row count on the host."""
    N, k = experts.shape
    inter = gate_up.shape[1] // 2
    out = torch.zeros((N * k, x.shape[-1]), dtype=x.dtype, device=x.device)
    flat = experts.reshape(-1)
    for e in range(gate_up.shape[0]):
        idx = (flat == e).nonzero()[:, 0]
        if len(idx):
            h = x[idx // k] @ gate_up[e].t()
            out[idx] = (torch.nn.functional.silu(h[:, :inter]) * h[:, inter:]) @ down[e].t()
    return (out.view(N, k, -1).float() * weights[..., None]).sum(dim=1).to(x.dtype)


@torch.inference_mode()
def test_prefill_logits_match_the_reference(lm):
    ids = _prompt(37)
    ck, cv = lm._new_cache(1, 64)
    logits, _, _ = kds.forward_all_logits(lm.params, lm.config, torch.tensor([ids]),
                                          ck, cv, 0)
    want = _reference([ids], [list(range(len(ids)))])[0]
    assert _gap(logits[0], want) < TOL


@torch.inference_mode()
def test_decode_through_the_latent_cache_matches_the_full_forward(lm):
    """A prefill, then each decode step at S = 1 (the absorbed form) over the
    latent cache, against the reference's full forward at every row."""
    ids = _prompt(21, salt=1)
    steps = [5, 77, 140, 9, 201, 33]
    ck, cv = lm._new_cache(1, 64)
    cfg, params = lm.config, lm.params
    got = [kds.forward(params, cfg, torch.tensor([ids]), ck, cv, 0)[0][0]]
    for j, t in enumerate(steps):
        got.append(kds.forward(params, cfg, torch.tensor([[t]]), ck, cv, len(ids) + j)[0][0])
    seq = ids + steps
    want = _reference([seq], [list(range(len(ids) - 1, len(seq)))])[0]
    assert _gap(torch.stack(got), want) < TOL


@torch.inference_mode()
def test_generate_stream_serves_the_reference_argmax(lm):
    """generate_stream (bucketed prefill, decode over working slices of the
    latent cache): every greedy token is the reference's best."""
    ids = _prompt(40, salt=2)
    gen = GenerationConfig(max_new_tokens=12, strategy="greedy")
    toks = [st.id for st in lm.generate_stream(token_ids=ids, config=gen)]
    assert len(toks) == 12
    want = _reference([ids + toks[:-1]], [list(range(len(ids) - 1, len(ids) + 11))])[0]
    best = want.max(dim=-1).values
    chosen = want.gather(1, torch.tensor(toks)[:, None])[:, 0]
    assert float((best - chosen).max()) < TOL


@torch.inference_mode()
def test_generate_batch_equals_generate_per_row(lm):
    """Left-padded ragged rows (per-row rope positions, the pad mask over the
    latent cache) give each row's own greedy generation."""
    prompts = [" ".join(f"w{t}" for t in _prompt(n, salt=8)[1:]) for n in (9, 23, 16)]
    gen = GenerationConfig(max_new_tokens=6, strategy="greedy")
    out = lm.generate_batch(prompts, config=gen)
    assert all(len(o.split()) == 6 for o in out)
    assert out == [lm.generate(p, config=gen) for p in prompts]


class _Recorder:
    """The family's functions as the engine calls them, recording each
    admission's lane logits and each decode step's (row, position, input
    token, logits) of the slots active at its call."""

    def __init__(self, eng):
        self.eng, self.lanes, self.steps = eng, [], []

    def __getattr__(self, name):
        return getattr(kds, name)

    def head_logits(self, *a, **kw):
        out = kds.head_logits(*a, **kw)
        self.lanes.append(out.clone())
        return out

    def forward(self, params, cfg, ids, ck, cv, pos, *a, **kw):
        out = kds.forward(params, cfg, ids, ck, cv, pos, *a, **kw)
        if torch.is_tensor(pos):
            live = [r for r, s in enumerate(self.eng._slots) if s.active]
            self.steps.append([(r, int(pos[r]), int(ids[r, 0]), out[0][r].clone())
                               for r in live])
        return out


@pytest.mark.parametrize("plan", ["plain", "chunked"])
@torch.inference_mode()
def test_engine_logits_match_the_reference_in_both_admission_plans(lm, plan):
    """Three requests join in one admission wave (one lane each), then
    decode windows over every slot: each lane's admission logits and each
    live slot's decode logits against the reference over the sequence the
    slot was fed."""
    eng = ContinuousEngine(lm, slots=4, steps_per_sync=4)
    eng._kv_bucket_step = 256
    if plan == "chunked":
        eng._admit_score_limit = 1            # the 256 bucket in chunks of 128
    rec = eng.family = _Recorder(eng)
    prompts = [_prompt(n, salt=3) for n in (150, 201, 170)]
    for p in prompts:
        eng.submit(token_ids=p, max_new_tokens=7, defer_admit=True)
    eng.run()
    assert eng.stats["admission_waves"] == 1
    assert eng._admit_plans[(256, 0, 3)]["mode"] == plan
    seqs, rows, got = [], [], []
    for r, p in enumerate(prompts):
        fed = sorted((pos, tok, lg) for step in rec.steps for (row, pos, tok, lg) in step
                     if row == r and pos >= len(p))
        assert [f[0] for f in fed] == list(range(len(p), len(p) + len(fed))) and len(fed) >= 6
        seqs.append(p + [f[1] for f in fed])
        rows.append(list(range(len(p) - 1, len(seqs[-1]))))
        got.append(torch.stack([rec.lanes[0][r]] + [f[2] for f in fed]))
    for g, w in zip(got, _reference(seqs, rows)):
        assert _gap(g, w) < TOL


@pytest.mark.parametrize("rows", [1, 9])
@torch.inference_mode()
def test_absorbed_attention_equals_the_expanded_form(lm, rows):
    """The absorbed form (decode) and the expanded form (prefill) of one
    attention call (layer 1) over the same latent cache, at one query row
    and at several."""
    ids = _prompt(30, salt=4)
    cfg, params = lm.config, lm.params
    ck, cv = lm._new_cache(1, 64)
    kds.forward(params, cfg, torch.tensor([ids]), ck, cv, 0)
    h = torch.randn(1, rows, cfg.hidden_size, generator=torch.Generator().manual_seed(rows))
    start, n = len(ids), len(ids) + rows
    cos, sin = params["rope_cos"][start:n], params["rope_sin"][start:n]
    bias = causal_bias(start, rows, n, "cpu")
    out = [kds.mla(params["views"][1], cfg, h, cos, sin, (ck[1].clone(), cv[1].clone()),
                   start, bias, n, absorbed) for absorbed in (True, False)]
    assert _gap(out[0], out[1]) < 1e-4


@torch.inference_mode()
def test_grouped_route_equals_a_loop_over_experts():
    """The sorted rows through two grouped GEMMs against a per-expert loop,
    with an expert (3) that receives no row and one (5) that receives most."""
    g = torch.Generator().manual_seed(7)
    N, k, E, hid, inter = 11, 2, 8, 64, 32
    x = torch.randn(N, hid, generator=g)
    experts = torch.randint(0, E, (N, k), generator=g)
    experts[experts == 3] = 5
    experts[:, 0] = torch.where(torch.arange(N) % 2 == 0, 5, experts[:, 0])
    experts[:, 1] = torch.where(experts[:, 1] == experts[:, 0], (experts[:, 0] + 1) % E,
                                experts[:, 1])
    experts[experts == 3] = 4
    weights = torch.rand(N, k, generator=g)
    gate_up = torch.randn(E, 2 * inter, hid, generator=g) * 0.1
    down = torch.randn(E, hid, inter, generator=g) * 0.1
    order, offs = moe.sort_rows(experts, E)
    counts = torch.diff(offs, prepend=offs.new_zeros(1))
    assert counts[3] == 0 and counts[5] == counts.max() and int(offs[-1]) == N * k
    assert torch.equal(experts.reshape(-1)[order], experts.reshape(-1).sort(stable=True).values)
    got = moe.experts_forward(x, weights, experts, gate_up, down)
    assert _gap(got, experts_loop(x, weights, experts, gate_up, down)) < 1e-5


def test_the_forward_makes_no_host_sync(lm, monkeypatch):
    """No `.item()`, `.tolist()`, `nonzero`, `bool()` / `int()` of a tensor
    or copy to the host inside a prefill or a per-row decode forward."""
    ids = torch.tensor([_prompt(20, salt=6), _prompt(20, salt=7)])
    ck, cv = lm._new_cache(2, 64)

    def refuse(*a, **kw):
        raise AssertionError("host sync inside the forward")

    for name in ("item", "tolist", "nonzero", "__bool__", "__int__", "__index__", "cpu",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    with torch.inference_mode():
        kds.forward_hidden(lm.params, lm.config, ids, ck, cv, 0)
        kds.forward(lm.params, lm.config, ids[:, :1], ck, cv, torch.tensor([20, 20]))


@pytest.mark.parametrize("dim", [5, 16, 30])
def test_yarn_table_follows_the_published_formulas(dim):
    """DeepSeek-V2-Lite's rope (64 dims, factor 40 over 4096, beta 32 / 1):
    below the ramp (5), inside it (16), above it (30), by the published
    formulas written out here."""
    cfg = kds.DeepseekV2Config.from_hf(dict(TINY, qk_rope_head_dim=64))
    d, base = 64, 10000.0

    def corr(rot):
        return d * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    ramp = min(max((dim - low) / (high - low), 0.0), 1.0)
    extra = base ** (-2 * dim / d)
    want = extra / 40 * ramp + extra * (1 - ramp)
    assert kds.yarn_inv_freq(cfg)[dim] == pytest.approx(want, rel=1e-12)
    assert float(ref.inv_freq(dict(TINY, qk_rope_head_dim=64))[dim]) == pytest.approx(
        want, rel=1e-12)
    cos, sin = kds.rope_cache(cfg, 300)
    assert cos[299, dim] == pytest.approx(math.cos(299 * want), abs=1e-6)
    assert sin[299, dim + 32] == pytest.approx(math.sin(299 * want), abs=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cfg.softmax_scale == pytest.approx((16 + 64) ** -0.5 * m * m, rel=1e-12)


@pytest.mark.parametrize("kw", [{"quantize": "int4"}, {"quantize": "int8"},
                                {"kv_cache": "int8"}, {"tp": 2},
                                {"execution_plan": "offload_ends"},
                                {"execution_plan": "offload_head"}])
def test_what_the_family_cannot_do_is_refused(tmp_path, kw):
    kmodel.build(CONF, SEED, CTX, "cpu", tmp_path / "m")      # writes the model dir
    with pytest.raises(InvalidConfigError, match="deepseek_v2"):
        seam = decoder_lm.ModelWeights
        decoder_lm.ModelWeights = lambda _d: kweights.SeededWeights(TINY, SEED, "cpu")
        try:
            decoder_lm.DecoderLM(tmp_path / "m", dtype="f32", device="cpu", **kw)
        finally:
            decoder_lm.ModelWeights = seam


@pytest.mark.parametrize("key,value", [("q_lora_rank", 1536),
                                       ("topk_method", "group_limited_greedy"),
                                       ("moe_layer_freq", 2)])
def test_unsupported_settings_are_refused(key, value):
    with pytest.raises(InvalidConfigError, match=key):
        kds.DeepseekV2Config.from_hf(dict(TINY, **{key: value}))


def test_program_and_reference_read_one_layout():
    """The program's load_params reads every kind of tensor of the
    reference's layout, and nothing else, at the tiny size and at
    DeepSeek-V2-Lite's layer and expert counts."""
    for conf in (TINY, dict(TINY, num_hidden_layers=27, n_routed_experts=64,
                            num_experts_per_tok=6)):
        sw = kweights.SeededWeights(conf, SEED, "cpu")
        read = []
        get = sw.get
        sw.get = lambda name: read.append(name) or get(name)
        kds.load_params(sw, kds.DeepseekV2Config.from_hf(conf), rope_cache_len=8)
        patterns = {kweights.split_name(n)[0] for n in read}
        assert patterns == set(kweights.kinds(conf))
        assert len(read) == len(set(read))          # each tensor once
