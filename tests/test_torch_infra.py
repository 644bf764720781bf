"""The port's decoder infrastructure against the JAX package's, on the CPU:
execution plans (host offload of the embedding table and the lm head), the
native checkpoint, and profiling.

The same tiny HF llama checkpoints (tests/helpers.py) go through
`kjarni_tpu.models.decoder_lm.DecoderLM` under its default plan and the
port's `DecoderLM(device="cpu")` under each offload plan, in f32, plain and
int4: greedy ids of generate, generate_stream and generate_batch must be
equal, and the host gather / host matmul must be the paths taken. The
continuous engine and the speculative loop under offload_ends equal the
port's own default plan. A converted checkpoint (f32, int8, int4) loads
params bit-equal to the in-memory tree and generates the JAX package's ids
from the HF dir; an Orbax checkpoint written by the JAX package raises the
port's error.
"""

import json

import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model

from kjarni_tpu.core import placement as jplacement
from kjarni_tpu.core import profiling as jprofiling
from kjarni_tpu.generate.sampling import GenerationConfig as JaxGenerationConfig
from kjarni_tpu.models.decoder_lm import DecoderLM as JaxDecoderLM
from kjarni_tpu_torch.core import placement, profiling
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.generate.sampling import GenerationConfig
from kjarni_tpu_torch.models import decoder_lm
from kjarni_tpu_torch.models import llama as kllama
from kjarni_tpu_torch.models.decoder_lm import DecoderLM
from kjarni_tpu_torch.weights.checkpoint import (CHECKPOINT_DIR, convert_model,
                                                 has_checkpoint, load_checkpoint,
                                                 save_checkpoint)

PROMPTS = ["hello world the doctor and the nurse", "i love this great product it is",
           "the physician was the best and it is safe to say"]
PLANS = ("offload_ends", "offload_embeddings", "offload_head")
MAX_CONTEXT = 128


def _llama_dir(d, tied, seed):
    from transformers import LlamaConfig, LlamaForCausalLM
    vm = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    config = LlamaConfig(vocab_size=len(vm), hidden_size=256, intermediate_size=512,
                         num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                         max_position_embeddings=MAX_CONTEXT, bos_token_id=2,
                         eos_token_id=3, tie_word_embeddings=tied)
    torch.manual_seed(seed)
    model = LlamaForCausalLM(config).eval()
    with torch.no_grad():   # larger weights than HF's init: less repetitive text
        for p in model.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 0.08)
    save_torch_model(d, model, config)
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {"untied": _llama_dir(tmp_path_factory.mktemp("infra_llama"), False, 21),
            "tied": _llama_dir(tmp_path_factory.mktemp("infra_tied"), True, 22)}


def _greedy(n, jax=False):
    cls = JaxGenerationConfig if jax else GenerationConfig
    return cls.greedy(max_new_tokens=n, max_length=MAX_CONTEXT)


def _outputs(lm, jax=False):
    """Greedy ids of generate and generate_stream, and generate_batch texts."""
    gen = lm.generate(PROMPTS[0], config=_greedy(12, jax))
    ids = list(lm._session_ids)
    stream = [st.id for st in lm.generate_stream(PROMPTS[1], config=_greedy(12, jax))]
    batch = lm.generate_batch(PROMPTS, config=_greedy(8, jax))
    return gen, ids, stream, batch


@pytest.fixture(scope="module")
def jax_outputs(dirs):
    cache = {}

    def get(name, quantize):
        if (name, quantize) not in cache:
            lm = JaxDecoderLM(dirs[name], max_context=MAX_CONTEXT, quantize=quantize)
            cache[name, quantize] = _outputs(lm, jax=True)
        return cache[name, quantize]
    return get


@pytest.fixture
def host_calls(monkeypatch):
    """Counts of the host gather and host matmul calls the llama forward
    makes."""
    calls = {"gather": 0, "matmul": 0}

    def counted(key, fn):
        def wrap(*a):
            calls[key] += 1
            return fn(*a)
        return wrap
    monkeypatch.setattr(kllama, "host_gather", counted("gather", kllama.host_gather))
    monkeypatch.setattr(kllama, "host_matmul", counted("matmul", kllama.host_matmul))
    return calls


# ---------------------------------------------------------------------------
# execution plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["device", "full_device", *PLANS])
def test_plan_presets_equal_jax(name):
    t, j = placement.ExecutionPlan.resolve(name), jplacement.ExecutionPlan.resolve(name)
    assert (t.embeddings, t.lm_head) == (j.embeddings, j.lm_head)
    assert placement.ExecutionPlan.resolve(None) == placement.ExecutionPlan()
    assert placement.ExecutionPlan.resolve(t) is t


def test_unknown_plan_raises_as_jax(dirs):
    with pytest.raises(InvalidConfigError) as t_err:
        placement.ExecutionPlan.resolve("offload_everything")
    with pytest.raises(Exception) as j_err:
        jplacement.ExecutionPlan.resolve("offload_everything")
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(InvalidConfigError, match="unknown execution plan"):
        DecoderLM(dirs["untied"], device="cpu", execution_plan="offload_everything")


@pytest.mark.parametrize("quantize", [None, "int4"])
@pytest.mark.parametrize("plan", PLANS)
def test_offload_plans_equal_jax_default(dirs, jax_outputs, host_calls, plan, quantize):
    lm = DecoderLM(dirs["untied"], device="cpu", max_context=MAX_CONTEXT,
                   quantize=quantize, execution_plan=plan)
    embed_host = plan != "offload_head"
    head_host = plan != "offload_embeddings" and quantize is None  # a dict head stays
    assert (lm.config.embed_on_host, lm.config.lm_head_on_host) == (embed_host, head_host)
    assert isinstance(lm.params["lm_head"], dict) == (quantize == "int4")
    assert _outputs(lm) == jax_outputs("untied", quantize)
    assert (host_calls["gather"] > 0) == embed_host
    assert (host_calls["matmul"] > 0) == head_host


def test_tied_offload_ends_holds_one_host_copy(dirs, jax_outputs, monkeypatch):
    """The tied head is a view of the table: offload_ends moves the table
    once and keeps the head a view of the host copy; offload_head alone
    copies the head and leaves the table where it was, for the lookup. On
    the CPU a move to host memory is no copy, so the test makes it one."""
    monkeypatch.setattr(decoder_lm, "to_host_memory", lambda x: x.clone())
    base = DecoderLM(dirs["tied"], device="cpu", max_context=MAX_CONTEXT)

    def shares(a, b):
        return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    assert shares(base.params["lm_head"], base.params["embed"])

    ends = DecoderLM(dirs["tied"], device="cpu", max_context=MAX_CONTEXT,
                     execution_plan="offload_ends")
    assert shares(ends.params["lm_head"], ends.params["embed"])
    assert torch.equal(ends.params["lm_head"], base.params["lm_head"])
    assert _outputs(ends) == jax_outputs("tied", None)

    head = DecoderLM(dirs["tied"], device="cpu", max_context=MAX_CONTEXT,
                     execution_plan="offload_head")
    assert not shares(head.params["lm_head"], head.params["embed"])
    assert not head.config.embed_on_host and head.config.lm_head_on_host
    assert _outputs(head) == jax_outputs("tied", None)


def test_engine_and_speculative_under_offload_ends(dirs, host_calls):
    """The continuous engine ([S] per-row positions, batched admission) and
    the speculative loop (k + 1 rows in the target pass) take the host
    gather and head at their own shapes, with the device plan's ids."""
    from kjarni_tpu_torch.generate.continuous import ContinuousEngine
    from kjarni_tpu_torch.generate.speculative import SpeculativeGenerator
    kw = dict(device="cpu", max_context=MAX_CONTEXT)
    out = {}
    for plan in (None, "offload_ends"):
        lm = DecoderLM(dirs["untied"], execution_plan=plan, **kw)
        eng = ContinuousEngine(lm, slots=2, steps_per_sync=4)
        rids = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
        done = {fr.request_id: fr.token_ids for fr in eng.run()}
        draft = DecoderLM(dirs["tied"], execution_plan=plan, **kw)
        spec = SpeculativeGenerator(lm, draft, num_tokens=3)
        out[plan] = ([done[r] for r in rids], spec.generate(PROMPTS[2], config=_greedy(10)))
    assert out["offload_ends"] == out[None]
    assert host_calls["gather"] > 0 and host_calls["matmul"] > 0


# ---------------------------------------------------------------------------
# the native checkpoint
# ---------------------------------------------------------------------------

def _assert_bit_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}/{k}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_checkpoint_round_trip_equals_jax(dirs, jax_outputs, tmp_path, quantize):
    out = convert_model(dirs["untied"], tmp_path / "ckpt", dtype="f32",
                        max_context=MAX_CONTEXT, quantize=quantize, device="cpu")
    assert has_checkpoint(out) and (out / "tokenizer.json").exists()
    want = DecoderLM(dirs["untied"], device="cpu", max_context=MAX_CONTEXT,
                     quantize=quantize)
    got = DecoderLM(out, device="cpu", max_context=MAX_CONTEXT, quantize=quantize)
    _assert_bit_equal(got.params, want.params)
    if quantize is None:
        assert want.params["embed"].dtype == torch.float32
    else:
        key = "w4" if quantize == "int4" else "w"
        assert got.params["layers"]["q"][key].dtype == torch.int8
    if quantize == "int8":   # not in the JAX fixture's cache: one more reference
        jlm = JaxDecoderLM(dirs["untied"], max_context=MAX_CONTEXT, quantize="int8")
        assert got.generate(PROMPTS[0], config=_greedy(12)) == \
            jlm.generate(PROMPTS[0], config=_greedy(12, jax=True))
        assert got._session_ids == jlm._session_ids
    else:
        assert _outputs(got) == jax_outputs("untied", quantize)


def test_checkpoint_keeps_the_tied_head_a_view(dirs, tmp_path):
    out = convert_model(dirs["tied"], tmp_path / "ckpt", max_context=MAX_CONTEXT,
                        device="cpu")
    lm = DecoderLM(out, device="cpu", max_context=MAX_CONTEXT)
    p = lm.params
    assert p["lm_head"].untyped_storage().data_ptr() == p["embed"].untyped_storage().data_ptr()
    _assert_bit_equal(p, DecoderLM(dirs["tied"], device="cpu",
                                   max_context=MAX_CONTEXT).params)
    # a plan applies to a checkpoint as to safetensors
    ends = DecoderLM(out, device="cpu", max_context=MAX_CONTEXT,
                     execution_plan="offload_ends")
    assert ends.config.embed_on_host and ends.config.lm_head_on_host


def test_save_and_load_a_tree(tmp_path):
    tree = {"a": torch.ones(4, 4), "nested": {"b": torch.arange(8, dtype=torch.int32),
                                              "c": torch.zeros(3, dtype=torch.int8)}}
    assert load_checkpoint(tmp_path) is None and not has_checkpoint(tmp_path)
    save_checkpoint(tree, tmp_path)
    save_checkpoint(tree, tmp_path)   # a second save replaces the first
    assert has_checkpoint(tmp_path)
    _assert_bit_equal(load_checkpoint(tmp_path, "cpu"), tree)


def test_jax_orbax_checkpoint_raises_the_ports_error(dirs, tmp_path):
    from kjarni_tpu.weights.checkpoint import convert_model as jax_convert
    out = jax_convert(dirs["untied"], tmp_path / "orbax", dtype="f32",
                      max_context=MAX_CONTEXT)
    assert (out / CHECKPOINT_DIR).is_dir()
    with pytest.raises(InvalidConfigError, match="Orbax.*convert_model"):
        DecoderLM(out, device="cpu", max_context=MAX_CONTEXT)
    with pytest.raises(InvalidConfigError, match="convert_model"):
        load_checkpoint(out)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_holds_the_annotated_span(dirs, tmp_path):
    lm = DecoderLM(dirs["untied"], device="cpu", max_context=MAX_CONTEXT)
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.annotate("kjarni-request"):
            lm.generate(PROMPTS[0], config=_greedy(4))
    trace = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "kjarni-request" in names
    assert any(e.key == "kjarni-request" for e in prof.key_averages())
    with profiling.annotate("outside a trace"):
        pass


def test_memory_reports_match_jax_structure(capsys):
    t, j = profiling.host_memory_mb(), jprofiling.host_memory_mb()
    assert t.keys() == j.keys() and t["rss_mb"] > 0
    assert t["peak_rss_mb"] >= t["rss_mb"] * 0.5
    report = profiling.device_memory_report()
    assert report and all("device" in r and "live_buffer_mb" in r for r in report)
    if not torch.cuda.is_available():
        assert report == [{"device": "cpu", "live_buffer_mb": None}]
    profiling.print_memory_usage()
    out = capsys.readouterr().out
    assert "host rss" in out
    if not torch.cuda.is_available():
        assert "cpu: memory stats unavailable" in out
