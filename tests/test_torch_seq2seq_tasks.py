"""kjarni_tpu_torch's Summarizer, Translator and Seq2SeqGenerator against the
JAX package's, on the CPU, in f32.

Both packages load tests/test_seq2seq_tasks.py's tiny BART (with
summarization task parameters) and FLAN-T5-style checkpoints and take the
same texts; the outputs must be equal strings: the beam tokens are exact in
f32 (tests/test_torch_seq2seq.py), so is the text decoded from them.
"""

import numpy as np
import pytest
import torch

from test_seq2seq_tasks import bart_dir, t5_dir  # noqa: F401  (fixtures)

from kjarni_tpu.tasks import translator as jtr
from kjarni_tpu.tasks.seq2seq import Seq2SeqGenerator as JaxSeq2SeqGenerator
from kjarni_tpu.tasks.seq2seq import Seq2SeqOverrides as JaxOverrides
from kjarni_tpu.tasks.summarizer import Summarizer as JaxSummarizer
from kjarni_tpu.tasks.translator import Translator as JaxTranslator
from kjarni_tpu_torch import Seq2SeqGenerator, Seq2SeqOverrides, Summarizer, Translator
from kjarni_tpu_torch.core.errors import InvalidConfigError, TaskValidationError
from kjarni_tpu_torch.tasks import translator as ttr

TEXTS = ["the quick data is safe and the service is great",
         "hello world the best purchase",
         "i love this product and the quality of the service is good and safe"]
OVERRIDES = [None, dict(num_beams=3, min_length=3, no_repeat_ngram_size=2),
             dict(num_beams=2, early_stopping=False, length_penalty=1.0)]


@pytest.fixture(scope="module")
def summarizers(bart_dir, t5_dir):  # noqa: F811
    return {"bart": (Summarizer(str(bart_dir), device="cpu", quiet=True),
                     JaxSummarizer(str(bart_dir), quiet=True)),
            "t5": (Summarizer(str(t5_dir), device="cpu", quiet=True),
                   JaxSummarizer(str(t5_dir), quiet=True))}


@pytest.fixture(scope="module")
def translators(t5_dir):  # noqa: F811
    return (Translator(str(t5_dir), default_from="en", default_to="fr", device="cpu",
                       quiet=True),
            JaxTranslator(str(t5_dir), default_from="en", default_to="fr", quiet=True))


def _ov(kw, cls):
    return None if kw is None else cls(**kw)


@pytest.mark.parametrize("family", ["bart", "t5"])
@pytest.mark.parametrize("oi", range(len(OVERRIDES)))
def test_summarize_equals_jax(summarizers, family, oi):
    port, ref = summarizers[family]
    for text in (TEXTS[0], TEXTS[2]):      # one length bucket: one JAX compile
        want = ref.summarize(text, overrides=_ov(OVERRIDES[oi], JaxOverrides))
        assert port.summarize(text, overrides=_ov(OVERRIDES[oi], Seq2SeqOverrides)) == want


@pytest.mark.parametrize("family", ["bart", "t5"])
def test_stream_equals_jax(summarizers, family):
    port, ref = summarizers[family]
    for text in (TEXTS[0], TEXTS[2]):
        kw = dict(max_length=6, num_beams=2)
        want = list(ref.stream(text, overrides=JaxOverrides(**kw)))
        got = list(port.stream(text, overrides=Seq2SeqOverrides(**kw)))
        assert got == want and got


def test_task_parameters_and_prefix(summarizers):
    port, ref = summarizers["bart"]
    tp, jtp = port._gen.lm.task_params, ref._gen.lm.task_params
    assert tp.keys() == jtp.keys() == {"summarization"}
    assert vars(tp["summarization"]) == vars(jtp["summarization"])
    assert tp["summarization"].num_beams == 2 and tp["summarization"].max_length == 16
    assert not port._needs_prefix and summarizers["t5"][0]._needs_prefix
    lm = port._gen.lm
    assert lm.max_decode_len == ref._gen.lm.max_decode_len == 64 - 2   # BART positions
    assert lm.dtype == torch.float32 and lm.device.type == "cpu"


def test_translate_equals_jax(translators):
    port, ref = translators
    for text in TEXTS[:2]:
        for src, dst in (("en", "de"), ("English", "french"), ("deu", "es")):
            ov = Seq2SeqOverrides(max_length=6, num_beams=2)
            want = ref.translate(text, src, dst, overrides=JaxOverrides(max_length=6,
                                                                        num_beams=2))
            assert port.translate(text, src, dst, overrides=ov) == want
    assert port.translate_default(TEXTS[0]) == ref.translate_default(TEXTS[0])
    assert port.translate_to(TEXTS[1], "it") == ref.translate_to(TEXTS[1], "it")
    assert port.translate_from(TEXTS[1], "ja") == ref.translate_from(TEXTS[1], "ja")
    assert (port.default_from, port.default_to) == ("English", "French")


def test_language_helpers_equal_jax():
    for lang in ("en", "GERMAN", "deu", "klingon", "ja", "zho", "Romanian", "ron", ""):
        assert ttr.normalize_language(lang) == jtr.normalize_language(lang)
        assert ttr.is_supported_language(lang) == jtr.is_supported_language(lang)
    for name in ttr.SUPPORTED_LANGUAGES:
        assert ttr.language_code(name) == jtr.language_code(name)
    assert ttr.SUPPORTED_LANGUAGES == jtr.SUPPORTED_LANGUAGES


def test_unknown_language_raises(translators):
    port, _ = translators
    with pytest.raises(TaskValidationError):
        port.translate("hi", "klingon", "en")
    with pytest.raises(TaskValidationError):
        port.translate("hi", "en", "elvish")


def test_seq2seq_generator_equals_jax(summarizers):
    """The generator under each Summarizer, called with and without the task."""
    for family in ("bart", "t5"):
        gen, ref = summarizers[family][0]._gen, summarizers[family][1]._gen
        assert isinstance(gen, Seq2SeqGenerator) and isinstance(ref, JaxSeq2SeqGenerator)
        assert gen.is_t5 == ref.is_t5 == (family == "t5")
        for task in (None, "summarization"):
            assert gen.generate(TEXTS[0], task=task) == ref.generate(TEXTS[0], task=task)
        ov = Seq2SeqOverrides(num_beams=3, max_length=5)
        assert ov.kwargs() == {"num_beams": 3, "max_length": 5}
        assert gen.generate(TEXTS[1], overrides=ov) == ref.generate(
            TEXTS[1], overrides=JaxOverrides(num_beams=3, max_length=5))


def test_tasks_need_the_card_unless_asked_for_the_cpu(bart_dir, t5_dir):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    for cls, d in ((Summarizer, bart_dir), (Translator, t5_dir),
                   (Seq2SeqGenerator, bart_dir)):
        with pytest.raises(InvalidConfigError, match="device='cpu'"):
            cls(str(d))


def test_stream_callback_path_equals_device_loop(summarizers):
    """Both loops of one model give one answer (the host loop drives stream)."""
    port, _ = summarizers["bart"]
    lm = port._gen.lm
    for text in TEXTS:
        ids, mask = lm._encode_input(text)
        bs, _ = lm.beam_config(task="summarization")
        streamed = []
        host = lm._generate_host(bs, ids, mask, streamed.append)
        assert lm._generate_fused(bs, ids, mask) == host
        assert len(streamed) >= len(host) - 1 and np.all(np.asarray(streamed) >= 0)
