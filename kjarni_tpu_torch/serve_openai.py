"""OpenAI-compatible API surface over the kjarni serving engine (copy of
kjarni_tpu/serve_openai.py, over the port's tasks).

`/v1/completions` and `/v1/chat/completions` accept the OpenAI request
schema (prompt/messages, max_tokens, temperature, top_p, stop, n, seed,
stream) and return OpenAI-shaped responses, so OpenAI SDK clients point at a
kjarni server by switching base_url. They ride the same task cache, model
locks and watchdog as the native /v1/* endpoints (serve.py). Under
`--scheduler continuous`, non-streaming generations route through the
continuous-batching engine, so concurrent requests share decode steps.

Chat requests are STATELESS per call (the OpenAI contract): the messages
list is templated through the model's chat template each time, unlike the
session-keeping native /v1/chat.
"""

from __future__ import annotations

import contextlib

import time
import uuid
from typing import Iterator, Optional

from .chat_templates import Conversation, Message
from .core.errors import KjarniError
from .generate.sampling import GenerationConfig, SamplingParams


def _num(body: dict, key: str, default, cast):
    """OpenAI allows explicit JSON null for optional numeric fields —
    treat null exactly like an omitted field instead of 500ing."""
    v = body.get(key)
    if v is None:
        return default
    try:
        return cast(v)
    except (TypeError, ValueError):
        raise KjarniError(f"invalid value for '{key}': {v!r}")


def _gen_config(body: dict, lm, default_max: int = 16) -> GenerationConfig:
    temp = _num(body, "temperature", 1.0, float)
    max_tokens = _num(body, "max_tokens", default_max, int)
    seed = body.get("seed")
    # max_length gates prompt+completion in generate_stream; its library
    # default (100) would silently truncate real SDK traffic
    max_length = lm.max_context
    if temp <= 0:
        return GenerationConfig.greedy(max_new_tokens=max_tokens,
                                       max_length=max_length)
    return GenerationConfig(
        strategy="sample", max_new_tokens=max_tokens, seed=seed,
        max_length=max_length,
        sampling=SamplingParams(temperature=temp,
                                top_p=_num(body, "top_p", 1.0, float),
                                top_k=0, min_p=0.0))


def _choice_cfg(cfg: GenerationConfig, i: int) -> GenerationConfig:
    """Per-choice seed derivation: n>1 with a fixed seed must not return n
    identical completions."""
    if cfg.seed is None or i == 0:
        return cfg
    import dataclasses
    return dataclasses.replace(cfg, seed=cfg.seed + i)


def _n_choices(body: dict) -> int:
    n = _num(body, "n", 1, int)
    if n < 1:
        raise KjarniError(f"'n' must be >= 1, got {n}")
    if n > 8:
        raise KjarniError(f"'n' > 8 is not supported (got {n})")
    return n


def _stop_list(body: dict, extra: list[str] = ()) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        stops = []
    elif isinstance(stop, str):
        stops = [stop]
    else:
        stops = [str(s) for s in stop[:4]]   # OpenAI caps at 4
    # empty strings match at offset 0 and would erase the whole completion
    return [s for s in stops if s] + [s for s in extra if s]


def _truncate_at_stops(text: str, stops: list[str]) -> tuple[str, bool]:
    cut = len(text)
    for s in stops:
        i = text.find(s)
        if i != -1:
            cut = min(cut, i)
    return text[:cut], cut < len(text)


def _finish_and_text(lm, toks: list[int], max_tokens: int,
                     stops: list[str], eos_hit: Optional[bool] = None):
    text = lm.tokenizer.decode(toks, skip_special_tokens=True)
    text, hit = _truncate_at_stops(text, stops)
    if eos_hit is None:
        eos_hit = len(toks) < max_tokens
    finish = "stop" if hit or eos_hit else "length"
    return text, finish


def _run_one(engine, gen, prompt_ids: list, cfg: GenerationConfig,
             stops: list[str]):
    """One generation -> (text, finish_reason, completion_tokens). Routes
    through the continuous-batching engine when the server is configured
    with it (concurrent OpenAI requests then share decode steps);
    otherwise the per-model-lock streaming path."""
    lm = gen._lm
    if getattr(engine, "scheduler", None) == "continuous":
        sampling = (None if cfg.strategy == "greedy" else cfg.sampling)
        fr = engine._continuous(gen).submit_full(
            token_ids=prompt_ids, max_new_tokens=cfg.max_new_tokens,
            sampling=sampling, seed=cfg.seed)
        text, finish = _finish_and_text(
            lm, fr.token_ids, cfg.max_new_tokens, stops,
            eos_hit=fr.finish_reason == "eos")
        return text, finish, len(fr.token_ids)
    toks: list[int] = []
    with engine._lm_lock(lm):
        for st in lm.generate_stream(token_ids=prompt_ids, config=cfg):
            toks.append(st.id)
    text, finish = _finish_and_text(lm, toks, cfg.max_new_tokens, stops)
    return text, finish, len(toks)


def _messages_to_prompt(lm, messages: list[dict]) -> str:
    conv = Conversation()
    for msg in messages:
        role = msg.get("role")
        content = str(msg.get("content", ""))
        if role == "system":
            conv.push(Message.system(content))
        elif role == "user":
            conv.push(Message.user(content))
        elif role == "assistant":
            conv.push(Message.assistant(content))
        else:
            raise KjarniError(f"unsupported message role '{role}'")
    return lm.chat_template.apply(conv)


def _base(kind: str, model: str) -> dict:
    return {"id": f"{'chatcmpl' if kind.startswith('chat') else 'cmpl'}-"
                  + uuid.uuid4().hex[:24],
            "object": kind,
            "created": int(time.time()),
            "model": model}


def completion(engine, body: dict) -> dict:
    """POST /v1/completions (non-streaming)."""
    gen = engine.get("generate", body.get("model"))
    lm = gen._lm
    prompts = body.get("prompt", "")
    if isinstance(prompts, str):
        prompts = [prompts]
    if not prompts:
        raise KjarniError("'prompt' must be a string or a non-empty list")
    n = _n_choices(body)
    cfg = _gen_config(body, lm)
    stops = _stop_list(body)
    choices = []
    total_prompt = total_completion = 0
    for prompt in prompts:
        # encode once: the counted ids ARE the ids generated from
        ids = lm.encode_prompt(prompt, True)
        total_prompt += len(ids)
        for i in range(n):
            text, finish, ct = _run_one(engine, gen, ids,
                                        _choice_cfg(cfg, i), stops)
            total_completion += ct
            choices.append({"text": text, "index": len(choices),
                            "logprobs": None, "finish_reason": finish})
    out = _base("text_completion", gen.model_id)
    out["choices"] = choices
    out["usage"] = {"prompt_tokens": total_prompt,
                    "completion_tokens": total_completion,
                    "total_tokens": total_prompt + total_completion}
    return out


def chat_completion(engine, body: dict) -> dict:
    """POST /v1/chat/completions (non-streaming, stateless per call)."""
    gen = engine.get("chat", body.get("model"))
    lm = gen._lm
    prompt = _messages_to_prompt(lm, body.get("messages", []))
    n = _n_choices(body)
    cfg = _gen_config(body, lm, default_max=256)
    stops = _stop_list(body, lm.chat_template.stop_sequences())
    ids = lm.encode_prompt(prompt, True)
    choices = []
    total_completion = 0
    for i in range(n):
        text, finish, ct = _run_one(engine, gen, ids,
                                    _choice_cfg(cfg, i), stops)
        total_completion += ct
        choices.append({"index": i,
                        "message": {"role": "assistant",
                                    "content": text.strip()},
                        "finish_reason": finish})
    out = _base("chat.completion", gen.model_id)
    out["choices"] = choices
    out["usage"] = {"prompt_tokens": len(ids),
                    "completion_tokens": total_completion,
                    "total_tokens": len(ids) + total_completion}
    return out


def stream(engine, path: str, body: dict):
    """SSE for {"stream": true}: yields OpenAI-shaped chunk dicts (the
    serve.py SSE writer emits any dict piece verbatim). Returns
    (chunk iterator, CancellationToken). Streaming is single-prompt,
    single-choice (the per-token path); text already sent cannot be
    retracted, so a hold-back buffer withholds the longest possible
    partial stop-string suffix until it is known not to complete a stop."""
    from .core.cancellation import CancellationToken
    cancel = CancellationToken()
    chat = path == "/v1/chat/completions"
    gen = engine.get("chat" if chat else "generate", body.get("model"))
    lm = gen._lm
    if _n_choices(body) != 1:
        raise KjarniError("streaming supports n=1 only")
    if chat:
        prompt = _messages_to_prompt(lm, body.get("messages", []))
        stops = _stop_list(body, lm.chat_template.stop_sequences())
        cfg = _gen_config(body, lm, default_max=256)
        base = _base("chat.completion.chunk", gen.model_id)
    else:
        prompt = body.get("prompt", "")
        if not isinstance(prompt, str):
            if len(prompt) != 1:
                raise KjarniError(
                    "streaming supports a single prompt (got "
                    f"{len(prompt)})")
            prompt = prompt[0]
        stops = _stop_list(body)
        cfg = _gen_config(body, lm)
        base = _base("text_completion", gen.model_id)
    lock = engine._lm_lock(lm)
    hold = max((len(s) for s in stops), default=1) - 1

    def chunk(piece=None, finish=None):
        if chat:
            delta = ({"content": piece} if piece is not None
                     else ({"role": "assistant"} if finish is None else {}))
            return {**base, "choices": [{"index": 0, "delta": delta,
                                         "finish_reason": finish}]}
        return {**base, "choices": [{"index": 0, "text": piece or "",
                                     "logprobs": None,
                                     "finish_reason": finish}]}

    def run() -> Iterator[dict]:
        with lock:
            if chat:
                yield chunk()            # role announcement chunk
            emitted = ""
            sent = 0
            n_toks = 0
            stopped = False
            with contextlib.closing(lm.generate_stream(
                    prompt, config=cfg, cancellation=cancel)) as steps:
                for st in steps:
                    n_toks += 1
                    emitted += st.text
                    cut, hit = _truncate_at_stops(emitted, stops)
                    if hit:
                        if cut > sent:
                            yield chunk(emitted[sent:cut])
                            sent = cut
                        stopped = True
                        break
                    # hold back text that could still become a stop prefix
                    safe = max(len(emitted) - hold, sent)
                    if safe > sent:
                        yield chunk(emitted[sent:safe])
                        sent = safe
            if not stopped and len(emitted) > sent:
                yield chunk(emitted[sent:])
            finish = ("stop" if stopped or n_toks < (cfg.max_new_tokens or 0)
                      else "length")
            yield chunk(finish=finish)

    return run(), cancel
