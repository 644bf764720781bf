"""Chat task API: conversation state and templated generation (port of
kjarni_tpu/tasks/chat.py; cf. kjarni/src/chat/model.rs:47)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

from ..chat_templates import Conversation, template_by_name
from ..core.cancellation import CancellationToken
from ..generate.sampling import GenerationConfig
from ..generate.stream import StreamedToken
from ..generate.speculative import SpeculativeGenerator
from ..models.decoder_lm import DecoderLM
from ..registry import ModelTask
from .common import Device, DownloadPolicy, resolve_model_dir
from .generator import resolve_generation_config

_CHAT_TASKS = (ModelTask.CHAT, ModelTask.REASONING)


class Chat:
    """Stateful chat over an instruct model (cf. chat/model.rs:47).

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str = "qwen2.5-0.5b-instruct", *,
                 system_prompt: Optional[str] = None,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 max_context: Optional[int] = None,
                 dtype: str = "auto",
                 quantize: Optional[str] = None,
                 tp: Optional[int] = None,
                 kv_cache: Optional[str] = None,
                 draft_model: Optional[str] = None,
                 draft_num_tokens: int = 4,
                 chat_template: Optional[str] = None,
                 offline: bool = False,
                 quiet: bool = False):
        self.device = Device.resolve(device)
        policy = DownloadPolicy.OFFLINE if offline else DownloadPolicy.ALLOW
        model_dir, info = resolve_model_dir(
            model, cache_dir, policy, quiet, _CHAT_TASKS, "chat")
        self.model_info = info
        self.model_id = info.cli_name if info else str(model)
        self._lm = DecoderLM(model_dir, dtype=dtype, max_context=max_context,
                             quantize=quantize, tp=tp, kv_cache=kv_cache,
                             device=self.device.torch_name)
        if chat_template is not None:
            # an explicit prompt format (e.g. "llama2" for a legacy
            # [INST]/<<SYS>> fine-tune) over the arch's default
            self._lm.chat_template = template_by_name(chat_template)
        self._spec = None
        if draft_model is not None:
            draft_dir, _ = resolve_model_dir(
                draft_model, cache_dir, policy, quiet, _CHAT_TASKS, "chat")
            self._spec = SpeculativeGenerator(
                self._lm, DecoderLM(draft_dir, dtype=dtype, max_context=max_context,
                                    device=self.device.torch_name),
                num_tokens=draft_num_tokens)
        if system_prompt is None:
            system_prompt = self._lm.chat_template.default_system_prompt()
        self._conversation = (Conversation.with_system(system_prompt)
                              if system_prompt else Conversation())

    @property
    def lm(self) -> DecoderLM:
        return self._lm

    @property
    def speculative(self) -> Optional[SpeculativeGenerator]:
        """The SpeculativeGenerator when a draft model is loaded, else None."""
        return self._spec

    @property
    def conversation(self) -> Conversation:
        return self._conversation

    def clear_history(self, keep_system: bool = True) -> None:
        self._conversation.clear(keep_system)

    def send(self, message: str, *, preset: Optional[str] = None,
             config: Optional[GenerationConfig] = None,
             cancellation: Optional[CancellationToken] = None,
             **overrides) -> str:
        """Send a message, append the reply to history, return the reply."""
        return "".join(st.text for st in self.stream(
            message, preset=preset, config=config, cancellation=cancellation,
            **overrides))

    def stream(self, message: str, *, preset: Optional[str] = None,
               config: Optional[GenerationConfig] = None,
               cancellation: Optional[CancellationToken] = None,
               **overrides) -> Iterator[StreamedToken]:
        """Streaming send (cf. chat/model.rs:275). History updates when the
        stream ends."""
        cfg = resolve_generation_config(
            preset, config, self._lm.default_generation_config(), **overrides)
        self._conversation.push_user(message)
        # the template holds BOS where the format wants one
        cfg = dataclasses.replace(cfg, add_bos_token=False)
        token_ids = self._encode()
        # drop the oldest turns (the system prompt and the newest message
        # stay) until the templated prompt fits the context
        budget = self._lm.max_context - 1
        while len(token_ids) > budget and self._conversation.drop_oldest_turn():
            token_ids = self._encode()

        # greedy turns take the speculative loop when a draft is loaded
        source = (self._spec.generate_stream
                  if self._spec is not None and cfg.strategy == "greedy"
                  else self._lm.generate_stream)

        def run():
            collected: list[str] = []
            stop_seqs = self._lm.chat_template.stop_sequences()
            for st in source(token_ids=token_ids, config=cfg, cancellation=cancellation):
                # stop sequences are usually special tokens the stream
                # decoder already drops; guard anyway
                if any(s in st.text for s in stop_seqs):
                    break
                collected.append(st.text)
                yield st
            self._conversation.push_assistant("".join(collected).strip())

        return run()

    def _encode(self) -> list[int]:
        prompt = self._lm.apply_chat_template(self._conversation)
        return self._lm.tokenizer.encode(prompt, add_special_tokens=False)


def chat_send(message: str, model: str = "qwen2.5-0.5b-instruct", *,
              device: Device | str | None = None) -> str:
    """One-liner (cf. kjarni/src/lib.rs:106 chat_send)."""
    return Chat(model, device=device).send(message)
