"""Conversation types + chat prompt templates.

Rebuild of kjarni-transformers/src/chat/ (templates.rs:7-168, llama3.rs,
chatml.rs, mistral.rs): the same prompt formats, stop sequences, and
Conversation semantics.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Role(str, enum.Enum):
    SYSTEM = "system"
    USER = "user"
    ASSISTANT = "assistant"


@dataclasses.dataclass
class Message:
    role: Role
    content: str

    @staticmethod
    def system(content: str) -> "Message":
        return Message(Role.SYSTEM, content)

    @staticmethod
    def user(content: str) -> "Message":
        return Message(Role.USER, content)

    @staticmethod
    def assistant(content: str) -> "Message":
        return Message(Role.ASSISTANT, content)


class Conversation:
    """Cf. templates.rs:57 Conversation."""

    def __init__(self, messages: Optional[list[Message]] = None):
        self.messages: list[Message] = list(messages or [])

    @staticmethod
    def with_system(system_prompt: str) -> "Conversation":
        return Conversation([Message.system(system_prompt)])

    def push_user(self, content: str) -> None:
        self.messages.append(Message.user(content))

    def push_assistant(self, content: str) -> None:
        self.messages.append(Message.assistant(content))

    def push(self, message: Message) -> None:
        self.messages.append(message)

    def last(self) -> Optional[Message]:
        return self.messages[-1] if self.messages else None

    @property
    def system_prompt(self) -> Optional[str]:
        if self.messages and self.messages[0].role == Role.SYSTEM:
            return self.messages[0].content
        return None

    def clear(self, keep_system: bool = False) -> None:
        sys_prompt = self.system_prompt if keep_system else None
        self.messages.clear()
        if sys_prompt is not None:
            self.messages.append(Message.system(sys_prompt))

    def turn_count(self) -> int:
        return sum(1 for m in self.messages if m.role != Role.SYSTEM)

    def drop_oldest_turn(self) -> bool:
        """Remove the oldest non-system turn (a user message plus its
        assistant reply, if present). The latest message is never dropped —
        long conversations forget their oldest turns, never the newest
        request (cf. the reference's hard context stop, generator.rs:322;
        here the product keeps going with a trimmed history instead).
        Returns False when nothing more is droppable.
        """
        msgs = self.messages
        for i, m in enumerate(msgs):
            if m.role == Role.SYSTEM:
                continue
            if i >= len(msgs) - 1:
                return False  # only the newest message remains
            del msgs[i]
            if i < len(msgs) - 1 and msgs[i].role == Role.ASSISTANT:
                del msgs[i]
            return True
        return False

    def __len__(self) -> int:
        return len(self.messages)


class ChatTemplate:
    """Cf. templates.rs:145 ChatTemplate trait."""

    def apply(self, conversation: Conversation) -> str:
        raise NotImplementedError

    def stop_sequences(self) -> list[str]:
        return []

    def default_system_prompt(self) -> Optional[str]:
        return None


class RawTemplate(ChatTemplate):
    """Concatenates message contents (base models), cf. templates.rs:168."""

    def apply(self, conversation: Conversation) -> str:
        return "\n".join(m.content for m in conversation.messages)


class Llama3ChatTemplate(ChatTemplate):
    """Cf. chat/llama3.rs."""

    BEGIN_OF_TEXT = "<|begin_of_text|>"
    END_OF_TEXT = "<|end_of_text|>"
    EOT = "<|eot_id|>"

    def __init__(self, add_bos: bool = True, add_generation_prompt: bool = True):
        self.add_bos = add_bos
        self.add_generation_prompt = add_generation_prompt

    def apply(self, conversation: Conversation) -> str:
        parts = []
        if self.add_bos:
            parts.append(self.BEGIN_OF_TEXT)
        for m in conversation.messages:
            parts.append(
                f"<|start_header_id|>{m.role.value}<|end_header_id|>\n\n"
                f"{m.content}{self.EOT}")
        if self.add_generation_prompt:
            parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(parts)

    def stop_sequences(self) -> list[str]:
        return [self.EOT, self.END_OF_TEXT]

    def default_system_prompt(self) -> Optional[str]:
        return "You are a helpful, harmless, and honest assistant."


class Llama2ChatTemplate(ChatTemplate):
    """Llama 2 Instruct legacy format (cf. chat/llama3.rs:160-230
    Llama2ChatTemplate):

        <s>[INST] <<SYS>>\\n{system}\\n<</SYS>>\\n\\n{user} [/INST] \
{assistant} </s><s>[INST] {user} [/INST]

    The system prompt rides inside the FIRST [INST] block; later system
    messages are ignored (Llama 2 has no mid-conversation system turns).
    """

    BOS = "<s>"
    EOS = "</s>"

    def __init__(self, add_bos: bool = True):
        self.add_bos = add_bos

    def apply(self, conversation: Conversation) -> str:
        msgs = list(conversation.messages)
        if not msgs:
            return ""
        system_content = None
        if msgs[0].role == Role.SYSTEM:
            system_content = msgs[0].content
            msgs = msgs[1:]
        out = []
        first_user = True
        for m in msgs:
            if m.role == Role.USER:
                if self.add_bos or not first_user:
                    out.append(self.BOS)
                out.append("[INST] ")
                if first_user:
                    if system_content is not None:
                        out.append(f"<<SYS>>\n{system_content}\n<</SYS>>\n\n")
                    first_user = False
                out.append(f"{m.content} [/INST]")
            elif m.role == Role.ASSISTANT:
                out.append(f" {m.content} {self.EOS}")
            # mid-conversation SYSTEM messages are ignored
        return "".join(out)

    def stop_sequences(self) -> list[str]:
        return [self.EOS]

    def default_system_prompt(self) -> Optional[str]:
        return "You are a helpful, respectful and honest assistant."


class ChatMLTemplate(ChatTemplate):
    """Qwen / ChatML format, cf. chat/chatml.rs."""

    def __init__(self, add_generation_prompt: bool = True):
        self.add_generation_prompt = add_generation_prompt

    def apply(self, conversation: Conversation) -> str:
        parts = [f"<|im_start|>{m.role.value}\n{m.content}<|im_end|>\n"
                 for m in conversation.messages]
        if self.add_generation_prompt:
            parts.append("<|im_start|>assistant\n")
        return "".join(parts)

    def stop_sequences(self) -> list[str]:
        return ["<|im_end|>"]

    def default_system_prompt(self) -> Optional[str]:
        return "You are a helpful assistant."


class MistralChatTemplate(ChatTemplate):
    """Cf. chat/mistral.rs: <s>[INST] {sys}\\n\\n{user} [/INST] {asst}</s>..."""

    def __init__(self, add_bos: bool = True):
        self.add_bos = add_bos

    def apply(self, conversation: Conversation) -> str:
        out = "<s>" if self.add_bos else ""
        system_content = None
        msgs = list(conversation.messages)
        if msgs and msgs[0].role == Role.SYSTEM:
            system_content = msgs[0].content
            msgs = msgs[1:]
        first_user = True
        for m in msgs:
            if m.role == Role.USER:
                out += "[INST] "
                if first_user:
                    if system_content:
                        out += system_content + "\n\n"
                    first_user = False
                out += m.content + " [/INST]"
            elif m.role == Role.ASSISTANT:
                out += " " + m.content + "</s>"
        return out

    def stop_sequences(self) -> list[str]:
        return ["</s>"]


class Phi3ChatTemplate(ChatTemplate):
    """Phi-3 instruct format: <|system|>...<|end|><|user|>...<|end|><|assistant|>."""

    def __init__(self, add_generation_prompt: bool = True):
        self.add_generation_prompt = add_generation_prompt

    def apply(self, conversation: Conversation) -> str:
        parts = [f"<|{m.role.value}|>\n{m.content}<|end|>\n"
                 for m in conversation.messages]
        if self.add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "".join(parts)

    def stop_sequences(self) -> list[str]:
        return ["<|end|>", "<|endoftext|>"]


def template_for_arch(arch: str) -> ChatTemplate:
    """Pick the template the reference would use for an architecture."""
    if arch == "llama":
        return Llama3ChatTemplate()
    if arch == "qwen2":
        return ChatMLTemplate()
    if arch == "mistral":
        return MistralChatTemplate()
    if arch == "phi3":
        return Phi3ChatTemplate()
    return RawTemplate()


def template_by_name(name: str) -> ChatTemplate:
    """Explicit template override (Chat(chat_template=...), CLI
    --chat-template): covers fine-tunes whose prompt format differs from
    the base architecture's default — the reason the reference keeps a
    Llama2 template around with no Llama-2 registry entry."""
    table = {"llama2": Llama2ChatTemplate, "llama3": Llama3ChatTemplate,
             "chatml": ChatMLTemplate, "mistral": MistralChatTemplate,
             "phi3": Phi3ChatTemplate, "raw": RawTemplate}
    cls = table.get(name.lower())
    if cls is None:
        raise ValueError(
            f"unknown chat template '{name}' (one of: {sorted(table)})")
    return cls()
