"""Conversation prompt templates.

Functional re-design of the reference's mutable Conversation class
(reference trace/conversation.py:21-129).  Production template for all
TRACE checkpoints is ``llama_2`` ([INST]...[/INST] wrapping —
scripts/inference/inference.py:30, conversation.py:383-394).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()
    QWEN = enum.auto()


@dataclasses.dataclass(frozen=True)
class Template:
    """Immutable prompt template; render with :meth:`prompt`."""

    system: str
    roles: Tuple[str, str]
    sep_style: SeparatorStyle
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "unknown"

    def prompt(self, messages: Sequence[Tuple[str, Optional[str]]]) -> str:
        """Render messages [(role, text-or-None), ...] to the model prompt.

        A ``None`` message means "generation point" (assistant turn to be
        produced).  Mirrors Conversation.get_prompt
        (reference: conversation.py:36-129) for each separator style.
        """
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret

        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret

        if self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret

        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg: str) -> str:
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"

            def wrap_inst(msg: str) -> str:
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message must be non-empty"
                    assert role == self.roles[0], "first message must be from user"
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
            return ret.lstrip(self.sep)

        if self.sep_style == SeparatorStyle.QWEN:
            ret = self.system + self.sep + "\n"
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + message + self.sep + "\n"
                else:
                    ret += role
            return ret

        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += message + seps[i % 2]
            return ret

        raise ValueError(f"Invalid separator style: {self.sep_style}")

    def prompt_chunks(
        self, messages: Sequence[Tuple[str, Optional[str]]]
    ) -> list[Tuple[str, bool]]:
        """Render to (text, supervised) chunks; ``"".join(texts) == prompt()``.

        Supervision follows the reference's per-template label masking
        (train_mt.py:470-723 preprocess_llama_2/v1/plain/qwen): assistant
        message text PLUS its trailing separator is supervised; system
        prompt, role markers, and user turns are not.  Because each chunk
        tokenizes independently, the offset-arithmetic "tokenization
        mismatch" failure mode (train_mt.py:542-548) cannot occur.
        """
        chunks: list[Tuple[str, bool]] = []

        if self.sep_style == SeparatorStyle.SINGLE:
            chunks.append((self.system + self.sep, False))
            for role, message in messages:
                if message:
                    sup = role == self.roles[1]
                    chunks.append((role + ": ", False))
                    chunks.append((message + self.sep, sup))
                else:
                    chunks.append((role + ":", False))
            return chunks

        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            chunks.append((self.system + seps[0], False))
            for i, (role, message) in enumerate(messages):
                if message:
                    sup = i % 2 == 1
                    chunks.append((role + ": ", False))
                    chunks.append((message + seps[i % 2], sup))
                else:
                    chunks.append((role + ":", False))
            return chunks

        if self.sep_style == SeparatorStyle.MPT:
            chunks.append((self.system + self.sep, False))
            for role, message in messages:
                if message:
                    chunks.append((role, False))
                    chunks.append((message + self.sep, role == self.roles[1]))
                else:
                    chunks.append((role, False))
            return chunks

        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg: str) -> str:
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"

            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message must be non-empty"
                    assert role == self.roles[0], "first message must be from user"
                if message:
                    if i % 2 == 0:
                        body = (wrap_sys(self.system) if i == 0 else "") + message
                        lead = self.sep if i > 0 else ""
                        chunks.append((f"{lead}[INST] {body} [/INST]", False))
                    else:
                        chunks.append((" " + message + " " + self.sep2, True))
            return chunks

        if self.sep_style == SeparatorStyle.QWEN:
            chunks.append((self.system + self.sep + "\n", False))
            for role, message in messages:
                if message:
                    chunks.append((role, False))
                    chunks.append(
                        (message + self.sep + "\n", role == self.roles[1])
                    )
                else:
                    chunks.append((role, False))
            return chunks

        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            chunks.append((self.system, False))
            for i, (role, message) in enumerate(messages):
                if message:
                    chunks.append((message + seps[i % 2], i % 2 == 1))
            return chunks

        raise ValueError(f"Invalid separator style: {self.sep_style}")

    def user_turn(self, text: str) -> Tuple[str, str]:
        return (self.roles[0], text)

    def assistant_turn(self, text: Optional[str] = None) -> Tuple[str, Optional[str]]:
        return (self.roles[1], text)

    @property
    def stop_str(self) -> str:
        """Decode-side stopping keyword (reference: inference.py:58)."""
        if self.sep_style == SeparatorStyle.SINGLE:
            return self.sep
        return self.sep2 if self.sep2 is not None else self.sep


LLAMA2_SYSTEM = (
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe.  Your answers should not include "
    "any harmful, unethical, racist, sexist, toxic, dangerous, or illegal "
    "content. Please ensure that your responses are socially unbiased and "
    "positive in nature.\n\nIf a question does not make any sense, or is not "
    "factually coherent, explain why instead of answering something not "
    "correct. If you don't know the answer to a question, please don't share "
    "false information."
)

TEMPLATES: dict[str, Template] = {}


def _register(names: Sequence[str], template: Template) -> Template:
    for n in names:
        TEMPLATES[n] = template
    return template

llama_2 = _register(
    ["llama_2"],
    Template(
        system=LLAMA2_SYSTEM,
        roles=("USER", "ASSISTANT"),
        sep_style=SeparatorStyle.LLAMA_2,
        sep="<s>",
        sep2="</s>",
        version="llama_v2",
    ),
)

mistral_instruct = _register(
    ["mistral_instruct"],
    Template(
        system=(
            "A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."
        ),
        roles=("USER", "ASSISTANT"),
        sep_style=SeparatorStyle.LLAMA_2,
        sep="",
        sep2="</s>",
        version="llama_v2",
    ),
)

vicuna_v1 = _register(
    ["v1", "vicuna_v1", "default"],
    Template(
        system=(
            "A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."
        ),
        roles=("USER", "ASSISTANT"),
        sep_style=SeparatorStyle.TWO,
        sep=" ",
        sep2="</s>",
        version="v1",
    ),
)

plain = _register(
    ["plain", "v0_plain"],
    Template(
        system="",
        roles=("", ""),
        sep_style=SeparatorStyle.PLAIN,
        sep="\n",
        sep2="\n",
        version="plain",
    ),
)

qwen = _register(
    ["qwen"],
    Template(
        system="<|im_start|>system\nYou are a helpful assistant.",
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        sep_style=SeparatorStyle.QWEN,
        sep="<|im_end|>",
        version="qwen",
    ),
)


def get_template(name: str) -> Template:
    return TEMPLATES[name]


def build_trace_prompt(
    instruction: str,
    template_name: str = "llama_2",
    modal_token: str = "<video>",
    append_sync: bool = True,
) -> str:
    """Assemble the production single-turn event-decoding prompt.

    Reference: scripts/inference/inference.py:49-54 — the modal tag leads the
    instruction, and the prompt is suffixed with ``<sync>`` so the head FSM
    (initial state = time head) starts decoding the first event's timestamps.

    An instruction that already contains the modal token keeps its own
    placement (Video-MME's with-subtitles setting puts subtitle text BEFORE
    the video token — reference videomme/evaluate.py:322-323).
    """
    tpl = get_template(template_name)
    content = (
        instruction if modal_token in instruction
        else f"{modal_token}\n{instruction}"
    )
    prompt = tpl.prompt([
        tpl.user_turn(content),
        tpl.assistant_turn(None),
    ])
    if append_sync:
        prompt += "<sync>"
    return prompt
