"""Tokenizer wrapper: ``tokenizer.json`` or SentencePiece backend,
incremental streaming decode, and chat templating.

The port's own copy of dynamo_tpu/tokenizer.py. Where the reference stands
on HF ``tokenizers`` and ``jinja2``, the port uses its stdlib readers:
``tokenizer_json.JsonTokenizer`` (encodes and decodes as ``tokenizers``
does) and ``chat_template.Template`` (renders the subset of Jinja that chat
templates use, as jinja2 with ``trim_blocks`` / ``lstrip_blocks``).
``DecodeStream`` is the reference's windowed decode-diff: decode a small
trailing window with and without the new token and emit the difference,
holding output while it ends in an incomplete UTF-8 replacement char.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Sequence

from dynamo_tpu_torch.chat_template import Template
from dynamo_tpu_torch.tokenizer_json import JsonTokenizer

# Default template: ChatML-ish, used when a model ships no chat template.
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|im_start|>{{ message['role'] }}\n{{ message['content'] }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)

_REPLACEMENT_CHAR = "�"


@dataclass
class Encoding:
    ids: list[int]
    tokens: list[str]


class DecodeStream:
    """Incremental detokenizer for one sequence."""

    def __init__(self, tokenizer: "TokenizerWrapper", window: int = 10) -> None:
        self._tok = tokenizer
        self._window = window
        self._ids: list[int] = []
        self._prefix_text = ""
        self._prefix_index = 0  # index into self._ids where the window starts

    def step(self, token_id: int) -> str:
        """Feed one token id, return newly-decodable text (possibly "")."""
        self._ids.append(token_id)
        window_ids = self._ids[self._prefix_index :]
        text = self._tok.decode(window_ids)
        if text.endswith(_REPLACEMENT_CHAR):
            # mid multi-byte sequence; wait for more tokens
            return ""
        new_text = text[len(self._prefix_text) :]
        # slide the window forward to bound decode cost
        if len(window_ids) >= self._window:
            keep = max(1, self._window // 2)
            self._prefix_index = len(self._ids) - keep
            self._prefix_text = self._tok.decode(self._ids[self._prefix_index :])
        else:
            self._prefix_text = text
        return new_text


class TokenizerWrapper:
    """Wraps a ``JsonTokenizer`` or a native SentencePiece model
    (sp_tokenizer.SentencePieceTokenizer); both expose the same
    encode/decode surface."""

    def __init__(self, backend, eos_token_ids: Sequence[int] = ()) -> None:
        self._backend = backend
        self.eos_token_ids = list(eos_token_ids)
        # raw .model bytes when SP-backed (carried by model cards)
        self.sp_model_bytes: Optional[bytes] = None

    @property
    def kind(self) -> str:
        return "sp" if self.sp_model_bytes is not None else "hf"

    # ----------------------------------------------------------- factory

    @classmethod
    def from_file(cls, path: str, eos_token_ids: Sequence[int] = ()) -> "TokenizerWrapper":
        return cls(JsonTokenizer.from_file(path), eos_token_ids)

    @classmethod
    def from_json_str(
        cls, data: str, eos_token_ids: Sequence[int] = ()
    ) -> "TokenizerWrapper":
        return cls(JsonTokenizer(data), eos_token_ids)

    @classmethod
    def from_sp_bytes(
        cls, data: bytes, eos_token_ids: Sequence[int] = ()
    ) -> "TokenizerWrapper":
        from dynamo_tpu_torch.sp_tokenizer import (
            SentencePieceTokenizer,
            parse_model_proto,
        )

        sp = SentencePieceTokenizer(parse_model_proto(data))
        ids = list(eos_token_ids) or (
            [sp.model.eos_id] if sp.model.eos_id >= 0 else []
        )
        tok = cls(sp, ids)
        tok.sp_model_bytes = data
        return tok

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "TokenizerWrapper":
        """``tokenizer.json`` (else ``tokenizer.model``) of an HF directory;
        EOS ids from ``config.json``'s ``eos_token_id``, else from
        ``tokenizer_config.json``'s ``eos_token``."""
        from dynamo_tpu_torch.sp_tokenizer import sp_model_path

        tok_path = os.path.join(model_dir, "tokenizer.json")
        sp_path = None if os.path.exists(tok_path) else sp_model_path(model_dir)
        if not os.path.exists(tok_path) and sp_path is None:
            raise FileNotFoundError(
                f"no tokenizer.json or tokenizer.model in {model_dir}"
            )
        if sp_path is not None:
            with open(sp_path, "rb") as f:
                sp_bytes = f.read()
            base = cls.from_sp_bytes(sp_bytes)
            backend = base._backend
        else:
            backend = JsonTokenizer.from_file(tok_path)
            base = None
        eos_ids: list[int] = []
        cfg_path = os.path.join(model_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            raw = cfg.get("eos_token_id")
            if isinstance(raw, int):
                eos_ids = [raw]
            elif isinstance(raw, list):
                eos_ids = [int(x) for x in raw]
        if not eos_ids:
            # fall back to tokenizer_config.json's eos_token string
            tc_path = os.path.join(model_dir, "tokenizer_config.json")
            if os.path.exists(tc_path):
                with open(tc_path) as f:
                    tc = json.load(f)
                eos_tok = tc.get("eos_token")
                if isinstance(eos_tok, dict):
                    eos_tok = eos_tok.get("content")
                if eos_tok:
                    tid = backend.token_to_id(eos_tok)
                    if tid is not None:
                        eos_ids = [tid]
        if base is not None:
            if eos_ids:
                base.eos_token_ids = eos_ids
            return base
        return cls(backend, eos_ids)

    # --------------------------------------------------------------- api

    def encode(self, text: str, add_special_tokens: bool = True) -> Encoding:
        enc = self._backend.encode(text, add_special_tokens=add_special_tokens)
        return Encoding(ids=list(enc.ids), tokens=list(enc.tokens))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._backend.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def decode_stream(self) -> DecodeStream:
        return DecodeStream(self)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._backend.token_to_id(token)

    @property
    def vocab_size(self) -> int:
        return self._backend.get_vocab_size()

    def to_json_str(self) -> str:
        return self._backend.to_str()


class ChatTemplate:
    """The HF tokenizer_config.json ``chat_template``, rendered by the
    port's Jinja subset (``chat_template.Template``)."""

    def __init__(
        self,
        template: Optional[str] = None,
        bos_token: str = "",
        eos_token: str = "",
    ) -> None:
        self.source = template or DEFAULT_CHAT_TEMPLATE
        self._template = Template(self.source)
        self.bos_token = bos_token
        self.eos_token = eos_token

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "ChatTemplate":
        tc_path = os.path.join(model_dir, "tokenizer_config.json")
        template = None
        bos = eos = ""
        if os.path.exists(tc_path):
            with open(tc_path) as f:
                tc = json.load(f)
            template = tc.get("chat_template")
            if isinstance(template, list):  # multiple named templates
                template = next(
                    (
                        t.get("template")
                        for t in template
                        if t.get("name") == "default"
                    ),
                    template[0].get("template") if template else None,
                )
            for name in ("bos_token", "eos_token"):
                val = tc.get(name)
                if isinstance(val, dict):
                    val = val.get("content")
                if name == "bos_token":
                    bos = val or ""
                else:
                    eos = val or ""
        return cls(template, bos, eos)

    def render(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: Optional[list[dict]] = None,
        **extra,
    ) -> str:
        """The prompt text; raises ValueError (``TemplateError``) when the
        template calls ``raise_exception`` or misuses an undefined value."""
        return self._template.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=self.bos_token,
            eos_token=self.eos_token,
            tools=tools,
            **extra,
        )

