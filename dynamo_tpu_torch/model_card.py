"""ModelDeploymentCard: what a frontend needs to serve a model -- its
tokenizer, chat template, context window and KV block size.

The port's own copy of dynamo_tpu/model_card.py (``from_model_dir``,
``from_tokenizer``, ``load_tokenizer``, ``load_chat_template``). The
reference also publishes cards to the fabric object store and downloads
them; the port serves one local engine and has no fabric yet, so those are
left out.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

from dynamo_tpu_torch.tokenizer import ChatTemplate, TokenizerWrapper

DEFAULT_CONTEXT_LENGTH = 8192
DEFAULT_KV_BLOCK_SIZE = 16


@dataclass
class ModelDeploymentCard:
    name: str
    model_type: str = "chat"  # chat | completion | both
    context_length: int = DEFAULT_CONTEXT_LENGTH
    kv_block_size: int = DEFAULT_KV_BLOCK_SIZE
    chat_template: Optional[str] = None
    bos_token: str = ""
    eos_token: str = ""
    eos_token_ids: list[int] = field(default_factory=list)
    # "hf" (tokenizer.json) or "sp" (SentencePiece .model protobuf)
    tokenizer_kind: str = "hf"
    extra: dict[str, Any] = field(default_factory=dict)
    # the tokenizer's source: tokenizer.json text or the sp model's bytes
    _tokenizer_json: Optional[str] = None
    _tokenizer_sp: Optional[bytes] = None

    @classmethod
    def from_model_dir(
        cls,
        model_dir: str,
        name: Optional[str] = None,
        model_type: str = "both",
        kv_block_size: int = DEFAULT_KV_BLOCK_SIZE,
        context_length: Optional[int] = None,
    ) -> "ModelDeploymentCard":
        """Build from an HF-style snapshot dir (config.json, tokenizer.json,
        tokenizer_config.json)."""
        tok = TokenizerWrapper.from_model_dir(model_dir)
        tpl = ChatTemplate.from_model_dir(model_dir)
        ctx = context_length
        cfg_path = os.path.join(model_dir, "config.json")
        if ctx is None and os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            ctx = cfg.get("max_position_embeddings") or cfg.get("n_positions")
        card = cls(
            name=name or os.path.basename(os.path.normpath(model_dir)),
            model_type=model_type,
            context_length=int(ctx or DEFAULT_CONTEXT_LENGTH),
            kv_block_size=kv_block_size,
            chat_template=tpl.source,
            bos_token=tpl.bos_token,
            eos_token=tpl.eos_token,
            eos_token_ids=tok.eos_token_ids,
        )
        card._attach_tokenizer(tok)
        return card

    def _attach_tokenizer(self, tok: TokenizerWrapper) -> None:
        if tok.kind == "sp":
            self.tokenizer_kind = "sp"
            self._tokenizer_sp = tok.sp_model_bytes
        else:
            self.tokenizer_kind = "hf"
            self._tokenizer_json = tok.to_json_str()

    @classmethod
    def from_tokenizer(
        cls,
        name: str,
        tokenizer: TokenizerWrapper,
        chat_template: Optional[str] = None,
        **kwargs: Any,
    ) -> "ModelDeploymentCard":
        card = cls(
            name=name,
            eos_token_ids=tokenizer.eos_token_ids,
            chat_template=chat_template,
            **kwargs,
        )
        card._attach_tokenizer(tokenizer)
        return card

    def load_tokenizer(self) -> TokenizerWrapper:
        if self.tokenizer_kind == "sp":
            if self._tokenizer_sp is None:
                raise RuntimeError(f"card {self.name}: tokenizer blob not loaded")
            return TokenizerWrapper.from_sp_bytes(self._tokenizer_sp, self.eos_token_ids)
        if self._tokenizer_json is None:
            raise RuntimeError(f"card {self.name}: tokenizer blob not loaded")
        return TokenizerWrapper.from_json_str(self._tokenizer_json, self.eos_token_ids)

    def load_chat_template(self) -> ChatTemplate:
        return ChatTemplate(self.chat_template, self.bos_token, self.eos_token)
