"""ModelDeploymentCard: what a frontend needs to serve a model -- its
tokenizer, chat template, context window and KV block size.

The port's own copy of dynamo_tpu/model_card.py: ``from_model_dir``,
``from_tokenizer``, ``load_tokenizer``, ``load_chat_template``, and the
fabric half -- ``to_json`` / ``from_json`` (the same JSON as the JAX
package's, so a card one package publishes the other loads), ``publish``
(the card and its tokenizer blob into the fabric object store) and
``download``.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional

from dynamo_tpu_torch.tokenizer import ChatTemplate, TokenizerWrapper

MDC_BUCKET = "mdc"
DEFAULT_CONTEXT_LENGTH = 8192
DEFAULT_KV_BLOCK_SIZE = 16


def slugify(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_.-]+", "--", name)


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
    # the tokenizer blob's name in the object store, set by publish()
    tokenizer_obj: Optional[str] = None
    # "hf" (tokenizer.json) or "sp" (SentencePiece .model protobuf)
    tokenizer_kind: str = "hf"
    extra: dict[str, Any] = field(default_factory=dict)
    # the tokenizer's source, local and never serialized: tokenizer.json
    # text or the sp model's bytes
    _tokenizer_json: Optional[str] = None
    _tokenizer_sp: Optional[bytes] = None

    @property
    def slug(self) -> str:
        return slugify(self.name)

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

    @classmethod
    def from_model_path(
        cls,
        path: str,
        name: Optional[str] = None,
        kv_block_size: int = DEFAULT_KV_BLOCK_SIZE,
        context_length: Optional[int] = None,
    ) -> "ModelDeploymentCard":
        """The card of a resolved model path (``hub.resolve_model``): a
        directory's (``from_model_dir``), or a ``.gguf`` file's
        (the JAX factory's ``_gguf_model_card``, :348-390): tokenizer files
        beside it win, else the tokenizer and chat template embedded in its
        metadata, with its bos / eos strings."""
        if not path.endswith(".gguf"):
            return cls.from_model_dir(path, name, kv_block_size=kv_block_size,
                                      context_length=context_length)
        from dynamo_tpu_torch.gguf import GgufFile, tokenizer_from_gguf

        card_name = name or os.path.basename(path).removesuffix(".gguf")
        try:
            return cls.from_model_dir(os.path.dirname(os.path.abspath(path)), card_name,
                                      kv_block_size=kv_block_size, context_length=context_length)
        except FileNotFoundError:
            pass
        g = GgufFile(path)
        try:
            tok = tokenizer_from_gguf(g)
            if tok is None:
                raise FileNotFoundError(
                    f"{path}: no tokenizer.json/tokenizer.model beside the file and no "
                    "tokenizer.ggml metadata inside it"
                )
            md = g.metadata
        finally:
            g.close()
        tokens = md.get("tokenizer.ggml.tokens") or []

        def tok_str(key: str) -> str:
            # chat templates use '{{ bos_token }}': the strings must be there
            tid = md.get(key)
            return tokens[tid] if isinstance(tid, int) and 0 <= tid < len(tokens) else ""

        ctx = context_length or md.get(f"{md.get('general.architecture', 'llama')}.context_length")
        return cls.from_tokenizer(
            card_name, tok, chat_template=md.get("tokenizer.chat_template"),
            bos_token=tok_str("tokenizer.ggml.bos_token_id"),
            eos_token=tok_str("tokenizer.ggml.eos_token_id"),
            kv_block_size=kv_block_size,
            context_length=int(ctx or DEFAULT_CONTEXT_LENGTH),
        )

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

    # --------------------------------------------------------- serialize

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "model_type": self.model_type,
            "context_length": self.context_length,
            "kv_block_size": self.kv_block_size,
            "chat_template": self.chat_template,
            "bos_token": self.bos_token,
            "eos_token": self.eos_token,
            "eos_token_ids": self.eos_token_ids,
            "tokenizer_obj": self.tokenizer_obj,
            "tokenizer_kind": self.tokenizer_kind,
            "extra": self.extra,
        })

    @classmethod
    def from_json(cls, data: str) -> "ModelDeploymentCard":
        d = json.loads(data)
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    # ----------------------------------------------------- fabric upload

    async def publish(self, fabric: Any) -> None:
        """Upload the tokenizer blob and the card to the fabric object store
        (``fabric``: a ``fabric.client.FabricClient``)."""
        if self.tokenizer_kind == "sp" and self._tokenizer_sp is not None:
            self.tokenizer_obj = f"{self.slug}/tokenizer.model"
            await fabric.obj_put(MDC_BUCKET, self.tokenizer_obj, self._tokenizer_sp)
        elif self._tokenizer_json is not None:
            self.tokenizer_obj = f"{self.slug}/tokenizer.json"
            await fabric.obj_put(MDC_BUCKET, self.tokenizer_obj, self._tokenizer_json.encode())
        await fabric.obj_put(MDC_BUCKET, f"{self.slug}/card.json", self.to_json().encode())

    @classmethod
    async def download(cls, fabric: Any, slug: str) -> "ModelDeploymentCard":
        raw = await fabric.obj_get(MDC_BUCKET, f"{slug}/card.json")
        if raw is None:
            raise KeyError(f"no model card {slug!r} in object store")
        card = cls.from_json(raw.decode())
        if card.tokenizer_obj:
            blob = await fabric.obj_get(MDC_BUCKET, card.tokenizer_obj)
            if blob is not None:
                if card.tokenizer_kind == "sp":
                    card._tokenizer_sp = blob
                else:
                    card._tokenizer_json = blob.decode()
        return card

    # ----------------------------------------------------------- loaders

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
