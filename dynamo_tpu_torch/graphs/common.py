"""Shared engine / model-card builders for the serve graphs.

The port's own copy of dynamo_tpu/graphs/common.py, with ``tiny-torch`` and
``torch`` engines in place of ``tiny-jax`` and ``jax``, and the word-level
card built on the port's ``tokenizer_json.py`` (the reference builds it with
the ``tokenizers`` package, which the card's machine lacks).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os

from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.tokenizer import TokenizerWrapper

# the tiny engine's shapes: the reference's tiny Llama at vocab 64, with a
# head_dim the card's attention kernels take (they take 64, 128 and 256)
TINY_VOCAB = 64
TINY_HEAD_DIM = 64
TINY_BLOCK = 16


def word_level_tokenizer_json(vocab_words: int = 61) -> str:
    """A WordLevel tokenizer.json: <unk>/<s>/</s> plus w0..wN, split on
    whitespace (what the reference's ``Tokenizer(models.WordLevel(...))``
    with a ``Whitespace`` pre-tokenizer serializes to)."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for i in range(vocab_words):
        vocab[f"w{i}"] = 3 + i
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
        "normalizer": None, "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    })


def word_level_mdc(name: str, vocab_words: int = 61) -> ModelDeploymentCard:
    """Self-contained word-level model card: enough vocabulary that a tiny
    random model's sampled ids always decode (no files on disk)."""
    tok = TokenizerWrapper.from_json_str(word_level_tokenizer_json(vocab_words), eos_token_ids=[2])
    return ModelDeploymentCard.from_tokenizer(name, tok, kv_block_size=TINY_BLOCK)


def model_name() -> str:
    return os.environ.get("DYN_MODEL_NAME", "graph-model")


async def build_engine_from_env():
    """(engine, mdc) per DYN_GRAPH_ENGINE: echo | tiny-torch | torch."""
    kind = os.environ.get("DYN_GRAPH_ENGINE", "echo")
    if kind == "echo":
        from dynamo_tpu_torch.engine.echo import EchoEngineCore

        return EchoEngineCore(), word_level_mdc(model_name())
    loop = asyncio.get_running_loop()
    if kind == "tiny-torch":
        # built off the event loop: the weights and the cache take seconds
        # on a card, which would starve the fabric lease's keepalive
        engine = await loop.run_in_executor(None, build_tiny_torch_engine)
        return engine, word_level_mdc(model_name())
    if kind == "torch":
        path = os.environ.get("DYN_MODEL_PATH")
        if not path:
            raise SystemExit("DYN_GRAPH_ENGINE=torch requires DYN_MODEL_PATH")

        def build():  # the factory's import (torch, seconds) off the loop too
            from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine

            return build_torch_engine(
                path, device=os.environ.get("DYN_DEVICE", "cuda"),
                tensor_parallel_size=int(os.environ.get("DYN_TP", "1")),
                max_batch=int(os.environ.get("DYN_MAX_BATCH", "8")),
            )

        engine = await loop.run_in_executor(None, build)
        mdc = ModelDeploymentCard.from_model_dir(path, model_name(),
                                                 context_length=engine.config.max_model_len)
        return engine, mdc
    raise SystemExit(f"unknown DYN_GRAPH_ENGINE={kind!r} (echo, tiny-torch or torch)")


def build_tiny_torch_engine(**overrides):
    """A TorchEngine at test scale on ``DYN_DEVICE`` (default the card):
    the tiny Llama with seeded weights (seed 0), so every worker in the
    graph holds identical weights."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=TINY_VOCAB), head_dim=TINY_HEAD_DIM)
    kw = dict(device=os.environ.get("DYN_DEVICE", "cuda"), kv_block_size=TINY_BLOCK,
              max_batch=4, num_blocks=128, max_model_len=512, seed=0)
    kw.update(overrides)
    return build_torch_engine(cfg, **kw)
