"""TorchModelRunner: owns the device state (parameters and the paged KV
cache) and runs prefill / decode + sampling.

Counterpart of dynamo_tpu/engine/jax_engine/model_runner.py (``prefill``
:1142 with ``_prefill_impl`` :490, ``prefill_chunk`` :1252 with
``_prefill_chunk_impl`` :542, ``pack_prefill`` :1323,
``prefill_packed_arrays`` :1371 with ``_prefill_packed_impl`` :562,
``mixed_step`` :980 with ``_mixed_impl`` :924, ``decode`` :1603 with
``_decode_impl`` :579, ``decode_multi`` :1646 with ``_decode_multi_impl``
:593, ``spec_verify`` :1696 with ``_spec_verify_impl`` :704,
``decode_multi_ready`` / ``prepare_decode_multi_async`` :1760-1767,
``fetch_sample`` :1049, ``default_prefill_buckets`` :41, the multimodal
``prefill_mm`` :1192 and the pooled ``embed`` :1299, the block data
plane ``extract_blocks*`` / ``inject_blocks*`` :1407-1601 over
:366-460):

  * the caches are single buffers written IN PLACE by every call (the JAX
    runner donates them through jit; PyTorch simply updates them);
  * prompts are padded to the same power-of-two buckets of whole KV blocks,
    so the prefill shapes match the JAX program set;
  * ``prefill_chunk_tokens`` (C, default 512, rounded up to whole blocks
    and capped at the largest bucket; 0 turns chunking off) sizes the
    chunked prefill's chunks and the packed prefill's token buffer; the
    engine routes prompts longer than C through ``prefill_chunk`` /
    ``mixed_step`` and packs shorter ones through ``pack_prefill`` /
    ``prefill_packed_arrays``;
  * ``mixed_step`` runs k chunk slots (in list order) and then the whole
    decode batch in one call; its inputs have one shape per k = 1..the
    engine's slot cap (C-wide chunks, max_model_len-wide chunk tables), the
    closed family a CUDA-graph capture would key on;
  * sampling runs on the device right behind the model step, and the host
    reads a step's results with ONE device-to-host copy (``fetch_sample``,
    or the packed array of ``decode_multi`` and ``spec_verify``);
    ``prefill_chunk``, ``prefill_packed_arrays`` and ``mixed_step`` read
    nothing back: every length they need is a host int;
  * ``decode_multi`` chains H decode steps in one dispatch (the decode
    horizon): each step's sample feeds the next on the device, a lane
    freezes at an unsuppressed EOS or when its budget runs out, and the
    [H, B, 2 + 2 * num_top] samples come back in one copy; ``spec_verify``
    chains ``extras`` such steps after the verify pass, from the accept
    point the device computes;
  * ``decode``, ``decode_multi`` and ``spec_verify`` run one plain
    function of their inputs (``_decode_body``, ``_decode_multi_body``,
    ``_verify_body``), whose inputs are uploaded in one copy
    (graphs.StepInputs). With ``cuda_graphs`` (on by default on a card
    without a tensor-parallel group) each is captured once per key as a
    CUDA graph (graphs.py) and replayed per dispatch, and the call returns
    its samples already on the host; otherwise the function runs eagerly
    and returns device tensors. ``mixed_step`` and the prefills stay eager;
  * ``fused_decode`` runs every decode and verify step (and the decode half
    of a mixed step) through the fused norm+QKV+RoPE and o-proj+residual
    heads (models/llama.py); packed and chunked prefill keep the unfused
    heads, as in the reference;
  * ``kv_dtype="int8"`` makes the paged cache int8-resident (the
    reference's ``DYN_KV_DTYPE=int8``, :181-233): int8 mantissas and one
    f32 scale per (layer, kv head, block), allocated on the device as the
    ops/kv_quant.py container and handed to every attention call, which
    takes the kernels' int8 modes; nothing is read back for it;
  * the repetition / frequency / presence penalties and the min_tokens EOS
    mask run on the device before sampling, as the JAX runner's
    ``_sample_one`` (:475-482), ``_decode_pen_impl`` / ``_decode_eos_impl``
    (:889, :909) and the verify pass (:778, :800-820) apply them; the token
    history goes up only when a lane has penalties.

  * with a ``group`` (parallel/mesh.TPGroup) the runner is one rank of a
    parallel engine: its params are the rank's Megatron slice (its experts'
    block on a grid with an ep axis), its KV pool (and an int8 pool's scale
    planes) holds the rank's Hkv / tp kv heads, and every model call issues the group's collectives, so every
    rank must make the same calls in the same order
    (parallel/multihost.SpmdModelRunner replays the leader's on the
    followers, with the leader's sampling keys);
    ``collective_overlap`` runs the fused decode step's tail as the ring
    decomposition;
  * the KV block data plane of disaggregated prefill moves whole blocks
    [L, Hkv, n, bs, D] out of and into the paged cache: ``extract_blocks``
    to the host, ``extract_blocks_device`` to tensors on
    the card, ``inject_blocks`` / ``inject_blocks_device`` back. Over an
    int8-resident cache these dequantize (to bf16, as the reference's) on
    the way out and quantize whole blocks on the way in (the reference's
    absmax scheme), while the ``_quant`` pair moves mantissas and scales
    verbatim. Exactly the n blocks asked for move (the reference pads to a
    bucket to bound its compiled programs, and pads a streamed frame's
    gather less in ``extract_blocks_tight`` / ``tight=True``, which this
    runner needs no form of; a padding lane there writes null block 0,
    which nothing here writes). An inject writes IN PLACE
    (``index_copy_``): the captured graphs hold the cache's addresses, so a
    rebound cache would leave every replay reading stale blocks. Under a
    tensor-parallel group every block move runs on every rank: the leader
    gathers the ranks' heads into the dense array on the way out and
    scatters each rank its own heads on the way in (see the data plane's
    section below).

  * on a grid with an ``sp`` axis (parallel/mesh.py) ``prefill`` runs
    context parallel (``llama.prefill_context_parallel``, ring attention)
    for buckets of at least ``cp_min_tokens`` that split over sp, as the
    reference's ``_prefill_cp_impl`` (:524-541, chosen at :1166-1174); every
    other call is replicated over sp. The verify pass runs under a group
    too, on the rank's heads.

Not ported yet: graphs of the mixed step or under a group (both run
eagerly).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Optional

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.disagg.protocols import to_wire_array
from dynamo_tpu_torch.engine.torch_engine.graphs import StepGraphs, StepInputs
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import kv_quant
from dynamo_tpu_torch.ops.sampling import (
    MAX_EOS_IDS,
    advance_count_tables,
    advance_keys,
    apply_penalties,
    apply_penalties_from_tables,
    apply_repetition_penalty_from_prompt,
    apply_repetition_penalty_packed,
    make_key_data,
    mask_eos_logits,
    penalty_count_tables,
    sample_args,
    sample_tokens_full,
    spec_accept_len,
)
from dynamo_tpu_torch.parallel.mesh import ScatterSpec


def host_tensor(a, dtype=None):
    """A block array as a tensor: host numpy in the wire form (uint16 words
    are bfloat16, every other dtype its own; ``dtype`` the one it must have)
    as a CPU tensor over the same bytes, a tensor as it is."""
    if not isinstance(a, np.ndarray):
        return a
    a = np.ascontiguousarray(a, dtype)
    bf16 = a.dtype == np.uint16
    with warnings.catch_warnings():
        # a payload's arrays view its read-only wire bytes; they are only
        # read (copied to the device or into the cache)
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a.view(np.int16) if bf16 else a)
    return t.view(torch.bfloat16) if bf16 else t


def default_prefill_buckets(block_size: int, max_len: int) -> list[int]:
    """Power-of-two padded prompt lengths; every bucket is a whole number of
    KV blocks (prefill scatters whole blocks)."""

    def round_up(n: int) -> int:
        return ((n + block_size - 1) // block_size) * block_size

    buckets = []
    size = block_size
    while size < max_len:
        buckets.append(round_up(size))
        size *= 2
    top = round_up(max_len)
    if not buckets or buckets[-1] != top:
        buckets.append(top)
    return buckets


SampleOut = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# top logprobs carried per sample (sample_tokens_full's num_top)
NUM_TOP = 20


def pack_samples(tok, lp, top_ids, top_lps) -> torch.Tensor:
    """One step's samples as [B, 2 + 2 * num_top] f32 (token ids < 2^24 are
    exact in f32): token, logprob, top ids, top logprobs."""
    return torch.cat([tok[:, None].float(), lp[:, None].float(), top_ids.float(),
                      top_lps.float()], dim=-1)


def unpack_samples(packed: torch.Tensor) -> SampleOut:
    """``pack_samples`` undone, each piece in sample_tokens_full's dtype."""
    k = (packed.shape[-1] - 2) // 2
    return (packed[..., 0].to(torch.int32), packed[..., 1], packed[..., 2:2 + k].to(torch.int32),
            packed[..., 2 + k:])


class TorchModelRunner:
    # decode defaults draw from a distinct stream id so (stream, counter)
    # rows never collide with prefill's (seed, step) rows (same as JAX)
    _DECODE_STREAM_SALT = 0x9E3779B9

    def __init__(
        self,
        config: llama.LlamaConfig,
        params: Any,
        *,
        num_blocks: int,
        block_size: int,
        max_batch: int,
        max_model_len: int,
        device="cuda",
        rng_seed: int = 0,
        fused_decode: bool = False,
        prefill_chunk_tokens: int = 512,
        kv_dtype: str = "bf16",
        group=None,
        collective_overlap: bool = False,
        cuda_graphs: Optional[bool] = None,
        cp_min_tokens: int = 512,
    ) -> None:
        self.device = resolve_device(device)
        self.group = group
        self.cp_min_tokens = cp_min_tokens
        # CUDA graphs of decode / decode_multi / spec_verify: on by default
        # on a card without a group; the attribute may be flipped later
        # there (eager and graphed runs of the same programs, to time or
        # compare the two)
        capable = self.device.type == "cuda" and group is None
        if cuda_graphs is None:
            cuda_graphs = capable
        if cuda_graphs and not capable:
            raise ValueError("cuda_graphs needs a CUDA device and no tensor-parallel group")
        self.cuda_graphs = bool(cuda_graphs)
        self._graphs = StepGraphs(self.device) if capable else None
        self._inputs: dict[tuple, StepInputs] = {}
        self._last: dict[str, tuple] = {}  # kind -> key of its last dispatch
        # horizons prepared for the engine's lazy ramp, and a failed capture
        self._prepared: set[int] = set()
        self._pending: set[int] = set()
        self._prepare_error: Optional[BaseException] = None
        self.config = dataclasses.replace(
            config, fused_decode=bool(fused_decode) or config.fused_decode,
            collective_overlap=bool(collective_overlap) or config.collective_overlap,
        )
        self.params = params
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_model_len = max_model_len
        self.max_blocks_per_seq = (max_model_len + block_size - 1) // block_size
        self._rng_seed = rng_seed
        self._step_counter = 0
        self._key_offset = 0
        self.prefill_buckets = default_prefill_buckets(block_size, max_model_len)
        # chunk size in whole KV blocks, at most the largest bucket; 0 = off
        chunk = -(-prefill_chunk_tokens // block_size) * block_size
        self.prefill_chunk_tokens = min(chunk, self.prefill_buckets[-1])
        # head-major layout: each (head, page) is a contiguous [bs, D] tile
        # (what the decode kernel streams); the cache takes the embeddings'
        # dtype, or is the int8 + scale container
        kv = kv_dtype.strip().lower()
        if kv not in ("bf16", "bfloat16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r} is neither 'bf16' nor 'int8'")
        self.kv_quantized = kv == "int8"
        tp = 1 if group is None else group.world_size
        shape = (
            config.num_layers, config.num_kv_heads // tp, num_blocks, block_size,
            config.head_dim,
        )
        dtype = params["embed"].dtype
        # the values an extract gives: an int8 cache's dequantize to bf16,
        # as the reference's (its kv_dtype, model_runner.py:197)
        self.kv_logical_dtype = torch.bfloat16 if self.kv_quantized else dtype
        self.k_cache = kv_quant.make_cache(
            shape, dtype, quantized=self.kv_quantized, device=self.device)
        self.v_cache = kv_quant.make_cache(
            shape, dtype, quantized=self.kv_quantized, device=self.device)

    @property
    def kv_cache_bytes(self) -> int:
        return kv_quant.cache_nbytes(self.k_cache) + kv_quant.cache_nbytes(self.v_cache)

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    def pick_bucket(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds max_model_len {self.max_model_len}"
        )

    def _next_key_data(self) -> np.ndarray:
        self._step_counter += 1
        return make_key_data(self._rng_seed, self._step_counter)

    def _next_decode_keys(self, B: int) -> np.ndarray:
        keys = np.stack(
            [
                np.full(B, (self._rng_seed ^ self._DECODE_STREAM_SALT) & 0xFFFFFFFF, np.int64),
                (np.arange(B, dtype=np.int64) + self._key_offset) & 0xFFFFFFFF,
            ],
            axis=1,
        )
        self._key_offset += B
        return keys

    @torch.inference_mode()
    def prefill(
        self,
        token_ids: list[int],
        block_ids: list[int],
        temperature: float,
        top_p: float,
        top_k: int,
        rep_pen: float = 1.0,
        key_data: Optional[np.ndarray] = None,
        eos_ids: Optional[np.ndarray] = None,  # [MAX_EOS_IDS], -1 pads
        eos_suppress: bool = False,  # min_tokens not yet reached
    ) -> SampleOut:
        """Run one prompt (its K/V lands in ``block_ids``); returns
        (token, logprob, top_ids, top_logprobs) device tensors, each with a
        leading batch dim of 1, for the first sampled token, after the
        prompt's repetition penalty and the min_tokens EOS mask."""
        if key_data is None:
            key_data = self._next_key_data()
        logits, tokens_d = self._prefill(token_ids, block_ids)
        T = len(token_ids)
        return self._sample_first(
            logits, tokens_d, T, key_data, temperature, top_p, top_k, rep_pen,
            eos_ids, eos_suppress,
        )

    def _prefill(self, token_ids: list[int], block_ids: list[int]):
        """The model half of ``prefill``: (last token's logits [V] f32, the
        padded prompt on the device), context parallel where
        ``uses_cp_prefill`` says so."""
        T = len(token_ids)
        bucket = self.pick_bucket(T)
        tokens_d, table_d = self._prompt_arrays(token_ids, block_ids, bucket)
        if self.uses_cp_prefill(bucket):
            logits = llama.prefill_context_parallel(
                self.params, self.config, self.group, tokens_d, T,
                k_cache=self.k_cache, v_cache=self.v_cache, block_table=table_d)
        else:
            logits = llama.prefill(self.params, self.config, tokens_d, T, self.k_cache,
                                   self.v_cache, table_d, group=self.group)
        return logits, tokens_d

    def _prompt_arrays(self, token_ids: list[int], block_ids: list[int], bucket: int):
        """The prompt padded to ``bucket`` and its block table (padding
        blocks go to null block 0), on the device."""
        T = len(token_ids)
        tokens = np.zeros(bucket, np.int64)
        tokens[:T] = token_ids
        table = np.zeros(bucket // self.block_size, np.int64)
        used = (T + self.block_size - 1) // self.block_size
        table[:used] = block_ids[:used]
        return self._dev(tokens, np.int64), self._dev(table, np.int64)

    @torch.inference_mode()
    def prefill_mm(
        self,
        token_ids: list[int],  # image placeholders already expanded
        block_ids: list[int],
        mm_embeds,  # [M, hidden] vision embeddings: a tensor (any device) or numpy
        mm_start: int,  # first expanded-placeholder index
        temperature: float,
        top_p: float,
        top_k: int,
        rep_pen: float = 1.0,
        key_data: Optional[np.ndarray] = None,
        eos_ids: Optional[np.ndarray] = None,
        eos_suppress: bool = False,
        return_logits: bool = False,
    ) -> SampleOut:
        """Multimodal prefill (model_runner.py:1192-1245): the vision
        embeddings spliced over the placeholder span (``llama.prefill_mm``),
        one prompt on its own, never context parallel; then ``prefill``'s
        sampling tail, or with ``return_logits`` the last token's logits [V]
        (f32) on the device (what a check compares). Device-path embeddings
        stay on the device; a host payload (the wire path) is uploaded
        here."""
        if key_data is None:
            key_data = self._next_key_data()
        T = len(token_ids)
        tokens_d, table_d = self._prompt_arrays(token_ids, block_ids, self.pick_bucket(T))
        emb = mm_embeds if torch.is_tensor(mm_embeds) else torch.from_numpy(
            np.array(mm_embeds, np.float32))
        logits = llama.prefill_mm(
            self.params, self.config, tokens_d, T, self.k_cache, self.v_cache, table_d,
            emb.to(self.device, torch.float32), int(mm_start), group=self.group)
        if return_logits:
            return logits
        return self._sample_first(
            logits, tokens_d, T, key_data, temperature, top_p, top_k, rep_pen,
            eos_ids, eos_suppress,
        )

    @torch.inference_mode()
    def embed(self, token_ids: list[int]) -> np.ndarray:
        """Pooled sequence embedding [hidden] (f32) of one prompt padded to
        its bucket (model_runner.py:1299-1320, ``llama.embed_pooled``): no
        cache is read or written."""
        T = len(token_ids)
        bucket = self.pick_bucket(T)
        tokens = np.zeros(bucket, np.int64)
        tokens[:T] = token_ids
        out = llama.embed_pooled(self.params, self.config, self._dev(tokens, np.int64), T,
                                 group=self.group)
        return out.cpu().numpy()

    @torch.inference_mode()
    def prefill_logits(self, token_ids: list[int], block_ids: list[int]) -> torch.Tensor:
        """The model half of ``prefill`` (its K/V lands in ``block_ids``):
        the last token's logits [V] (f32) on the device, no sampling (what a
        check compares between engines)."""
        return self._prefill(token_ids, block_ids)[0]

    def uses_cp_prefill(self, bucket: int) -> bool:
        """Whether a prompt padded to ``bucket`` is prefilled context
        parallel (ring attention over the grid's sp axis): under a grid
        with sp > 1, for buckets of at least ``cp_min_tokens`` that split
        over sp (the reference runner's rule, model_runner.py:1166-1174);
        shorter prompts skip the ring's hops and run the serial path."""
        sp = getattr(self.group, "sp", None)
        return (sp is not None and sp.world_size > 1 and bucket >= self.cp_min_tokens
                and bucket % sp.world_size == 0)

    def _sample_first(
        self, logits, prompt_d, n_prompt, key_data, temperature, top_p, top_k,
        rep_pen, eos_ids, eos_suppress,
    ) -> SampleOut:
        """The prefill's tail (the JAX ``_sample_one``): the prompt's
        repetition penalty, the min_tokens EOS mask, then the first sample.
        The reference applies both always; they are bitwise no-ops when
        off, so they are skipped then."""
        if rep_pen != 1.0:
            logits = apply_repetition_penalty_from_prompt(logits, prompt_d, n_prompt, rep_pen)
        if eos_suppress and eos_ids is not None:
            logits = mask_eos_logits(
                logits, self._dev(eos_ids, np.int64), torch.tensor(True, device=self.device))
        args = sample_args([temperature], [top_p], [top_k], [key_data], self.device)
        return sample_tokens_full(logits[None], *args, all_greedy=temperature <= 0)

    def _chunk(
        self, token_chunk, chunk_start, total_len, block_ids, table_blocks,
        temperature, top_p, top_k, rep_pen, key_data, eos_ids, eos_suppress,
    ) -> SampleOut:
        """One chunk through the model (its table ``table_blocks`` wide,
        padded with null block 0) and the JAX ``_prefill_chunk_impl`` tail:
        the repetition penalty sees this chunk's tokens only (earlier chunks
        already left the program) -- the reference's documented
        approximation for the first token of a chunked prompt, kept for
        parity; decode steps use the full history."""
        C = self.prefill_chunk_tokens
        n = len(token_chunk)
        tokens = np.zeros(C, np.int64)
        tokens[:n] = token_chunk
        table = np.zeros(table_blocks, np.int64)
        table[: len(block_ids)] = block_ids
        if key_data is None:
            key_data = self._next_key_data()
        tokens_d = self._dev(tokens, np.int64)
        logits = llama.prefill_chunk(
            self.params, self.config, tokens_d, chunk_start, total_len,
            self.k_cache, self.v_cache, self._dev(table, np.int64), group=self.group,
        )
        n_in_chunk = min(max(total_len - chunk_start, 0), C)
        return self._sample_first(
            logits, tokens_d, n_in_chunk, key_data, temperature, top_p, top_k,
            rep_pen, eos_ids, eos_suppress,
        )

    @torch.inference_mode()
    def prefill_chunk(
        self,
        token_chunk: list[int],
        chunk_start: int,  # a multiple of block_size
        total_len: int,
        block_ids: list[int],
        temperature: float,
        top_p: float,
        top_k: int,
        rep_pen: float = 1.0,
        key_data: Optional[np.ndarray] = None,
        eos_ids: Optional[np.ndarray] = None,  # [MAX_EOS_IDS], -1 pads
        eos_suppress: bool = False,
    ) -> SampleOut:
        """One chunk of a chunked prefill; chunks must arrive in order.
        The table is as wide as the prompt's bucket, as in the reference.
        Returns (token, logprob, top_ids, top_logprobs) device tensors, each
        with a leading batch dim of 1, meaningful only on the final
        chunk."""
        return self._chunk(
            token_chunk, chunk_start, total_len, block_ids,
            self.pick_bucket(total_len) // self.block_size,
            temperature, top_p, top_k, rep_pen, key_data, eos_ids, eos_suppress,
        )

    def pack_prefill(self, seqs: list[tuple]) -> dict[str, np.ndarray]:
        """Pure host-side packing for the packed prefill, the JAX runner's
        arrays bit for bit.

        seqs: [(token_ids, block_ids, temp, top_p, top_k, rep_pen,
        key_row [2], eos_row [MAX_EOS_IDS], suppress), ...] with at most
        ``prefill_chunk_tokens`` tokens in all and at most ``max_batch``
        segments. Padding carries segment -1 and writes to null slot 0."""
        P = self.prefill_chunk_tokens
        N = self.max_batch
        bs = self.block_size
        if len(seqs) > N:
            raise ValueError(f"{len(seqs)} segments > max_batch {N}")
        tokens = np.zeros(P, np.int32)
        positions = np.zeros(P, np.int32)
        segment_ids = np.full(P, -1, np.int32)
        slot_indices = np.zeros(P, np.int32)
        last_idx = np.zeros(N, np.int32)
        temps = np.zeros(N, np.float32)
        top_ps = np.ones(N, np.float32)
        top_ks = np.zeros(N, np.int32)
        rep_pens = np.ones(N, np.float32)
        keys = np.zeros((N, 2), np.uint32)
        eos_ids = np.full((N, MAX_EOS_IDS), -1, np.int32)
        eos_suppress = np.zeros(N, bool)
        off = 0
        for i, (tids, bids, te, tp_, tk, rp, kd, er, sup) in enumerate(seqs):
            T = len(tids)
            if off + T > P:
                raise ValueError(f"pack overflow: {off}+{T} > {P}")
            tokens[off:off + T] = tids
            positions[off:off + T] = np.arange(T)
            segment_ids[off:off + T] = i
            t_idx = np.arange(T)
            slot_indices[off:off + T] = (
                np.asarray(bids, np.int64)[t_idx // bs] * bs + t_idx % bs
            )
            last_idx[i] = off + T - 1
            temps[i], top_ps[i], top_ks[i], rep_pens[i] = te, tp_, tk, rp
            keys[i] = kd
            eos_ids[i] = er
            eos_suppress[i] = sup
            off += T
        return dict(
            tokens=tokens, positions=positions, segment_ids=segment_ids,
            slot_indices=slot_indices, last_idx=last_idx, temps=temps,
            top_ps=top_ps, top_ks=top_ks, rep_pens=rep_pens, keys=keys,
            eos_ids=eos_ids, eos_suppress=eos_suppress,
        )

    @torch.inference_mode()
    def prefill_packed_arrays(
        self, tokens, positions, segment_ids, slot_indices, last_idx,
        temps, top_ps, top_ks, rep_pens, keys, eos_ids=None, eos_suppress=None,
    ) -> SampleOut:
        """The packed prefill over ``pack_prefill``'s arrays (the JAX
        ``_prefill_packed_impl``): the model, each segment's prompt
        repetition penalty, the EOS mask, then sampling. Returns (tokens,
        logprobs, top_ids, top_logprobs), each [max_batch]-major; only the
        first len(seqs) rows mean something."""
        tokens_d = self._dev(tokens, np.int64)
        seg_d = self._dev(segment_ids, np.int64)
        logits = llama.prefill_packed(
            self.params, self.config, tokens_d, self._dev(positions, np.int64), seg_d,
            self._dev(slot_indices, np.int64), self.k_cache, self.v_cache,
            self._dev(last_idx, np.int64), group=self.group,
        )
        # both are bitwise no-ops on neutral rows, so they are skipped when
        # every row is neutral
        if (np.asarray(rep_pens) != 1.0).any():
            logits = apply_repetition_penalty_packed(
                logits, tokens_d, seg_d, self._dev(rep_pens, np.float32))
        if eos_suppress is not None and np.asarray(eos_suppress).any():
            logits = mask_eos_logits(
                logits, self._dev(eos_ids, np.int64), self._dev(eos_suppress, bool))
        args = sample_args(temps, top_ps, top_ks, keys, self.device)
        return sample_tokens_full(
            logits, *args, all_greedy=bool((np.asarray(temps) <= 0).all()))

    @torch.inference_mode()
    def mixed_step(
        self,
        chunks: list[tuple],  # (token_chunk, chunk_start, total_len, block_ids,
        # temperature, top_p, top_k, rep_pen, key_data, eos_ids, eos_suppress)
        # per chunk slot
        tokens, positions, block_tables, slot_indices, keys, temps, top_ps, top_ks,
        eos_ids: Optional[np.ndarray] = None,  # [B, MAX_EOS_IDS], -1 pads
        eos_suppress: Optional[np.ndarray] = None,  # [B] bool
    ) -> tuple[tuple[SampleOut, ...], SampleOut]:
        """One mixed step (the JAX ``mixed_step`` / ``_mixed_impl``): the k
        chunk slots first, in list order (two slots of one sequence are
        fine), then the whole decode batch. Every sub-computation touches
        its own KV blocks, so the step equals the separate calls. Chunk
        tables are max_model_len wide, so the inputs take one shape per k.
        The decode half always runs the EOS-masked variant: a neutral row
        (ids -1, suppress False) passes through bitwise. Returns
        (chunk_outs, decode_out): one sample tuple per chunk slot (meaningful
        only on a final chunk) and one for the decode batch."""
        chunk_outs = tuple(
            self._chunk(
                token_chunk, chunk_start, total_len, block_ids, self.max_blocks_per_seq,
                temperature, top_p, top_k, rep_pen, key_data, c_eos_ids, c_sup,
            )
            for (token_chunk, chunk_start, total_len, block_ids, temperature, top_p,
                 top_k, rep_pen, key_data, c_eos_ids, c_sup) in chunks
        )
        B = len(np.asarray(tokens))
        if eos_ids is None:
            eos_ids = np.full((B, MAX_EOS_IDS), -1, np.int64)
        if eos_suppress is None:
            eos_suppress = np.zeros(B, bool)
        # eager: the chunks above are eager, and all of it comes back in
        # one copy
        d_out = self._decode(
            tokens, positions, block_tables, slot_indices, temps, top_ps, top_ks,
            keys, None, (eos_ids, eos_suppress), graphed=False,
        )
        return chunk_outs, d_out

    @torch.inference_mode()
    def decode(
        self,
        tokens: np.ndarray,  # [B] token fed this step
        positions: np.ndarray,  # [B] its position
        block_tables: np.ndarray,  # [B, max_blocks_per_seq]
        slot_indices: np.ndarray,  # [B] flat cache slot for its K/V
        temps: np.ndarray,
        top_ps: np.ndarray,
        top_ks: np.ndarray,
        keys: Optional[np.ndarray] = None,  # [B, 2] (stream, counter) rows
        penalties: Optional[tuple] = None,
        # (hist [B, L], hist_len [B], prompt_len [B], freq [B], pres [B],
        # rep [B], eos_ids [B, MAX_EOS_IDS], eos_suppress [B]): penalties
        # from the full history, then the EOS mask
        eos_mask: Optional[tuple] = None,
        # (eos_ids, eos_suppress): min_tokens without penalties, no history
        # upload; ignored when penalties is given
    ) -> SampleOut:
        """One batched decode step. Returns (tokens, logprobs, top_ids,
        top_logprobs), batch-major: on the host when the step ran as a
        graph, else device tensors (``fetch_sample`` takes either)."""
        return self._decode(tokens, positions, block_tables, slot_indices, temps, top_ps,
                            top_ks, keys, penalties, eos_mask, self.cuda_graphs)

    def _decode(self, tokens, positions, block_tables, slot_indices, temps, top_ps, top_ks,
                keys, penalties, eos_mask, graphed: bool) -> SampleOut:
        B = len(tokens)
        if keys is None:
            keys = self._next_decode_keys(B)
        arrays = dict(tokens=tokens, positions=positions, block_tables=block_tables,
                      slot_indices=slot_indices, temps=temps, top_ps=top_ps, top_ks=top_ks,
                      keys=keys)
        if penalties is not None:
            arrays.update(zip(("hist", "hist_len", "prompt_len", "freq", "pres", "rep",
                               "eos_ids", "eos_sup"), penalties))
        elif eos_mask is not None and np.asarray(eos_mask[1]).any():
            # a neutral mask is a bitwise no-op: skipped
            arrays.update(eos_ids=eos_mask[0], eos_sup=eos_mask[1])
        pen, mask = penalties is not None, "eos_ids" in arrays
        greedy = bool((np.asarray(temps) <= 0).all())
        fields = self._sampling_fields(B, np.shape(block_tables)[1])
        fields["slot_indices"] = (torch.int64, (B,))
        if pen:
            fields.update(self._penalty_fields(B, np.shape(penalties[0])[1]))
        if mask:
            fields.update(self._eos_fields(B))
            fields["eos_sup"] = (torch.bool, (B,))
        key = self._key("decode", fields, pen=pen, mask=mask, greedy=greedy)
        out = self._run(key, fields, arrays, graphed,
                        lambda v: self._decode_body(v, pen, mask, greedy))
        return unpack_samples(out)

    def _decode_body(self, v: dict, pen: bool, mask: bool, greedy: bool) -> torch.Tensor:
        """One step as a function of its inputs: the model, the penalties
        from the history, the EOS mask, the sample. [B, 2 + 2 * num_top]."""
        logits = llama.decode(
            self.params, self.config, v["tokens"], v["positions"], self.k_cache, self.v_cache,
            v["block_tables"], v["slot_indices"], group=self.group,
        )
        if pen:
            logits = apply_penalties(logits, v["hist"], v["hist_len"], v["prompt_len"],
                                     v["freq"], v["pres"], v["rep"])
        if mask:
            logits = mask_eos_logits(logits, v["eos_ids"], v["eos_sup"])
        return pack_samples(*sample_tokens_full(
            logits, v["temps"], v["top_ps"], v["top_ks"], v["keys"], NUM_TOP, all_greedy=greedy))

    @torch.inference_mode()
    def decode_logits(self, tokens, positions, block_tables, slot_indices) -> torch.Tensor:
        """The model half of ``decode``: one step's logits [B, V] (f32) on
        the device, no sampling (what a check compares between engines)."""
        return llama.decode(
            self.params, self.config,
            self._dev(tokens, np.int64), self._dev(positions, np.int64),
            self.k_cache, self.v_cache,
            self._dev(block_tables, np.int32), self._dev(slot_indices, np.int64),
            group=self.group,
        )

    @torch.inference_mode()
    def verify_logits(self, tokens, positions, block_tables, slot_indices) -> torch.Tensor:
        """The model half of the verify pass: [B, S] fed tokens at
        ``positions`` (their K/V written to ``slot_indices``, 0 the null
        sink) scored in one weight pass; logits [B, S, V] (f32) on the
        device, no sampling (what a check compares between engines)."""
        return llama.decode_verify(
            self.params, self.config,
            self._dev(tokens, np.int64), self._dev(positions, np.int64),
            self.k_cache, self.v_cache,
            self._dev(block_tables, np.int32), self._dev(slot_indices, np.int64),
            group=self.group,
        )

    def shutdown(self) -> None:
        """Release what the runner holds beyond its tensors: nothing on one
        device (a tensor-parallel leader stops its followers here)."""

    @torch.inference_mode()
    def decode_multi(
        self,
        H: int,
        tokens: np.ndarray,  # [B] last sampled token per lane
        positions: np.ndarray,  # [B] its position
        block_tables: np.ndarray,  # [B, max_blocks_per_seq], covering every
        # write of the horizon (the engine preallocates)
        temps: np.ndarray,
        top_ps: np.ndarray,
        top_ks: np.ndarray,
        keys: np.ndarray,  # [B, 2] (stream, counter) rows of step 0
        active: np.ndarray,  # [B] bool: lane live at the horizon's start
        limit_remaining: np.ndarray,  # [B] tokens the lane may still emit
        min_remaining: np.ndarray,  # [B] steps during which its EOS stays masked
        eos_ids: np.ndarray,  # [B, MAX_EOS_IDS], -1 pads
        penalties: Optional[tuple] = None,
        # (hist [B, L], hist_len, prompt_len, freq, pres, rep): uploaded
        # once per horizon and scattered into count tables on the device
    ) -> torch.Tensor:
        """H chained decode steps in one dispatch (see ``_decode_multi_body``
        for the freeze rules). Returns the packed [H, B, 2 + 2 * num_top]
        f32 samples (token or -1, logprob, top ids, top logprobs per step):
        on the host when the horizon ran as a graph, else on the device."""
        H = int(H)
        if H < 1:
            raise ValueError(f"decode_multi needs H >= 1, got {H}")
        B = len(tokens)
        arrays = dict(tokens=tokens, positions=positions, block_tables=block_tables,
                      temps=temps, top_ps=top_ps, top_ks=top_ks, keys=keys, active=active,
                      limit_remaining=limit_remaining, min_remaining=min_remaining,
                      eos_ids=eos_ids)
        pen = penalties is not None
        if pen:
            arrays.update(zip(("hist", "hist_len", "prompt_len", "freq", "pres", "rep"),
                              penalties))
        mask = bool((np.asarray(min_remaining) > 0).any())
        greedy = bool((np.asarray(temps) <= 0).all())
        fields = self._multi_fields(B, np.shape(block_tables)[1])
        if pen:
            fields.update(self._penalty_fields(B, np.shape(penalties[0])[1]))
        key = self._key("decode_multi", fields, H, pen=pen, mask=mask, greedy=greedy)
        return self._run(key, fields, arrays, self.cuda_graphs,
                         lambda v: self._decode_multi_body(v, H, pen, mask, greedy))

    def _chain_feed(self, v: dict, tokens, positions, done):
        """One chained step's inputs: a frozen lane feeds token 0 at
        position 0 and writes to the null slot 0, as an empty lane of a
        single step does (the paged kernels size their splits from every
        lane's length, so a frozen lane must look like an empty one for the
        live lanes to compute what single steps compute)."""
        tables = v["block_tables"]
        tok = torch.where(done, 0, tokens)
        pos = torch.where(done, 0, positions)
        page = (pos // self.block_size).clamp(max=tables.shape[1] - 1)
        slot = tables.gather(1, page[:, None])[:, 0].long() * self.block_size + pos % self.block_size
        return tok, pos, torch.where(done, 0, slot)

    def _decode_multi_body(self, v: dict, H: int, pen: bool, mask: bool,
                           greedy: bool) -> torch.Tensor:
        """H chained steps as a function of their inputs (the reference's
        ``_decode_multi_impl``, unrolled): each step's sample feeds the
        next. A lane freezes once it samples an unsuppressed EOS or has
        emitted ``limit_remaining`` tokens; a frozen step writes its K/V to
        the null slot 0 and emits -1. The EOS is emitted (the engine hides
        it) and never fed back. Step h masks a lane's EOS while h <
        ``min_remaining`` and samples with the counter advanced by h. With
        penalties the history is scattered into count tables once, and each
        step adds its own non-EOS token; lanes without penalties (0 / 0 / 1)
        pass through bit-exactly."""
        tokens, positions = v["tokens"], v["positions"]
        eos_ids = v["eos_ids"]
        eos_valid = eos_ids >= 0
        if pen:
            out_counts, seen = penalty_count_tables(
                v["hist"], v["hist_len"], v["prompt_len"], self.config.vocab_size)
        done = ~v["active"]
        rows = []
        for h in range(H):
            tok_in, pos_in, slot = self._chain_feed(v, tokens, positions, done)
            logits = llama.decode(
                self.params, self.config, tok_in, pos_in, self.k_cache, self.v_cache,
                v["block_tables"], slot, group=self.group,
            )
            if pen:
                logits = apply_penalties_from_tables(
                    logits, out_counts, seen, v["freq"], v["pres"], v["rep"])
            if mask:
                logits = mask_eos_logits(logits, eos_ids, h < v["min_remaining"])
            tok, lp, top_ids, top_lps = sample_tokens_full(
                logits, v["temps"], v["top_ps"], v["top_ks"], advance_keys(v["keys"], h),
                NUM_TOP, all_greedy=greedy)
            tok = tok.long()
            is_eos = ((tok[:, None] == eos_ids) & eos_valid).any(dim=-1)
            rows.append(pack_samples(torch.where(done, -1, tok), lp, top_ids, top_lps))
            if pen:
                # an EOS finishes the lane before it is appended
                out_counts, seen = advance_count_tables(out_counts, seen, tok, ~done & ~is_eos)
            tokens = torch.where(done | is_eos, tokens, tok)
            positions = torch.where(done, positions, positions + 1)
            done = done | is_eos | (h + 1 >= v["limit_remaining"])
        return torch.stack(rows)

    @torch.inference_mode()
    def spec_verify(
        self,
        spec_k: int,
        extras: int,
        tokens: np.ndarray,  # [B] last accepted token per lane
        drafts: np.ndarray,  # [B, spec_k] draft tokens (-1 pads)
        draft_len: np.ndarray,  # [B] valid drafts per lane (0 = none)
        positions: np.ndarray,  # [B] position of `tokens`
        block_tables: np.ndarray,  # [B, max_blocks_per_seq], covering every
        # position up to positions + draft_len + extras
        temps: np.ndarray,
        top_ps: np.ndarray,
        top_ks: np.ndarray,
        keys: np.ndarray,  # [B, 2] (stream, counter) rows of position 0
        active: np.ndarray,  # [B] bool
        limit_remaining: np.ndarray,  # [B] tokens the lane may still emit
        min_remaining: Optional[np.ndarray] = None,  # [B] positions whose EOS stays masked
        eos_ids: Optional[np.ndarray] = None,  # [B, MAX_EOS_IDS], -1 pads
        penalties: Optional[tuple] = None,
        # (hist [B, L], hist_len, prompt_len, freq, pres, rep): the
        # history's count tables, advanced by each fed draft token
    ) -> torch.Tensor:
        """Speculative draft-verify dispatch (see ``_verify_body``): ONE
        weight pass scores S = spec_k + 1 positions per lane, then
        ``extras`` E chained decode steps run from the accept point the
        device computes. Returns the packed [S + E, B, 2 + 2 * num_top] f32
        samples (token or -1, logprob, top ids, top logprobs per position):
        on the host when the dispatch ran as a graph, else on the device.
        Penalties ride the verify positions only: with them E must be 0, as
        the reference's engine sends it (the count tables cannot take a
        rejected draft back out)."""
        S, E = spec_k + 1, int(extras)
        if E < 0:
            raise ValueError(f"extras must be >= 0, got {E}")
        if penalties is not None and E:
            raise ValueError("penalty batches verify without chained steps (extras=0)")
        B = len(tokens)
        active = np.asarray(active, bool)
        if (active & (np.asarray(draft_len) >= np.asarray(limit_remaining))).any():
            raise ValueError("a lane drafts past the tokens it may still emit")
        if min_remaining is None:
            min_remaining = np.zeros(B, np.int64)
        if eos_ids is None:
            eos_ids = np.full((B, MAX_EOS_IDS), -1, np.int64)
        arrays = dict(tokens=tokens, drafts=np.asarray(drafts).reshape(B, spec_k),
                      draft_len=draft_len, positions=positions, block_tables=block_tables,
                      temps=temps, top_ps=top_ps, top_ks=top_ks, keys=keys, active=active,
                      limit_remaining=limit_remaining, min_remaining=min_remaining,
                      eos_ids=eos_ids)
        pen = penalties is not None
        if pen:
            arrays.update(zip(("hist", "hist_len", "prompt_len", "freq", "pres", "rep"),
                              penalties))
        mask = bool((np.asarray(min_remaining) > 0).any())
        greedy = bool((np.asarray(temps) <= 0).all())
        fields = self._multi_fields(B, np.shape(block_tables)[1])
        fields.update(drafts=(torch.int64, (B, spec_k)), draft_len=(torch.int64, (B,)))
        if pen:
            fields.update(self._penalty_fields(B, np.shape(penalties[0])[1]))
        key = self._key("verify", fields, S, E, pen=pen, mask=mask, greedy=greedy)
        return self._run(key, fields, arrays, self.cuda_graphs,
                         lambda v: self._verify_body(v, S, E, pen, mask, greedy))

    def _verify_body(self, v: dict, S: int, E: int, pen: bool, mask: bool,
                     greedy: bool) -> torch.Tensor:
        """The verify dispatch as a function of its inputs (the reference's
        ``_spec_verify_impl``): ONE weight pass (llama.decode_verify) scores
        S positions per lane -- position 0 re-feeds the last accepted
        token, 1..draft_len the drafts -- each sampled with the key the
        per-token path would use, (stream, counter + h), so the emitted
        stream equals non-speculative decoding under greedy and seeded
        sampling alike. Positions past a lane's drafts, and inactive lanes,
        write their K/V to the null slot 0 and come back as -1. Rejected
        draft positions leave K/V ahead of the accepted frontier; the next
        fed token overwrites it before anything attends to it. Position h
        masks its EOS while h < min_remaining; with penalties, position h is
        penalised from the history plus the drafts fed at 1..h.

        Then E chained steps (``_decode_multi_body``'s freeze rules) start
        from the bonus token at the accept point ``spec_accept_len`` gives;
        a lane whose accepted region holds an EOS is frozen."""
        tokens, drafts, draft_len = v["tokens"], v["drafts"], v["draft_len"]
        positions, tables, active = v["positions"], v["block_tables"], v["active"]
        eos_ids, min_rem = v["eos_ids"], v["min_remaining"]
        eos_valid = eos_ids >= 0
        B = tokens.shape[0]
        dev = tokens.device
        step = torch.arange(S, device=dev)[None, :]
        valid = active[:, None] & (step <= draft_len[:, None])  # [B, S]
        fed = torch.where(valid, torch.cat([tokens[:, None], drafts], dim=1), 0)
        qpos = positions[:, None] + step
        page = (qpos // self.block_size).clamp(max=tables.shape[1] - 1)
        slot = torch.where(
            valid, tables.gather(1, page).long() * self.block_size + qpos % self.block_size, 0)
        logits = llama.decode_verify(
            self.params, self.config, fed, qpos, self.k_cache, self.v_cache, tables, slot,
            group=self.group)
        V = logits.shape[-1]
        suppress = step < min_rem[:, None]  # [B, S]
        if pen:
            out_counts, seen = penalty_count_tables(v["hist"], v["hist_len"], v["prompt_len"], V)
            rows = []
            for h in range(S):
                if h >= 1:
                    # the draft fed at position h entered the context
                    out_counts, seen = advance_count_tables(out_counts, seen, fed[:, h], valid[:, h])
                lg = apply_penalties_from_tables(
                    logits[:, h], out_counts, seen, v["freq"], v["pres"], v["rep"])
                if mask:
                    lg = mask_eos_logits(lg, eos_ids, suppress[:, h])
                rows.append(lg)
            logits = torch.stack(rows, dim=1)  # [B, S, V]
        elif mask:
            logits = mask_eos_logits(
                logits.reshape(B * S, V), eos_ids.repeat_interleave(S, dim=0),
                suppress.reshape(-1)).reshape(B, S, V)
        # fold S into the batch and sample every position in one pass; the
        # sampler is row-wise, so this equals S single steps
        keys_rep = advance_keys(v["keys"].repeat_interleave(S, dim=0), step.repeat(B, 1).reshape(-1))
        tok, lp, top_ids, top_lps = sample_tokens_full(
            logits.reshape(B * S, V), v["temps"].repeat_interleave(S),
            v["top_ps"].repeat_interleave(S), v["top_ks"].repeat_interleave(S), keys_rep,
            NUM_TOP, all_greedy=greedy)
        t = tok.long().reshape(B, S)
        packed = torch.cat([
            torch.where(valid, t, -1)[..., None].float(), lp.reshape(B, S, 1),
            top_ids.reshape(B, S, -1).float(), top_lps.reshape(B, S, -1),
        ], dim=-1).transpose(0, 1)  # [S, B, 2 + 2K]
        if not E:
            return packed.contiguous()
        m = spec_accept_len(t, drafts, draft_len)  # [B] accepted drafts
        lanes = torch.arange(B, device=dev)
        # an EOS anywhere in the accepted region freezes the continuation
        t_eos = ((t[:, :, None] == eos_ids[:, None, :]) & eos_valid[:, None, :]).any(dim=-1)
        done = ~active | (t_eos & (step <= m[:, None]) & valid).any(dim=1)
        count = m + 1  # tokens the verify pass emitted
        last = t[lanes, m]  # the bonus token, fed next
        rows = [packed]
        for _ in range(E):
            alive = ~done & (count < v["limit_remaining"])
            tok_in, pos_in, slot_e = self._chain_feed(v, last, positions + count, ~alive)
            lg = llama.decode(self.params, self.config, tok_in, pos_in, self.k_cache,
                              self.v_cache, tables, slot_e, group=self.group)
            if mask:
                lg = mask_eos_logits(lg, eos_ids, count < min_rem)
            tok_e, lp_e, ids_e, lps_e = sample_tokens_full(
                lg, v["temps"], v["top_ps"], v["top_ks"], advance_keys(v["keys"], count),
                NUM_TOP, all_greedy=greedy)
            tok_e = tok_e.long()
            is_eos = ((tok_e[:, None] == eos_ids) & eos_valid).any(dim=-1)
            rows.append(pack_samples(torch.where(alive, tok_e, -1), lp_e, ids_e, lps_e)[None])
            last = torch.where(alive & ~is_eos, tok_e, last)
            done = done | (alive & is_eos)
            count = count + alive.long()
        return torch.cat(rows).contiguous()

    # ------------------------------------------------- KV block data plane
    #
    # Ordering between two engines on one card (disaggregated prefill): each
    # engine issues its device calls from its own worker thread on that
    # thread's current stream, which is the device's default stream (no call
    # of the runner or the engine sets another; a graph capture runs on
    # StepGraphs' side stream, joined to the default stream before and after
    # it, and a replay runs on the default stream). The prefill engine's
    # extract is enqueued before its answer reaches the decode engine, whose
    # inject is enqueued after it: stream order puts the copy out before the
    # read. The extract is a copy (``index_select``), so the prefill engine
    # may free and reuse its scratch blocks at once: a later prefill writes
    # them after the copy in the same order. A caller on a side stream is
    # joined to the default stream: the extract's result is made ready on it,
    # and an inject waits on it.

    def _block_index(self, block_ids, *, writes: bool = False) -> torch.Tensor:
        ids = np.asarray(block_ids, np.int64).reshape(-1)
        if writes and (ids <= 0).any():
            raise ValueError(f"block ids {ids.tolist()} include null block 0 (or a negative id)")
        return torch.as_tensor(ids, device=self.device)

    # Under a tensor-parallel group each rank's cache holds Hkv / tp heads.
    # Every block move runs on every rank (the step channel's OP_EXTRACT /
    # OP_INJECT, parallel/multihost.py): an extract gathers the ranks' heads
    # into the dense array on the leader (rank 0), which alone returns it
    # (a follower returns None); an inject cuts the leader's dense array by
    # head and scatters it, each rank receiving only its own heads, which it
    # writes in place. A dense payload is what crosses the wire, so a
    # prefill group and a decode group of different sizes reshard by this
    # slicing alone.

    def _heads_out(self, t: torch.Tensor, dim: int = 1) -> Optional[torch.Tensor]:
        """``t`` (this rank's heads of some blocks) as the dense array:
        itself without a group, else gathered on the leader (on the host for
        gloo); None on a follower."""
        return t if self.group is None else self.group.gather(t, dim)

    def _heads_in(self, a, dim: int = 1, dtype=None) -> torch.Tensor:
        """This rank's heads, on its device, of a dense block array (host
        numpy in the wire form, where uint16 words are bfloat16 and every
        other dtype is its own, ``dtype`` the one it must have; or a tensor).
        Under a group the leader passes the dense array and a follower its
        part's ``ScatterSpec``."""
        if isinstance(a, ScatterSpec):
            return self.group.scatter(None, dim, part=a)
        a = host_tensor(a, dtype)
        if self.group is None:
            return a.to(self.device)
        return self.group.scatter(a, dim)

    def _gather(self, idx: torch.Tensor) -> list[torch.Tensor]:
        """The blocks ``idx`` of K and V, [L, Hkv, n, bs, D] in the cache's
        logical dtype (an int8 cache's dequantized, as the reference's
        ``_extract``), this rank's heads."""
        out = []
        for c in (self.k_cache, self.v_cache):
            if self.kv_quantized:
                q, s = c["q"].index_select(2, idx), c["s"].index_select(2, idx)
                out.append(kv_quant.dequantize(q, s).to(self.kv_logical_dtype))
            else:
                out.append(c.index_select(2, idx))
        return out

    def _scatter(self, idx: torch.Tensor, blocks: tuple) -> None:
        """Write [L, Hkv, n, bs, D] K and V blocks (this rank's heads) at
        ``idx`` in place; an int8 cache quantizes each whole block by its
        exact absmax (the reference's quantize-on-inject)."""
        n = idx.shape[0]
        for c, b in zip((self.k_cache, self.v_cache), blocks):
            if b.dim() != 5 or b.shape[2] != n:
                raise ValueError(f"blocks of shape {tuple(b.shape)} for {n} block ids")
            if self.kv_quantized:
                xf = b.float()
                scale = kv_quant.block_scale(xf.abs().amax(dim=(-2, -1)))
                c["q"].index_copy_(
                    2, idx, kv_quant.quantize_with(xf, kv_quant.scale_inv(scale)[..., None, None]))
                c["s"].index_copy_(2, idx, scale)
            else:
                c.index_copy_(2, idx, b.to(c.dtype))

    @torch.inference_mode()
    def extract_blocks(self, block_ids: list[int]) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Dense KV blocks [L, Hkv, n, bs, D] on the host, for a host
        payload: numpy in the logical dtype's wire form (bfloat16 as uint16
        words, where the reference gives ml_dtypes.bfloat16). None on a
        follower."""
        k, v = (self._heads_out(t) for t in self._gather(self._block_index(block_ids)))
        if k is None:
            return None
        return to_wire_array(k), to_wire_array(v)

    @torch.inference_mode()
    def extract_blocks_quant(self, block_ids: list[int]) -> Optional[tuple]:
        """An int8-resident cache's blocks verbatim, on the host: (kq [L,
        Hkv, n, bs, D] int8, ks [L, Hkv, n] f32, vq, vs), the exact
        mantissas and scales the wire codec would make. None on a
        follower."""
        if not self.kv_quantized:
            raise ValueError("extract_blocks_quant needs an int8-resident cache")
        idx = self._block_index(block_ids)
        parts = [self._heads_out(c[part].index_select(2, idx))
                 for c in (self.k_cache, self.v_cache) for part in ("q", "s")]
        if parts[0] is None:
            return None
        return tuple(p.cpu().numpy() for p in parts)

    @torch.inference_mode()
    def inject_blocks_quant(self, block_ids: list[int], kq, ks, vq, vs) -> None:
        """Write int8 mantissas [L, Hkv, n, bs, D] and scales [L, Hkv, n]
        verbatim into an int8-resident cache, in place (the landing half of
        the no-recode path)."""
        if not self.kv_quantized:
            raise ValueError("inject_blocks_quant needs an int8-resident cache")
        idx = self._block_index(block_ids, writes=True)
        n = idx.shape[0]
        for c, q, s in ((self.k_cache, kq, ks), (self.v_cache, vq, vs)):
            q, s = self._heads_in(q, 1, np.int8), self._heads_in(s, 1, np.float32)
            if q.dim() != 5 or q.shape[2] != n or tuple(s.shape) != tuple(q.shape[:3]):
                raise ValueError(f"mantissas {tuple(q.shape)} / scales {tuple(s.shape)} "
                                 f"for {n} block ids")
            c["q"].index_copy_(2, idx, q)
            c["s"].index_copy_(2, idx, s)

    @torch.inference_mode()
    def extract_blocks_device(self, block_ids: list[int]) -> tuple:
        """Dense KV blocks left on the device: (k, v, n), k / v [L, Hkv, n,
        bs, D] copies in the cache's logical dtype (an int8 cache's
        dequantized). The device-native disagg path: a colocated decode
        engine lands them with ``inject_blocks_device`` and they never leave
        the card (under a gloo group the ranks' heads meet on the host;
        a follower gets (None, None, n)). Without a group never reads
        anything back to the host."""
        k, v = (self._heads_out(t) for t in self._gather(self._block_index(block_ids)))
        if k is None:
            return None, None, len(block_ids)
        k, v = k.to(self.device), v.to(self.device)
        if self.device.type == "cuda":
            default = torch.cuda.default_stream(self.device)
            current = torch.cuda.current_stream(self.device)
            if current != default:
                default.wait_stream(current)
        return k, v, len(block_ids)

    @torch.inference_mode()
    def inject_blocks_device(self, block_ids: list[int], k_dev, v_dev) -> None:
        """Write device KV blocks (a colocated prefill engine's
        ``extract_blocks_device``) into this cache at ``block_ids``, in
        place: moved onto this runner's device first (nothing on one card, a
        peer copy from another), then the same scatter as ``inject_blocks``.
        No host copy without a group."""
        idx = self._block_index(block_ids, writes=True)
        if self.device.type == "cuda":
            current = torch.cuda.current_stream(self.device)
            if current != torch.cuda.default_stream(self.device):
                current.wait_stream(torch.cuda.default_stream(self.device))
        self._scatter(idx, (self._heads_in(k_dev), self._heads_in(v_dev)))

    @torch.inference_mode()
    def inject_blocks(self, block_ids: list[int], k_blocks, v_blocks) -> None:
        """Write received dense KV blocks [L, Hkv, n, bs, D] (host numpy in
        the wire form: uint16 words are bfloat16; or tensors) into this cache
        at ``block_ids``, in place; an int8-resident cache quantizes each
        whole block."""
        idx = self._block_index(block_ids, writes=True)
        self._scatter(idx, (self._heads_in(k_blocks), self._heads_in(v_blocks)))

    def _pages(self) -> list[torch.Tensor]:
        """The cache's own planes: K, V (or K, V mantissas and their
        scales for an int8 cache)."""
        if self.kv_quantized:
            return [self.k_cache["q"], self.v_cache["q"], self.k_cache["s"], self.v_cache["s"]]
        return [self.k_cache, self.v_cache]

    @torch.inference_mode()
    def extract_pages(self, block_ids: list[int]) -> Optional[tuple[torch.Tensor, ...]]:
        """The blocks in the cache's own form, blocks first, for the tiered
        block manager: (k, v) [n, L, Hkv, bs, D], or for an int8 cache (kq,
        vq, ks, vs) with [n, L, Hkv] scales: one gather per plane, no
        dequantize. Left on the device without a group; under one the dense
        pages are the leader's (on the host for gloo), None a follower's."""
        idx = self._block_index(block_ids)
        pages = tuple(self._heads_out(p.movedim(2, 0).index_select(0, idx), 2)
                      for p in self._pages())
        return None if pages[0] is None else pages

    @torch.inference_mode()
    def inject_pages(self, block_ids: list[int], *pages) -> None:
        """``extract_pages``' inverse, in place: blocks-first planes (on any
        device) written at ``block_ids``, so captured graphs keep the
        cache's addresses."""
        idx = self._block_index(block_ids, writes=True)
        planes = self._pages()
        if len(pages) != len(planes):
            raise ValueError(f"{len(pages)} planes for a cache of {len(planes)}")
        for c, p in zip(planes, pages):
            p = self._heads_in(p, 2)
            if tuple(p.shape) != (idx.shape[0], *c.movedim(2, 0).shape[1:]) or p.dtype != c.dtype:
                raise ValueError(f"pages {tuple(p.shape)} {p.dtype} for {idx.shape[0]} block ids "
                                 f"of a {c.dtype} cache")
            c.index_copy_(2, idx, p.movedim(0, 2))

    # ------------------------------------------------- inputs and graphs

    def _sampling_fields(self, B: int, nb: int) -> dict:
        i64, f32 = torch.int64, torch.float32
        return dict(tokens=(i64, (B,)), positions=(i64, (B,)), block_tables=(torch.int32, (B, nb)),
                    temps=(f32, (B,)), top_ps=(f32, (B,)), top_ks=(i64, (B,)), keys=(i64, (B, 2)))

    def _eos_fields(self, B: int) -> dict:
        return dict(eos_ids=(torch.int64, (B, MAX_EOS_IDS)))

    def _multi_fields(self, B: int, nb: int) -> dict:
        i64 = torch.int64
        return dict(self._sampling_fields(B, nb), **self._eos_fields(B), active=(torch.bool, (B,)),
                    limit_remaining=(i64, (B,)), min_remaining=(i64, (B,)))

    def _penalty_fields(self, B: int, L: int) -> dict:
        i64, f32 = torch.int64, torch.float32
        return dict(hist=(i64, (B, L)), hist_len=(i64, (B,)), prompt_len=(i64, (B,)),
                    freq=(f32, (B,)), pres=(f32, (B,)), rep=(f32, (B,)))

    def _key(self, kind: str, fields: dict, *dims, pen: bool, mask: bool, greedy: bool) -> tuple:
        """A graph key: the kind and its static sizes, the cache form, the
        fused heads, penalties, the EOS mask, the sampler, then the inputs'
        shapes."""
        return (kind, *dims, "int8" if self.kv_quantized else "bf16",
                "fused" if self.config.fused_decode else "unfused",
                "pen" if pen else "nopen", "eos" if mask else "noeos",
                "greedy" if greedy else "sampled",
                *(tuple(shape) for _, shape in fields.values()))

    @staticmethod
    def _inert(fields: dict) -> dict:
        """Inputs under which every lane is inactive or empty: every K/V
        write goes to the null slot 0."""
        fill = {"top_ps": 1.0, "rep": 1.0, "eos_ids": -1, "drafts": -1, "limit_remaining": 1}
        return {name: np.full(shape, fill.get(name, 0)) for name, (_, shape) in fields.items()}

    def _run(self, key: tuple, fields: dict, arrays: dict, graphed: bool, body) -> torch.Tensor:
        """One dispatch of ``body`` over ``arrays``, uploaded in one copy:
        replayed from its graph (captured on first use), or run eagerly."""
        inputs = self._inputs.get(key)
        if inputs is None:
            inputs = self._inputs[key] = StepInputs(fields, self.device)
        self._last[key[0]] = key
        if not graphed:
            inputs.fill(arrays)
            inputs.upload()
            return body(inputs.views)
        if self._graphs is None:
            raise RuntimeError("this runner was built without CUDA graphs")
        if key not in self._graphs:
            self._reserve_tickets(key, fields)
            self._graphs.capture(key, inputs, self._inert(fields), body)
        return self._graphs.replay(key, inputs, arrays)

    def _reserve_tickets(self, key: tuple, fields: dict) -> None:
        """The paged kernels' split tickets, sized before a capture for the
        graph's largest (lanes, kv heads, 16-row tiles): decode steps and,
        for a verify graph, its S positions per lane."""
        from dynamo_tpu_torch.ops.cuda_attention import PAGED_ROWS, reserve_tickets

        B = fields["tokens"][1][0]
        G = self.config.num_heads // self.config.num_kv_heads
        S = key[1] if key[0] == "verify" else 1
        hkv = self.config.num_kv_heads
        reserve_tickets(self.device, B * hkv * -(-S * G // PAGED_ROWS))

    @property
    def warm_events(self) -> int:
        """One-off costs paid so far: this runner's graph captures plus the
        kernel libraries loaded into the process. A dispatch during which
        it moves is cold (the engine keeps its token gaps out of
        ``inter_token``)."""
        from dynamo_tpu_torch.ops import _build

        captures = self._graphs.captures if self._graphs is not None else 0
        return captures + _build.load_events

    @property
    def graph_replays(self) -> int:
        return self._graphs.replays if self._graphs is not None else 0

    @torch.inference_mode()
    def launch_graph(self, kind: str) -> None:
        """Launch the graph of the last ``kind`` dispatch ("decode",
        "decode_multi" or "verify") again on its inputs as they are, without
        waiting for the card: the host's cost of a graphed dispatch, for
        timing. It counts as a replay."""
        key = self._last[kind]
        self._graphs.launch(key, self._inputs[key])

    def graph_stats(self) -> dict[str, dict]:
        """Each captured graph's capture seconds, replays and the kernel
        launches one replay makes, by key (graphs.StepGraphs.stats)."""
        return self._graphs.stats() if self._graphs is not None else {}

    def decode_multi_ready(self, H: int) -> bool:
        """Whether the horizon H is prepared (``prepare_decode_multi_async``):
        its plain graphs captured, or, without graphs, nothing to prepare.
        Raises the preparation's error if it failed."""
        if self._prepare_error is not None:
            raise RuntimeError(f"preparing decode_multi@H{H} failed") from self._prepare_error
        return H in self._prepared

    def prepare_decode_multi_async(self, H: int, executor) -> None:
        """Queue the capture of the horizon H's plain graphs (no penalties,
        no EOS mask; greedy and sampled) on ``executor``: the engine's one
        device thread, so the capture runs between dispatches and never
        beside one. Idempotent. Without graphs it only marks H ready."""
        if H in self._prepared or H in self._pending:
            return
        self._pending.add(H)
        executor.submit(self._prepare_decode_multi, H)

    @torch.inference_mode()
    def _prepare_decode_multi(self, H: int) -> None:
        try:
            if self.cuda_graphs:
                B, nb = self.max_batch, self.max_blocks_per_seq
                fields = self._multi_fields(B, nb)
                for greedy in (True, False):
                    key = self._key("decode_multi", fields, H, pen=False, mask=False,
                                    greedy=greedy)
                    if key in self._graphs:
                        continue
                    inputs = self._inputs.get(key)
                    if inputs is None:
                        inputs = self._inputs[key] = StepInputs(fields, self.device)
                    self._reserve_tickets(key, fields)
                    self._graphs.capture(
                        key, inputs, self._inert(fields),
                        functools.partial(self._decode_multi_body, H=H, pen=False, mask=False,
                                          greedy=greedy))
            self._prepared.add(H)
        except Exception as e:  # noqa: BLE001 - surfaced by decode_multi_ready
            self._prepare_error = e
        finally:
            self._pending.discard(H)

    def fetch_sample(self, out: SampleOut) -> tuple[np.ndarray, ...]:
        """Bring a sample tuple to the host with ONE device-to-host copy: the
        pieces are packed into one flat f32 tensor on the device (token ids
        < 2^24 are exact in f32) and split back, each in its own dtype."""
        with torch.inference_mode():
            flat = torch.cat([t.reshape(-1).float() for t in out]).cpu().numpy()
        outs, off = [], 0
        for t in out:
            n = t.numel()
            piece = flat[off:off + n].reshape(tuple(t.shape))
            off += n
            outs.append(piece.astype(np.int32 if t.dtype == torch.int32 else np.float32))
        return tuple(outs)
