"""TorchEngine: the worker's continuous-batching loop over a TorchModelRunner.

Counterpart of dynamo_tpu/engine/jax_engine/engine.py (``JaxEngine``), with
the same contract: ``generate(PreprocessedRequest, Context)`` streams
``LLMEngineOutput`` token frames and ends with one frame that carries the
finish reason. It is the JAX engine's single-worker loop with its defaults,
reduced to:

  * a waiting queue ordered by (QoS class rank, deadline, arrival), as the
    JAX engine's ``_queue_key`` (engine.py:1013-1026): the class resolved at
    the edge (``qos.priority_of``: the Context's decision metadata, else the
    request's ``extra["priority"]``), interactive before standard before
    bulk, then the earlier deadline (none last), then arrival; a prompt is
    admitted when a batch lane and its blocks (plus a watermark reserve)
    are free. With chunking on (the
    runner's ``prefill_chunk_tokens`` C > 0, the default), admission routes
    as ``JaxEngine._admit_phase`` does: a prompt (or, after a preemption,
    prompt + generated tokens) longer than C is prefilled chunk by chunk,
    and shorter ones are packed greedily, up to C tokens and ``max_batch``
    segments, into one packed prefill per group. With C = 0 every prompt
    is prefilled on its own (the reference's chunking-off path);
  * per loop iteration, with prompts still being chunked and decode lanes
    running, one mixed step (``DYN_MIXED_STEP``, on by default) carries up
    to ``chunk_budget`` prompt tokens (``DYN_CHUNK_BUDGET``; 0 means 2 x C)
    in at most ceil(budget / C) chunk slots together with the whole decode
    batch. Mixing is off while a drafter is active or a lane has penalties;
    then one chunk runs on its own, followed by the decode step. A chunk's
    sample is read back only on the prompt's final chunk;
  * one batched decode dispatch over every running lane per loop
    iteration: with ``decode_horizon`` H > 1 (the factory's default on a
    card is 4) a horizon of H chained steps (``runner.decode_multi``,
    ``_horizon_for`` / ``_decode_multi_phase``): H is capped by the largest
    lane budget, KV blocks for every write of the horizon are allocated up
    front (under block pressure the dispatch is a single step, whose
    allocation may preempt), and the packed samples go through the same
    ``_append_token`` as a single step's, frozen steps (-1) skipped; a
    min_tokens lane with more stop ids than the device mask holds makes
    the dispatch a single step. Mixed steps are off while H > 1, as in the
    reference. ``lazy_horizon`` single-steps until the runner has prepared
    H (captured its graphs on the device thread, between dispatches); a
    horizon dispatch that then fails is logged, every lane holding a slot
    fails with ERROR and H drops to 1 (the reference's degrade; counted in
    ``horizon_degrades``). Or, with ``spec_k > 0``, one speculative verify
    dispatch when enough lanes carry a draft: an n-gram drafter
    (drafter.py) proposes up to spec_k tokens per lane from its own
    history, one weight pass scores them all, the host accepts each lane's
    longest matching prefix plus the model's next token, and with H > 1
    the same dispatch chains H - 1 decode steps from the accept point the
    device computes (not for penalty batches) (``_collect_drafts`` /
    ``_spec_decode_phase``, after the JAX engine's);
  * stop conditions: ``max_tokens`` (default 16), EOS and
    ``stop_token_ids_hidden`` unless ``ignore_eos`` (the stop token itself
    is not streamed), and ``max_model_len``;
  * frequency / presence / repetition penalties and ``min_tokens``, as the
    JAX engine applies them (engine.py:304-345): the runner penalises the
    logits on the device (the history goes up only when a lane has
    penalties) and masks the first MAX_EOS_IDS stop ids until a sequence
    has its minimum; a stop id past those that is still sampled early is
    dropped and redrawn with a fresh key, at most four times;
  * a prompt longer than ``max_model_len`` is refused (``prompt_too_long``);
  * deadlines (the Context's ``deadline`` and ``ttft_deadline``), shed at
    the JAX engine's four points with its phases, messages and code
    ``deadline_exceeded``, each counted in ``deadline_exceeded``: at submit
    (engine.py:593-598, phase ``admission``), while queued (:1489-1503,
    ``queue``; the TTFT budget too), while awaiting a remote prefill
    (:1509-1523, ``remote_prefill``: the sequence keeps its blocks until its
    task ends) and admitted (:1525-1538, ``decode``: the TTFT budget until
    the first token), the last three checked once per loop iteration (with
    a horizon, once per dispatch); a shed lane frees its lane and blocks;
  * the migration resume contract (engine.py:251-260): a request whose
    ``extra["resume_prompt_len"]`` is shorter than its token ids replays a
    dead worker's stream; the tail past it counts as generated output, so
    ``max_tokens``, ``min_tokens``, the penalties' history and the
    per-token sampling counter continue where that worker stopped;
  * ``fence(reason)`` (engine.py:3237-3251; the distributed runtime's
    self-fence on primary-lease loss): admission stops, every lane fails
    with ``worker_fenced`` and new requests are refused with it;
  * cancellation (``Context.kill`` or the consumer leaving the stream)
    frees the lane and its blocks at the next loop step, also mid-chunk;
  * when a growing sequence finds no free block, another running sequence
    (one still being chunked included, one awaiting a remote prefill not) is
    preempted, chosen by class (``_preempt_victim``, engine.py:1263-1300):
    the lowest class first (bulk, then standard, then interactive), the
    youngest within a class, and never one whose class outranks the
    grower's. When every other lane outranks it, the grower yields itself
    (engine.py:3184-3200). A preempted sequence's blocks are freed and it is
    re-queued, at its place in the queue order (it keeps its arrival
    number), with its generated tokens, which are re-prefilled on
    re-admission (recompute preemption; with a block manager its
    KV-complete blocks go to the host tier first and re-admission onboards
    them). ``preemptions_by_class`` counts every preemption by the victim's
    class.
    The storm guard (engine.py:126-139, :1307-1350): a sequence preempted
    more than ``max_preemptions`` times (``DYN_MAX_PREEMPTIONS``, 8) fails
    with the structured error ``preempted_too_often``, and each re-queue
    waits out a backoff of ``preempt_backoff_ms`` (``DYN_PREEMPT_BACKOFF_MS``,
    25) doubled per preemption, capped at 2 s, during which later arrivals
    may be admitted before it.
  * disaggregated prefill (engine.py:1631-1659, :2003-2607). As a decode
    worker, with a ``disagg_router`` and a ``remote_prefill_client``
    (disagg/), an admitted sequence whose prompt the router ships holds its
    lane and blocks while a task awaits the remote prefill
    (``_remote_prefill_task``); its KV lands in its blocks (streamed frames
    as they come, then the final payload, or the device payload of a
    colocated prefill engine) and the sequence joins the decode batch at the
    next loop iteration (``_process_landed``): with a horizon, the next
    dispatch. It is skipped by the decode batch and by preemption while it
    waits, and a killed one keeps its blocks until its task ends. A remote
    prefill that fails, or a stream that lost a frame, falls back to a local
    prefill of the prompt on this engine's device, counted in
    ``remote_fallbacks`` and logged. As a prefill worker, ``prefill_only``
    (host payload), ``prefill_only_stream`` (frames per chunk) and
    ``prefill_only_device`` (blocks left on the card) prefill a request on
    scratch blocks of this engine's pool, freed when the call returns.
  * the tiered block manager (engine.py:940-1410, :1586-1690, :2195), with a
    ``block_manager`` (block_manager/): each sequence carries its block-hash
    chain (tokens.py); a block offloads to the host tier as soon as its KV
    is complete (the bounded ``OffloadQueue``, at most ``offload_per_step``
    blocks a loop iteration), a preempted sequence's blocks spill to it
    instead of being dropped, and a finished one's go there before its
    device blocks recycle; at admission the prompt's chain is looked up in
    the host and disk tiers, the hit is onboarded into the sequence's
    leading blocks in place and the prompt is chunked from after it (a
    shipped prompt's hit is onboarded and not shipped: ``cached_blocks``).
    Blocks move as the cache's own pages between the card and the pinned
    host arena (int8 pages verbatim into int8 tiers), or through the host
    codec when the tiers' form differs. Offloads and onboards are
    best-effort, as in the reference, and every failure is counted
    (``kv_offload_errors`` / ``kv_onboard_errors``) and logged;
  * the peer tier (G4-lite; engine.py:1596-1631), with a ``peer_block_client``
    (block_manager/peer.py) beside the block manager: at admission, after
    the tier lookup, the router's pull plan (riding the Context) gives the
    tier its fleet heat (``note_fleet_heat``), and while the tiers miss part
    of the prompt's chain the client pulls it from the peer the plan names
    (or the best advertised one) into the local tier under a ``peer_fetch``
    span; the lookup then runs again, so onboarding injects the pulled
    blocks. The client's counts by outcome are mirrored into
    ``kv_pull_outcomes`` after each fetch. As in the reference, only library
    code builds the peer tier (no worker flag);
  * KV events: ``on_blocks_stored`` gets a Stored event per newly complete
    block (hash, parent hash, tokens, block id), ``on_blocks_removed`` the
    hashes whose last holding sequence freed them, ``on_cache_cleared``
    fires on ``clear_kv_blocks``;
  * the stuck-dispatch watchdog (engine.py:710-870): every device call is
    labelled and timed into a per-label EMA; one running past
    max(``watchdog_min_s``, ``watchdog_mult`` x EMA), or a label's first
    past ``watchdog_cold_s`` (``DYN_WATCHDOG_*``: 30 s, 8, 300 s), fails
    every lane with ``watchdog_stuck``, closes the engine (new requests get
    ``worker_unavailable``), fires ``on_watchdog_trip`` and counts
    ``watchdog_trips``.

A ``chunk_budget`` that is not a multiple of the KV block size raises: the
reference slices chunks by the remaining budget, so such a budget would
start a chunk off a block boundary and scatter its K/V to the wrong
positions.

Per-token sampling keys are (request seed or engine stream + sequence id,
number of generated tokens), as in the JAX engine, so a seeded request gives
the same tokens whatever the batch around it. Device calls run one at a time
on a single worker thread so the event loop keeps streaming while the card
works; every engine on one device runs them holding that device's lock
(``_card_lock``), so two engines sharing a card (a colocated prefill and
decode pair) never overlap a graph capture with the other's work; their
device jobs run one after the other, so a shipped prompt's prefill holds
the decode engine's running lanes until it ends.

A worker (``entrypoint/inputs.run_endpoint``) subscribes its KV event
callbacks to a ``kv_router.KvEventPublisher`` and publishes
``inputs.load_metrics(engine)`` for the KV-aware router.

Under a tensor-parallel group the engine serves every role above (a decode
worker, a prefill worker, tiers): its runner's block moves run on every rank
through the step channel (parallel/multihost.py).

Request tracing (engine.py:526-552; ``telemetry/trace.py``, on with
``DYN_TRACE=1``): each sequence carries its open phase spans, parented
under the trace context riding its Context, on the ``trace_proc`` track:
``queue_wait`` (again after a preemption), ``prefill`` (a ``prefill_chunk``
event per chunk) or ``remote_prefill`` (its ``kv_land`` child spans per
streamed frame), then ``decode``, which gets a ``decode_step``,
``decode_horizon`` or ``spec_verify`` event per dispatch, on the host after
the fetch (at most 64 a span). The events ``preempted``,
``preempted_too_often``, ``deadline_exceeded``, ``watchdog_trip``, ``error``
and ``worker_fenced`` mark the lane's fate. Fault injection
(``testing/faults.py``, armed by ``DYN_FAULT``): ``on_dispatch`` and the
gray-worker stretch (``slow_decode`` / ``gray_flap``, folded into the
watchdog's EMA) around every device call, ``on_transfer`` before an offload
and before a remote prefill lands, ``on_token`` per emitted token
(``kill_after_tokens`` SIGKILLs the process, ``abort_after_tokens`` fails
every lane with ``injected_fault`` through ``_abort_all`` and keeps
serving). Off, each hook costs one flag check.

Always-on phase histograms (engine.py:334, :559-571, :1570;
``telemetry/histogram.py``): ``queue_wait`` at a first admission, and at the
stream edge ``ttft``, ``prefill`` (admitted to first token), ``inter_token``
and ``e2e``, in ``EngineStats.phase_histograms``. They are marked on the host
when a fetch hands tokens to the stream, as in the reference, one
``inter_token`` sample a token gap; but a gap whose delivery waited on a
graph capture, a kernel load or, on a card, a label's first dispatch is
left out (such a first token's TTFT is kept). The health plane's own series are apart, in
``EngineStats.health_histograms`` (shipped on ForwardPassMetrics, on no
``/metrics``): ``ttft_cold``, those cold first tokens' TTFTs, which the
scorer subtracts from ``ttft``, and ``pace``, which it reads in place of
``inter_token``: under a decode horizon of H the reference's gaps are one
of ~H steps and H - 1 near 0 per dispatch, whose median is the stream
consumer's pacing, so in ``pace`` each token of a fetch takes its share of
the fetch's gap (``telemetry/health.StreamPace``), cold fetches left out
(C15: those near-zero medians and one-off stalls scored fresh workers as
gray stragglers).

The brownout ladder (``apply_brownout``, engine.py:1029-1060;
``telemetry/brownout.py``): level >= 1 sheds bulk arrivals with the typed
``brownout_shed`` error (``stats.shed_brownout``), >= 2 pauses drafting (the
decode phase runs the decode step or horizon instead, captured as a graph on
its first use like any other), >= 3 halves the chunk width and the per-step
chunk budget (``qos.effective_chunk_budget``, on the KV block grid; latched
once per loop iteration), >= 4 sheds standard arrivals too.

Multimodal prompts (engine.py:1575-1584, :1739-1775): a request whose
``extra["mm"]`` holds vision embeddings and their start (set by
``multimodal/worker.MultimodalEngine``) is prefilled on its own by the
runner's ``prefill_mm``, and skips the tiers' and the peers' prefix lookup,
disagg shipping, chunking and packing. It builds no hash chain, so it emits
no KV event: two prompts with different images share the same placeholder
tokens, and a router would route on the poisoned hashes. ``embed`` (the
``/v1/embeddings`` path, :2532) runs the runner's pooled forward in turn
with the loop's dispatches.

The goodput ledger and the perf gauges (engine.py:752-798, :3265-3319;
``telemetry/goodput.py``, ``perf_model.py``): every dispatch lands in
``stats.goodput`` (``record_step`` with its label, decode lanes, capacity
and prompt tokens; ``record_compile`` on a label's first). A *recompile* is
a later dispatch that the runner's ``warm_events`` mark cold (a graph
capture or a kernel-library load), counted ``prebake_miss`` when the kernel
cache's prebake manifest covers the label and ``shape_miss`` otherwise:
the card's exact signal in place of the reference's EMA guess. Waste is
recorded at the reference's causes (a migration's replayed tail, a
preemption's discarded KV, a deadline's or a cancel's partial output, the
verify pass's rejected drafts). After each decode or mixed phase the
modelled ``decode_hbm_bytes_per_token`` / ``tp_collective_bytes_per_step``
of the live batch and a windowed ``mfu_decode_est`` are refreshed. With
tracing on, the counter tracks ``step_ms``, ``occupancy``,
``mfu_achieved`` and ``tokens_wasted`` go on the timeline. Preemption
victims and re-admission backoffs are decision records
(``telemetry/provenance.py``).
"""

from __future__ import annotations

import asyncio
import bisect
import collections
import concurrent.futures
import contextlib
import itertools
import logging
import os
import threading
import time
from collections.abc import AsyncIterator
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from dynamo_tpu_torch import qos
from dynamo_tpu_torch.block_manager.offload import OffloadQueue
from dynamo_tpu_torch.disagg.colocated import DevicePrefillResponse
from dynamo_tpu_torch.disagg.protocols import (
    KvBlockPayload,
    KvStreamFrame,
    PrefillStreamCancelled,
    RemotePrefillResponse,
    dtype_name,
    wire_codec_from_env,
)
from dynamo_tpu_torch.engine.torch_engine import perf_model
from dynamo_tpu_torch.engine.torch_engine.drafter import make_drafter
from dynamo_tpu_torch.engine.torch_engine.kv_cache import BlockAllocator, OutOfBlocks
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.ops.sampling import MAX_EOS_IDS, SAMPLE_CANDIDATES, make_key_data
from dynamo_tpu_torch.pipeline.context import decisions_of
from dynamo_tpu_torch.protocols.common import (
    Context,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.telemetry import brownout as dbrownout
from dynamo_tpu_torch.telemetry import profile as dprofile
from dynamo_tpu_torch.telemetry import provenance as dprov
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.telemetry.goodput import GoodputLedger, load_prebaked_labels, normalize_label
from dynamo_tpu_torch.telemetry.health import StreamPace
from dynamo_tpu_torch.telemetry.histogram import PhaseHistograms
from dynamo_tpu_torch.testing import faults
from dynamo_tpu_torch.tokens import TokenBlockSequence

logger = logging.getLogger("dynamo_tpu_torch.engine")


@dataclass
class TorchEngineConfig:
    max_batch: int = 8
    block_size: int = 16
    num_blocks: int = 512
    max_model_len: int = 2048
    watermark_blocks: int = 8  # admission reserve
    rng_seed: int = 0
    # self-drafting speculative decoding (0 = off): up to spec_k drafted
    # tokens per lane, verified in one weight pass (runner.spec_verify)
    spec_k: int = 0
    spec_drafter: str = "ngram"
    spec_ngram_min: int = 2
    spec_ngram_max: int = 4
    # least fraction of active lanes with a draft for a verify dispatch to
    # replace a plain decode step
    spec_min_coverage: float = 0.5
    # prompt tokens that may ride one mixed step, over all its chunk slots;
    # 0 = two chunks' worth. A multiple of block_size.
    chunk_budget: int = field(
        default_factory=lambda: int(os.environ.get("DYN_CHUNK_BUDGET", "0") or 0)
    )
    # mixed steps (chunks inside the decode batch's step); off alternates a
    # chunk and a decode step, with the same output streams
    mixed_step: bool = field(
        default_factory=lambda: os.environ.get("DYN_MIXED_STEP", "1").lower()
        not in ("0", "false", "no", "off")
    )
    # decode steps chained in one dispatch (1 = a step per dispatch); the
    # factory's default is 4 on a card and 1 on the CPU
    decode_horizon: int = 1
    # single-step until the runner has prepared the horizon's graphs
    lazy_horizon: bool = False
    # the preemption-storm guard: more preemptions than this fail the
    # sequence; each re-queue waits base * 2^(n - 1) ms, at most 2 s
    max_preemptions: int = field(
        default_factory=lambda: int(os.environ.get("DYN_MAX_PREEMPTIONS", "8"))
    )
    preempt_backoff_ms: float = field(
        default_factory=lambda: float(os.environ.get("DYN_PREEMPT_BACKOFF_MS", "25"))
    )
    # mid-generation offload: at most this many blocks copied to the host
    # tier per loop iteration (0: offload at a sequence's end only)
    offload_per_step: int = 4
    # the stuck-dispatch watchdog: a dispatch past max(watchdog_min_s,
    # watchdog_mult x its label's EMA), or a label's first past
    # watchdog_cold_s, fails every lane and closes the engine;
    # watchdog_min_s <= 0 turns it off
    watchdog_mult: float = field(
        default_factory=lambda: float(os.environ.get("DYN_WATCHDOG_MULT", "8"))
    )
    watchdog_min_s: float = field(
        default_factory=lambda: float(os.environ.get("DYN_WATCHDOG_MIN_S", "30"))
    )
    watchdog_cold_s: float = field(
        default_factory=lambda: float(os.environ.get("DYN_WATCHDOG_COLD_S", "300"))
    )


def check_chunk_budget(chunk_budget: int, block_size: int) -> None:
    """A mixed step slices chunks by the budget left, so a budget off the
    block grid would start a chunk mid-block."""
    if chunk_budget > 0 and chunk_budget % block_size:
        raise ValueError(
            f"chunk_budget (DYN_CHUNK_BUDGET) {chunk_budget} is not a multiple of "
            f"the KV block size {block_size}: a chunk would start off a block "
            "boundary and its K/V would land at the wrong positions"
        )


@dataclass
class EngineStats:
    prefills: int = 0  # per-sequence prefill calls (re-prefills after preemption included)
    packed_prefills: int = 0  # packed prefill calls
    chunk_steps: int = 0  # prefill chunks run on their own
    mixed_steps: int = 0  # mixed steps (chunk slots + the decode batch)
    decode_steps: int = 0  # batched single-step decode calls
    # decode horizon: dispatches, the step bodies they ran (H each, frozen
    # steps included) and the tokens they emitted
    horizon_dispatches: int = 0
    horizon_steps: int = 0
    horizon_tokens: int = 0
    horizon_degrades: int = 0  # lazy-horizon failures that dropped H to 1
    graph_replays: int = 0  # CUDA graph replays of the runner's step programs
    generated_tokens: int = 0
    preemptions: int = 0
    preempted_too_often: int = 0  # sequences the storm guard failed
    preemptions_by_class: dict = field(default_factory=dict)  # the victim's class
    # speculative decoding: a "draft" is one lane-dispatch carrying >= 1
    # proposed token; verify_steps counts verify dispatches
    num_drafts: int = 0
    num_draft_tokens: int = 0
    num_accepted_tokens: int = 0
    accepted_per_pos: list = field(default_factory=list)  # len spec_k
    verify_steps: int = 0
    verify_chained_steps: int = 0  # decode steps chained after verify passes
    # disaggregated prefill, decode role: prompts shipped to the remote
    # prefill client, and those that fell back to a local prefill
    remote_prefills: int = 0
    remote_fallbacks: int = 0
    # prefill role: requests served by prefill_only*
    prefills_served: int = 0
    # the KV data plane (engine.py:185-195): tx = frames / payload bytes
    # this worker ships as a prefill worker, rx = those it lands as a decode
    # worker; kv_bytes_overlapped = bytes landed before the final frame
    kv_frames_tx: int = 0
    kv_frames_rx: int = 0
    kv_wire_bytes_tx: int = 0
    kv_wire_bytes_rx: int = 0
    kv_bytes_overlapped: int = 0
    # prefill role over the fabric (disagg/transfer.PrefillWorkerService):
    # frames encoded but not yet published (a gauge, bounded by the frame
    # window), and queued requests dropped past their deadline
    kv_frames_inflight: int = 0
    prefill_dropped_expired: int = 0
    # the tiered block manager: blocks newly stored by offloads (mid-
    # generation, preemption spills and ends), preemptions that spilled,
    # blocks onboarded into admitted sequences, and the offloads / onboards
    # that raised (best-effort: the prefix is recomputed)
    kv_offloaded_blocks: int = 0
    kv_offload_errors: int = 0
    preempt_spills: int = 0
    kv_onboarded_blocks: int = 0
    kv_onboard_errors: int = 0
    # the peer tier: prefix blocks pulled from peers by outcome
    # (block_manager/peer.PULL_OUTCOMES), mirrored from the client
    kv_pull_outcomes: dict = field(default_factory=dict)
    # the stuck-dispatch watchdog
    watchdog_trips: int = 0
    # requests shed on their deadline or TTFT budget (the four points)
    deadline_exceeded: int = 0
    # engine-side brownout sheds and the live brownout rung (a gauge)
    shed_brownout: int = 0
    brownout_level: int = 0
    # always-on per-phase latency histograms (queue_wait / ttft / prefill /
    # inter_token / e2e), shipped on ForwardPassMetrics
    phase_histograms: PhaseHistograms = field(default_factory=PhaseHistograms)
    # the health plane's own series (C15): ``pace``, the token pace by
    # delivery, and ``ttft_cold``, the TTFTs of cold first tokens; shipped
    # on ForwardPassMetrics beside the phase histograms
    health_histograms: PhaseHistograms = field(default_factory=PhaseHistograms)
    # dispatches that captured a graph or loaded a kernel library (their
    # token gaps stay out of inter_token and pace), and the gaps so left out
    cold_dispatches: int = 0
    cold_gaps: int = 0
    # multimodal prefills (extra["mm"]) and pooled embeddings served
    mm_prefills: int = 0
    embeds: int = 0
    # the decode-bandwidth gauges (perf_model.py): modelled HBM bytes per
    # emitted token of the live batch (per card under a group), the tp
    # axis's collective bytes per step, and a windowed-rate MFU estimate
    decode_hbm_bytes_per_token: float = 0.0
    mfu_decode_est: float = 0.0
    tp_collective_bytes_per_step: float = 0.0
    # each decode or mixed dispatch's modelled bytes per token at its batch
    # times the tokens it emitted, summed: the bytes the model says
    # decoding moved (held against the card's memory rate)
    modelled_decode_bytes: float = 0.0
    # the goodput ledger (telemetry/goodput.py), shipped on ForwardPassMetrics
    goodput: GoodputLedger = field(default_factory=GoodputLedger)

    @property
    def tokens_per_horizon(self) -> float:
        return self.horizon_tokens / self.horizon_dispatches if self.horizon_dispatches else 0.0

    @property
    def kv_stream_overlap(self) -> float:
        """Share of the received KV wire bytes that landed before the final
        frame (transfer hidden behind the remote prefill's compute)."""
        return self.kv_bytes_overlapped / max(1, self.kv_wire_bytes_rx)


class _Sequence:
    def __init__(self, seq_id: int, request: PreprocessedRequest, ctx: Context) -> None:
        self.seq_id = seq_id
        self.request = request
        self.ctx = ctx
        self.token_ids = list(request.token_ids)  # prompt + generated
        self.num_prompt = len(self.token_ids)
        # in-flight migration replay (engine.py:251-260): the tail past
        # resume_prompt_len is output a dead worker already streamed;
        # counted as generated, it keeps max_tokens, min_tokens, penalties'
        # history split and the per-token sampling counter where the
        # unfaulted run has them
        resume = int(request.extra.get("resume_prompt_len") or 0)
        if 0 < resume < len(self.token_ids):
            self.num_prompt = resume
        self.block_ids: list[int] = []
        self.slot: Optional[int] = None
        self.prefilling = False  # admitted, chunked prefill in progress
        self.pending_remote = False  # admitted, awaiting its remote prefill's KV
        self.prefill_pos = 0  # tokens chunked so far
        self.arrival_order = 0
        # the QoS class resolved at the edge orders the waiting queue
        self.priority = qos.priority_of(ctx, request)
        self.rank = qos.rank_of(self.priority)
        self.deadline_fired = False  # the deadline error was sent (remote prefill)
        self.out: asyncio.Queue = asyncio.Queue()
        self.eos: set[int] = set()
        if not request.stop.ignore_eos:
            self.eos = set(request.eos_token_ids) | set(request.stop.stop_token_ids_hidden)
        s = request.sampling
        self.temperature = 0.0 if s.greedy else (
            s.temperature if s.temperature is not None else 1.0
        )
        self.top_p = s.top_p if s.top_p is not None else 1.0
        # the sampler draws restricted rows from a SAMPLE_CANDIDATES pool
        self.top_k = min(s.top_k if s.top_k is not None else 0, SAMPLE_CANDIDATES)
        self.max_new = request.stop.max_tokens or 16
        self.min_tokens = request.stop.min_tokens or 0
        self.freq_pen = float(s.frequency_penalty or 0.0)
        self.pres_pen = float(s.presence_penalty or 0.0)
        self.rep_pen = float(s.repetition_penalty or 1.0) or 1.0
        self.has_penalties = bool(self.freq_pen or self.pres_pen or self.rep_pen != 1.0)
        self.seed = s.seed
        self.want_logprobs = bool(s.logprobs)
        self.num_top_lp = min(int(s.top_logprobs or 0), 20)
        # min_tokens: the first MAX_EOS_IDS sorted stop ids are masked on the
        # device until the minimum is generated
        self.eos_row = np.full(MAX_EOS_IDS, -1, np.int64)
        for j, t in enumerate(sorted(self.eos)[:MAX_EOS_IDS]):
            self.eos_row[j] = t
        self.eos_drops = 0  # early stop ids past the mask, dropped and redrawn
        # spec decoding: consecutive fully rejected drafts, and dispatches
        # left before this lane drafts again
        self.spec_fail = 0
        self.spec_backoff = 0
        # storm guard: preemptions so far, and when it may be re-admitted
        self.preemptions = 0
        self.requeue_after = 0.0
        # the block-hash chain (KV events, offload) and how many of its
        # blocks were published; the chain built at admission for the prefix
        # lookup, its hashes, and the leading blocks found in the tiers
        self.hash_seq: Optional[TokenBlockSequence] = None
        self.emitted_hashes = 0
        self.pending_chain: Optional[TokenBlockSequence] = None
        self.prefix_hashes: list[int] = []
        self.cached_prefix_blocks = 0
        self.offload_mark = 0  # chain blocks already queued for offload
        # open telemetry phase spans (queue_wait / prefill / decode / ...)
        self.spans: dict = {}
        # always-on phase-timing marks (feed EngineStats.phase_histograms)
        self.t_arrival = time.monotonic()
        self.t_admitted: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        # the stream's token pace from its first token on (C15)
        self.pace: Optional[StreamPace] = None
        # the engine's cold-dispatch count at this sequence's arrival or
        # last delivery: a delivery after it moved is marked cold (C15)
        self.cold_seen = 0

    @property
    def num_generated(self) -> int:
        return len(self.token_ids) - self.num_prompt

    @property
    def kv_written(self) -> int:
        """Positions whose KV is in the device cache. A sampled token's KV
        is written when it is fed to the next step (within a horizon or a
        verify pass too: every appended token but the newest was fed), so
        the newest is never written: offloading a block holding it would
        store a hole under its hash."""
        return self.num_prompt + max(0, self.num_generated - 1)

    @property
    def needs_eos_suppress(self) -> bool:
        return self.min_tokens > 0 and self.num_generated < self.min_tokens and bool(self.eos)

    def blocks_needed(self, block_size: int) -> int:
        return (len(self.token_ids) + block_size - 1) // block_size


# One lock per device, shared by every engine of the process on it: a CUDA
# graph capture (global capture mode) fails when another thread touches the
# device meanwhile, so engines sharing a card take turns at it.
_CARD_LOCKS: dict[str, threading.Lock] = {}
_CARD_LOCKS_GUARD = threading.Lock()


def _card_lock(device) -> threading.Lock:
    with _CARD_LOCKS_GUARD:
        return _CARD_LOCKS.setdefault(str(device), threading.Lock())


class _DeviceThread(concurrent.futures.Executor):
    """The engine's one device thread; each job runs holding its device's
    lock."""

    def __init__(self, lock: threading.Lock) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-engine")
        self._lock = lock

    def submit(self, fn, /, *args, **kwargs):
        def locked():
            with self._lock:
                return fn(*args, **kwargs)

        return self._pool.submit(locked)

    def shutdown(self, wait: bool = True, *, cancel_futures: bool = False) -> None:
        self._pool.shutdown(wait=wait, cancel_futures=cancel_futures)


class TorchEngine:
    """AsyncEngine over a TorchModelRunner (see the module docstring).
    ``disagg_router`` and ``remote_prefill_client`` make it a decode worker
    of disaggregated prefill; ``block_manager`` (a
    ``block_manager.TieredBlockManager``) gives it host and disk tiers, and
    ``peer_block_client`` (a ``block_manager.PeerBlockClient`` over the same
    manager) the peer tier; ``on_blocks_stored`` / ``on_blocks_removed``
    receive its KV events. An engine under a tensor-parallel group takes all
    of them: its runner's block moves run on every rank
    (parallel/multihost.py)."""

    def __init__(
        self, runner: TorchModelRunner, config: Optional[TorchEngineConfig] = None,
        disagg_router: Optional[Any] = None, remote_prefill_client: Optional[Any] = None,
        block_manager: Optional[Any] = None,
        on_blocks_stored: Optional[Callable[[list[dict]], None]] = None,
        on_blocks_removed: Optional[Callable[[list[int]], None]] = None,
        peer_block_client: Optional[Any] = None,
    ) -> None:
        self.runner = runner
        self.config = config or TorchEngineConfig(
            max_batch=runner.max_batch,
            block_size=runner.block_size,
            num_blocks=runner.num_blocks,
            max_model_len=runner.max_model_len,
        )
        check_chunk_budget(self.config.chunk_budget, self.config.block_size)
        self.allocator = BlockAllocator(self.config.num_blocks)
        self.slots: list[Optional[_Sequence]] = [None] * self.config.max_batch
        self.waiting: list[_Sequence] = []
        self.stats = EngineStats()
        # the latest admissions (re-admissions too): request id, prompt
        # tokens and the prefix blocks found in the tiers
        self.admissions: collections.deque = collections.deque(maxlen=1024)
        self._seq_ids = itertools.count(1)
        self._arrivals = itertools.count(1)
        self._admit_order: list[_Sequence] = []  # youngest last, for preemption
        # admitted prompts being prefilled one chunk at a time
        self._prefilling: list[_Sequence] = []
        # per-step prompt-token budget of a mixed step and its chunk-slot cap
        C = runner.prefill_chunk_tokens
        budget = self.config.chunk_budget if self.config.chunk_budget > 0 else 2 * C
        self._chunk_budget_base = budget
        # the chunk width and per-step budget, latched once per loop
        # iteration (a brownout chunk cap lands at a step boundary)
        self._step_chunk_tokens = C
        self._step_chunk_budget = budget
        # brownout ladder rung applied by the host wiring (apply_brownout)
        self._brownout_level = 0
        self._spec_paused = False
        self._mixed_max_slots = max(1, -(-budget // C)) if C else 0
        self._mixed_enabled = self.config.mixed_step and C > 0
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._closed = False
        self._executor = _DeviceThread(_card_lock(runner.device))
        # disaggregated prefill: the remote-prefill tasks, and what they
        # landed (sequence, first sample or None, failure reason or None),
        # completed on the engine loop
        self.disagg_router = disagg_router
        self.remote_prefill_client = remote_prefill_client
        self._remote_tasks: set[asyncio.Task] = set()
        self._landed: list[tuple[_Sequence, Optional[tuple], Optional[FinishReason]]] = []
        # the tiered block manager: blocks offloaded mid-generation through
        # the bounded queue (drained each loop iteration), at preemption and
        # at a sequence's end by offload tasks, and onboarded on prefix hits
        self.block_manager = block_manager
        self._offload_queue = OffloadQueue() if block_manager is not None else None
        self._tier_tasks: set[asyncio.Task] = set()
        # the peer tier: pulls the part of a prompt's chain the tiers miss
        # from another worker's tier
        self.peer_block_client = peer_block_client
        # KV events: a Stored event per newly complete block of a sequence,
        # a Removed one when the last sequence holding a hash frees it;
        # on_cache_cleared fires on clear_kv_blocks
        self.on_blocks_stored = on_blocks_stored
        self.on_blocks_removed = on_blocks_removed
        self.on_cache_cleared: Optional[Callable[[], None]] = None
        self._hash_refs: dict[int, int] = {}
        # the stuck-dispatch watchdog: the dispatch running on the device
        # thread (label, start), each label's EMA of its durations; a trip
        # fires on_watchdog_trip once
        self.on_watchdog_trip: Optional[Callable[[], None]] = None
        self._dispatch_info: Optional[tuple[str, float]] = None
        self._dispatch_ema: dict[str, float] = {}
        # each label's first dispatch in seconds: what the cold budget covers
        # (a graph capture rides a graphed label's first)
        self.dispatch_first_s: dict[str, float] = {}
        # the runner's warm events (graph captures, kernel library loads)
        # seen by the last dispatch's end (C15)
        self._warm_seen = getattr(runner, "warm_events", 0)
        # on a card a label's first dispatch is a one-off cost too: torch
        # loads the kernel modules of its ops, and cuBLAS its workspaces, on
        # first use (a fresh worker's first prefill took ~1.6 s on the H100)
        self._first_use_cold = str(runner.device).startswith("cuda")
        # dispatches run so far: the fetch id each token carries
        self._fetches = 0
        # recompile forensics: labels the kernel cache's prebake manifest
        # covers (a cold dispatch of one is cache drift)
        try:
            from dynamo_tpu_torch.runtime.config import kernel_cache_dir

            self._prebaked_labels = load_prebaked_labels(kernel_cache_dir())
        except Exception:  # noqa: BLE001 - forensics must never block start-up
            self._prebaked_labels = frozenset()
        # (time, generated tokens) samples of the MFU gauge's window, and
        # the tokens counted by the last refresh of the bytes gauge
        self._mfu_window: collections.deque = collections.deque()
        self._gauge_tokens = 0
        self._watchdog_task: Optional[asyncio.Task] = None
        self._tripped = False
        self._fenced = False  # self-fenced on primary-lease loss
        # persistent host-side decode arrays
        B = self.config.max_batch
        self._tokens = np.zeros(B, np.int64)
        self._positions = np.zeros(B, np.int64)
        self._block_tables = np.zeros((B, runner.max_blocks_per_seq), np.int32)
        self._slot_indices = np.zeros(B, np.int64)
        self._temps = np.zeros(B, np.float32)
        self._top_ps = np.ones(B, np.float32)
        self._top_ks = np.zeros(B, np.int64)
        self._keys = np.zeros((B, 2), np.int64)
        # unseeded sequences draw from (engine seed base + seq_id) streams
        self._seed_base = (self.config.rng_seed ^ 0x9E3779B9) & 0x7FFFFFFF
        self.drafter = None
        if self.config.spec_k > 0:
            self.drafter = make_drafter(
                self.config.spec_drafter, self.config.spec_k,
                min_n=self.config.spec_ngram_min, max_n=self.config.spec_ngram_max,
            )
            self.stats.accepted_per_pos = [0] * self.config.spec_k
        # trace process track (set by the worker host; None = process name)
        self.trace_proc: Optional[str] = None

    # ----------------------------------------------------------- telemetry

    def _sp_begin(self, seq: _Sequence, name: str, **attrs) -> None:
        sp = dtrace.begin(name, ctx=seq.ctx, proc=self.trace_proc, **attrs)
        if sp is not None:
            seq.spans[name] = sp

    def _sp_finish(self, seq: _Sequence, name: str, **attrs) -> None:
        dtrace.finish(seq.spans.pop(name, None), **attrs)

    def _sp_event(self, seq: _Sequence, name: str, **attrs) -> None:
        """A point event on the sequence's (single) open span."""
        for sp in seq.spans.values():
            sp.event(name, **attrs)
            return

    def _sp_close_all(self, seq: _Sequence) -> None:
        for name in list(seq.spans):
            self._sp_finish(seq, name)

    @staticmethod
    def _sp_span_event(seq: _Sequence, span: str, label: str, **attrs) -> None:
        """An event on one named open span, at most 64 a span (long
        generations must not grow a span without limit)."""
        sp = seq.spans.get(span)
        if sp is not None and len(sp.events) < 64:
            sp.event(label, **attrs)

    def _sp_batch_event(self, active: list, label: str, **attrs) -> None:
        """Mark one batched device dispatch on every member's decode span."""
        for seq in active:
            self._sp_span_event(seq, "decode", label, **attrs)

    # --------------------------------------------------------------- api

    async def generate(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[LLMEngineOutput]:
        if self._fenced:
            yield LLMEngineOutput.final_error(
                context.id, "admission",
                "worker is fenced (primary lease lost); request must be served elsewhere",
                "worker_fenced",
            )
            return
        if self._closed:
            yield LLMEngineOutput.final_error(
                context.id, "admission", "engine is closed or marked unhealthy",
                "worker_unavailable"
            )
            return
        if context.expired() or context.ttft_expired():
            self.stats.deadline_exceeded += 1
            yield LLMEngineOutput.final_error(
                context.id, "admission", "deadline expired before admission", "deadline_exceeded"
            )
            return
        n = len(request.token_ids)
        if n == 0:
            yield LLMEngineOutput.final_error(
                context.id, "admission", "empty prompt", "invalid_request"
            )
            return
        if n > self.config.max_model_len:
            yield LLMEngineOutput.final_error(
                context.id, "admission",
                f"prompt of {n} tokens exceeds max_model_len {self.config.max_model_len}",
                "prompt_too_long",
            )
            return
        if self._brownout_level:
            # engine-side brownout shed (direct-engine deployments; a fronted
            # fleet sheds at the HTTP AdmissionController first)
            prio = qos.priority_of(context, request)
            if prio in dbrownout.shed_classes_for(self._brownout_level):
                self.stats.shed_brownout += 1
                yield LLMEngineOutput.final_error(
                    context.id, "admission",
                    f"brownout level {self._brownout_level} "
                    f"({dbrownout.LADDER[self._brownout_level]}) sheds {prio}-class requests",
                    "brownout_shed",
                )
                return
        seq = _Sequence(next(self._seq_ids), request, context)
        seq.cold_seen = self.stats.cold_dispatches
        if seq.num_prompt < n:
            # a migration resume: the tail was streamed by a dead worker,
            # but its KV is prefilled again here (replayed work)
            self.stats.goodput.record_waste("migration_replay", n - seq.num_prompt)
        if dtrace.enabled():
            self._sp_begin(seq, "queue_wait", tokens=n, priority=seq.priority)
        self._enqueue(seq)
        self._ensure_loop()
        self._wake.set()
        try:
            while True:
                item = await seq.out.get()
                self._observe_stream(seq, item)
                yield item
                if item.finish_reason is not None:
                    return
        finally:
            # consumer went away (or the stream ended): let the loop reap it
            context.kill()
            self._wake.set()

    def _observe_stream(self, seq: _Sequence, item: LLMEngineOutput) -> None:
        """Always-on phase histograms at the stream edge (what a consumer of
        this worker sees): TTFT, prefill (admitted to first token),
        inter-token gaps, end to end (engine.py:555-571). A gap whose
        delivery is marked ``cold`` (``_device``) is no ``inter_token``
        sample; the reference observes each gap, its XLA compiles included.
        A cold first token's TTFT is kept, and also observed in the health
        plane's ``ttft_cold``, which its scorer subtracts; the health
        plane's ``pace`` is scored by delivery (``StreamPace``): a fetch's
        tokens share its gap (C15)."""
        ph = self.stats.phase_histograms
        now = time.monotonic()
        if item.token_ids:
            if seq.pace is None:
                seq.t_first = now
                seq.pace = StreamPace(now, item.fetch)
                ph.observe("ttft", (now - seq.t_arrival) * 1e3)
                if item.cold:  # the health plane's TTFT leaves it out
                    self.stats.health_histograms.observe(
                        "ttft_cold", (now - seq.t_arrival) * 1e3)
                if seq.t_admitted is not None:
                    ph.observe("prefill", (now - seq.t_admitted) * 1e3)
            else:
                if item.cold:
                    self.stats.cold_gaps += 1
                else:
                    ph.observe("inter_token", (now - seq.t_last) * 1e3)
                self._observe_pace(seq.pace.token(now, item.fetch, item.cold))
            seq.t_last = now
        if item.finish_reason is not None:
            if seq.pace is not None:
                self._observe_pace(seq.pace.flush())
            ph.observe("e2e", (now - seq.t_arrival) * 1e3)

    def _observe_pace(self, done) -> None:
        """One closed delivery of a stream (``StreamPace``) into ``pace``:
        a sample a token, each its share of the fetch's gap; a cold one is
        left out (C15)."""
        if done is None or done[2]:
            return
        ms, n, _ = done
        h = self.stats.health_histograms
        for _ in range(n):
            h.observe("pace", ms)

    # ---------------------------------------------------------- brownout

    def apply_brownout(self, level: int) -> None:
        """Apply one brownout-ladder rung (telemetry/brownout.py; wired by
        the worker host from ``slo-status`` events and local burn rates):
        >= 1 sheds bulk arrivals, >= 2 pauses drafting, >= 3 halves the
        prefill chunk and its per-step budget, >= 4 sheds standard arrivals
        too. Idempotent; a lower level restores everything."""
        self._brownout_level = max(0, int(level))
        self._spec_paused = self._brownout_level >= 2
        self.stats.brownout_level = self._brownout_level

    def _chunk_tokens(self) -> int:
        """Tokens per prefill chunk, halved (on the block grid) under the
        chunk-cap rung (engine.py:1041-1048)."""
        c = self.runner.prefill_chunk_tokens
        if c and dbrownout.chunk_capped(self._brownout_level):
            return qos.effective_chunk_budget(c, chunk_cap=True, block_size=self.config.block_size)
        return c

    def _chunk_budget(self) -> int:
        """The per-step prefill token budget (engine.py:1050-1062)."""
        return qos.effective_chunk_budget(
            self._chunk_budget_base,
            chunk_cap=dbrownout.chunk_capped(self._brownout_level),
            block_size=self.config.block_size,
        )

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            await asyncio.gather(self._watchdog_task, return_exceptions=True)
        for t in list(self._remote_tasks):
            t.cancel()
        await asyncio.gather(*self._remote_tasks, return_exceptions=True)
        # offloads in flight end on their own (their device jobs are queued)
        await asyncio.gather(*self._tier_tasks, return_exceptions=True)
        if self._loop_task is not None:
            await asyncio.gather(self._loop_task, return_exceptions=True)
        self._executor.shutdown(wait=True)
        # a tensor-parallel leader stops its followers here
        self.runner.shutdown()

    # ---------------------------------------------------------- schedule

    @staticmethod
    def _queue_key(seq: _Sequence) -> tuple:
        """Class rank, then the request deadline (unbounded last), then
        arrival (engine.py:1013-1022)."""
        dl = seq.ctx.deadline
        return (seq.rank, dl if dl is not None else float("inf"), seq.arrival_order)

    def _enqueue(self, seq: _Sequence) -> None:
        if not seq.arrival_order:
            seq.arrival_order = next(self._arrivals)
        # a preempted sequence keeps its arrival number: back at the head
        # of its class
        bisect.insort(self.waiting, seq, key=self._queue_key)

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._engine_loop())
        if (self.config.watchdog_min_s > 0 and not self._tripped
                and (self._watchdog_task is None or self._watchdog_task.done())):
            self._watchdog_task = asyncio.get_running_loop().create_task(self._watchdog_loop())

    def _key_row(self, seq: _Sequence) -> np.ndarray:
        stream = seq.seed if seq.seed is not None else self._seed_base + seq.seq_id
        # dropped early stop ids ride the high counter bits, so a redraw uses
        # a fresh key (generation counters stay far below 2^16)
        return make_key_data(stream, seq.num_generated + (seq.eos_drops << 16))

    def _free_seq(self, seq: _Sequence) -> None:
        if self._offload_queue is not None:
            # queued candidates name blocks about to be recycled; dropping
            # them lets their hashes enqueue again through another holder
            self._offload_queue.forget_seq(seq, cancelled=seq.ctx.is_stopped())
        if seq.slot is not None:
            self.slots[seq.slot] = None
            seq.slot = None
        if seq.block_ids:
            self.allocator.free(seq.block_ids)
            seq.block_ids = []
        if seq in self._admit_order:
            self._admit_order.remove(seq)
        if seq in self._prefilling:
            self._prefilling.remove(seq)
        seq.prefilling = False
        seq.prefill_pos = 0  # a preempted sequence re-prefills from scratch
        self._emit_removed(seq)

    def _finish(self, seq: _Sequence, reason: FinishReason) -> None:
        self._maybe_offload(seq, reason)
        self._free_seq(seq)
        if seq.spans:
            self._sp_finish(seq, "decode", tokens=seq.num_generated)
            self._sp_close_all(seq)
        seq.out.put_nowait(LLMEngineOutput.final(reason))

    def _finish_error(self, seq: _Sequence, phase: str, cause: str, code: str) -> None:
        """Fail one admitted sequence with a structured error: free its lane
        and blocks (publishing Removed) and send the typed final."""
        self._free_seq(seq)
        if seq.spans:
            self._sp_event(seq, "error", phase=phase, code=code)
            self._sp_close_all(seq)
        seq.out.put_nowait(LLMEngineOutput.final_error(seq.ctx.id, phase, cause, code))

    def _try_admit(self, seq: _Sequence) -> bool:
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return False
        need = seq.blocks_needed(self.config.block_size)
        if self.allocator.free_count < need + self.config.watermark_blocks:
            return False
        seq.block_ids = self.allocator.alloc(need)
        seq.slot = free_slots[0]
        self.slots[seq.slot] = seq
        self._admit_order.append(seq)
        return True

    def _preempt(self, victim: _Sequence) -> None:
        """Preempt the victim and re-queue it with its generated tokens
        after its backoff; past ``max_preemptions`` it fails instead. With a
        block manager its KV-complete blocks spill to the host tier first
        (``_spill_preempted``), so re-admission onboards them; without one,
        or for the rest, they are recomputed on re-admission."""
        victim.preemptions += 1
        self.stats.preemptions += 1
        by_class = self.stats.preemptions_by_class
        by_class[victim.priority] = by_class.get(victim.priority, 0) + 1
        # every token whose device KV this discards is recomputed on
        # re-admission (a tier spill may onboard some back: an upper bound)
        self.stats.goodput.record_waste(
            "preempt_replay", victim.prefill_pos if victim.prefilling else len(victim.token_ids))
        if victim.preemptions <= self.config.max_preemptions:
            self._spill_preempted(victim)
        self._free_seq(victim)
        victim.hash_seq = None
        victim.emitted_hashes = 0
        victim.offload_mark = 0
        if victim.preemptions > self.config.max_preemptions:
            self.stats.preempted_too_often += 1
            if victim.spans:
                self._sp_event(victim, "preempted_too_often")
                self._sp_event(victim, "error", phase="preemption", code="preempted_too_often")
                self._sp_close_all(victim)
            victim.out.put_nowait(LLMEngineOutput.final_error(
                victim.ctx.id, "preemption",
                f"preempted {victim.preemptions} times under sustained pressure "
                f"(DYN_MAX_PREEMPTIONS={self.config.max_preemptions}); giving up",
                "preempted_too_often",
            ))
            return
        logger.debug("preempting seq %d (%s, preemption #%d)", victim.seq_id, victim.priority,
                     victim.preemptions)
        if victim.spans:
            self._sp_event(victim, "preempted", count=victim.preemptions)
            self._sp_close_all(victim)
        if dtrace.enabled():
            # re-queued: its wait for re-admission is a fresh phase
            self._sp_begin(victim, "queue_wait", resumed=True)
        backoff_s = min(2.0, self.config.preempt_backoff_ms / 1e3 * (1 << (victim.preemptions - 1)))
        if dprov.enabled():
            dprov.record("engine", "readmit", victim.priority, reason="backoff", ctx=victim.ctx,
                         proc=self.trace_proc, backoff_ms=round(backoff_s * 1e3, 3),
                         preemptions=victim.preemptions)
        victim.requeue_after = time.monotonic() + backoff_s
        self._enqueue(victim)

    def _preempt_victim(self, exclude: _Sequence) -> bool:
        """Preempt a lane for ``exclude``'s growth, class-aware
        (engine.py:1263-1300): the lowest class first (bulk absorbs
        pressure before standard before interactive), the youngest within a
        class, and never one whose class outranks the grower's; a lane
        awaiting a remote prefill is skipped. False when no lane may be
        taken."""
        worst = max(qos.CLASS_RANK.values())
        for rank in range(worst, exclude.rank - 1, -1):
            for victim in reversed(self._admit_order):
                if (victim is exclude or victim.slot is None or victim.pending_remote
                        or victim.rank != rank):
                    continue
                if dprov.enabled():
                    dprov.record(
                        "engine", "preempt", victim.priority, reason="class_rank",
                        ctx=victim.ctx, proc=self.trace_proc,
                        alternatives=[
                            {"request": c.ctx.id, "class": c.priority, "rank": c.rank,
                             "generated": c.num_generated}
                            for c in self._admit_order if c is not exclude and c.slot is not None
                        ][:8],
                        grower=exclude.ctx.id, grower_class=exclude.priority,
                    )
                self._preempt(victim)
                return True
        return False

    async def _device(self, fn, label: str, *, lanes: int = 0, capacity: int = 0,
                      tokens: int = 0):
        """Run one device call (and its host fetch) on the worker thread,
        visible to the watchdog under ``label`` from the moment it holds the
        device. Its graph replays are counted there: calls of the loop, of
        remote-prefill landings and of offloads may be queued at once.

        Fault injection (engine.py:724-756): ``on_dispatch`` first, and an
        injected gray-worker factor F stretches the call to F times its
        duration by an asyncio sleep after it returns (the device thread
        and its card lock are free meanwhile); the label stays the running
        dispatch until the stretch ends and its EMA takes the stretched
        time, so the watchdog's budget tracks a throttled worker.

        A dispatch is cold when the runner's ``warm_events`` (graph
        captures, kernel library loads) moved since the previous one ended
        -- it, or a lazy horizon's capture queued before it, paid a one-off
        cost -- or, on a card, when it is its label's first
        (``stats.cold_dispatches``). Every sequence's next delivery
        after it is marked ``cold`` (``_append_token``): its gap, or its
        wait for a first token, held that cost (C15).

        Each dispatch goes into the goodput ledger on the loop when it ends
        (``_record_step``): ``lanes`` / ``capacity`` for decode-family
        dispatches, ``tokens`` for the prompt tokens it prefilled."""
        runner, stats = self.runner, self.stats
        slow = 1.0
        if faults.active():
            inj = faults.get_injector()
            if inj is not None:
                await inj.on_dispatch()
                slow = inj.dispatch_slow_factor()
        started: list[tuple[str, float]] = []
        # (the label's first dispatch, warm events moved) per dispatch
        marks: list[tuple[bool, bool]] = []

        def counted():
            replays = runner.graph_replays
            info = (label, time.monotonic())
            started.append(info)
            self._dispatch_info = info
            try:
                with dprofile.annotate(label):
                    return fn()
            finally:
                stats.graph_replays += runner.graph_replays - replays
                self._fetches += 1
                warm = getattr(runner, "warm_events", 0)
                first = label not in self.dispatch_first_s
                moved = warm != self._warm_seen
                if moved or (self._first_use_cold and first):
                    self._warm_seen = warm
                    stats.cold_dispatches += 1
                marks.append((first, moved))
                if slow <= 1.0:
                    self._dispatch_done(info)

        loop = asyncio.get_running_loop()
        try:
            result = await loop.run_in_executor(self._executor, counted)
            if slow > 1.0:
                await asyncio.sleep((slow - 1.0) * (time.monotonic() - started[0][1]))
            return result
        finally:
            if started:
                if slow > 1.0:
                    self._dispatch_done(started[0])
                if marks:
                    self._record_step(label, started[0][1], *marks[0], lanes, capacity, tokens)

    def _record_step(self, label: str, t0: float, first: bool, moved: bool, lanes: int,
                     capacity: int, tokens: int) -> None:
        """One dispatch into the goodput ledger (engine.py:757-798): its
        first-dispatch seconds, or a recompile when the runner paid a
        one-off cost (``warm_events`` moved) after the label's first; then
        the step, and with tracing on the ``step_ms`` / ``occupancy``
        counter tracks."""
        gp = self.stats.goodput
        if not gp.enabled:
            return
        elapsed = time.monotonic() - t0
        if first:  # the first dispatch's seconds, as the watchdog's cold budget saw them
            gp.record_compile(label, self.dispatch_first_s.get(label, elapsed))
        elif moved:
            cause = ("prebake_miss" if normalize_label(label) in self._prebaked_labels
                     else "shape_miss")
            gp.record_recompile(label, cause, shape=f"lanes={lanes},tokens={tokens}")
        gp.record_step(label, elapsed, lanes=lanes, capacity=capacity, prefill_tokens=tokens,
                       t_start=t0)
        if dtrace.enabled():
            dtrace.counter("step_ms", elapsed * 1e3)
            if capacity > 0:
                dtrace.counter("occupancy", lanes / capacity)

    def _dispatch_done(self, info: tuple[str, float]) -> None:
        """A dispatch ended: it stops being the running one and its
        duration goes into its label's EMA."""
        label, t0 = info
        elapsed = time.monotonic() - t0
        if self._dispatch_info is info:
            self._dispatch_info = None
        ema = self._dispatch_ema
        prev = ema.get(label)
        if prev is None:
            self.dispatch_first_s[label] = elapsed
        ema[label] = elapsed if prev is None else 0.8 * prev + 0.2 * elapsed

    # ------------------------------------------------------------ watchdog

    async def _watchdog_loop(self) -> None:
        """Poll the running dispatch (engine.py:800-819): a label's first
        dispatch gets ``watchdog_cold_s`` (a graph capture may ride it; the
        factory builds the kernels before the first request), later ones
        max(``watchdog_min_s``, ``watchdog_mult`` x the label's EMA)."""
        cfg = self.config
        poll = max(0.02, min(1.0, cfg.watchdog_min_s / 4))
        while not self._closed:
            await asyncio.sleep(poll)
            info = self._dispatch_info
            if info is None:
                continue
            label, t0 = info
            elapsed = time.monotonic() - t0
            ema = self._dispatch_ema.get(label)
            budget = (cfg.watchdog_cold_s if ema is None
                      else max(cfg.watchdog_min_s, cfg.watchdog_mult * ema))
            if elapsed > budget:
                self._trip_watchdog(label, elapsed, budget)
                return

    def _trip_watchdog(self, label: str, elapsed: float, budget: float) -> None:
        """A dispatch wedged past its budget: every lane fails with
        ``watchdog_stuck``, new work is refused (``worker_unavailable``)
        and ``on_watchdog_trip`` fires, instead of every stream hanging.
        Admitted sequences keep their blocks: the wedged dispatch may still
        write them, and this engine serves no more."""
        self.stats.watchdog_trips += 1
        self._tripped = True
        self._closed = True  # the loop ends when (if) the dispatch returns
        cause = f"watchdog: {label} dispatch stuck {elapsed:.1f}s (budget {budget:.1f}s)"
        logger.error("%s -- failing all lanes, marking the worker unhealthy", cause)
        self._fail_lanes(cause, "watchdog_stuck", label, trip_label=label)
        if self.on_watchdog_trip is not None:
            try:
                self.on_watchdog_trip()
            except Exception:  # noqa: BLE001 - the trip itself must complete
                logger.exception("on_watchdog_trip raised")

    def _fail_lanes(self, cause: str, code: str, phase: str,
                    trip_label: Optional[str] = None) -> None:
        """Every waiting and admitted sequence gets a structured final error.
        Admitted ones keep their blocks: a dispatch in flight may still
        write them, and the caller has closed the engine. Their spans close
        with a ``watchdog_trip`` event (``trip_label``), else an admitted
        lane's with an ``error`` event, as the reference's fence does."""
        for seq in list(self.waiting):
            self.waiting.remove(seq)
            if trip_label is not None:
                self._sp_event(seq, "watchdog_trip", label=trip_label)
            self._sp_close_all(seq)
            seq.out.put_nowait(LLMEngineOutput.final_error(seq.ctx.id, "queue", cause, code))
        for seq in list(self._admit_order):
            seq.ctx.kill()
            if seq.spans:
                if trip_label is not None:
                    self._sp_event(seq, "watchdog_trip", label=trip_label)
                else:
                    self._sp_event(seq, "error", phase=phase, code=code)
                self._sp_close_all(seq)
            seq.out.put_nowait(LLMEngineOutput.final_error(seq.ctx.id, phase, cause, code))

    def _abort_all(self, cause: str, code: str = "injected_fault") -> None:
        """In-process crash injection (``abort_after_tokens``,
        engine.py:3212-3233): every waiting and running sequence fails with
        a structured error and its lane and blocks free, as a loop crash
        would, but the engine keeps serving new requests. A sequence
        awaiting its remote prefill keeps its blocks until its task ends
        (its killed context finishes it there)."""
        for seq in list(self.waiting):
            self.waiting.remove(seq)
            self._sp_close_all(seq)
            seq.out.put_nowait(LLMEngineOutput.final_error(seq.ctx.id, "queue", cause, code))
        for seq in list(self._admit_order):
            if seq.pending_remote:
                seq.ctx.kill()
                seq.out.put_nowait(LLMEngineOutput.final_error(
                    seq.ctx.id, "remote_prefill", cause, code))
            else:
                self._finish_error(seq, "decode", cause, code)

    def fence(self, reason: str) -> None:
        """Worker self-fence (engine.py:3237-3251; the runtime's
        ``on_fence``): the primary lease is gone, so the cluster has declared
        this worker dead and is migrating its streams. Stop admitting, fail
        every lane with a structured ``worker_fenced`` error (consumers
        replay onto a live worker), refuse new requests with it, and decode
        no further token: the loop ends after the dispatch in flight."""
        if self._fenced:
            return
        self._fenced = True
        self._closed = True
        logger.error("engine fenced: %s -- failing all lanes", reason)
        dtrace.event("worker_fenced", reason=reason)
        self._fail_lanes(f"worker fenced: {reason}", "worker_fenced", "decode")
        self._wake.set()

    # ------------------------------------------------- tiers and KV events

    def checkpoint_tiers(self, directory: Optional[str] = None) -> Optional[dict]:
        """Warm restart (engine.py:881-893): checkpoint the tiers and the
        prefix index to ``directory`` (default ``DYN_WARM_RESTART_DIR``);
        None without tiers or a directory, or when the checkpoint failed
        (logged: it must not block an exit)."""
        d = directory or os.environ.get("DYN_WARM_RESTART_DIR")
        if not d or self.block_manager is None:
            return None
        try:
            return self.block_manager.checkpoint(d)
        except Exception:  # noqa: BLE001
            logger.exception("warm-restart checkpoint failed")
            return None

    def restore_tiers(self, directory: Optional[str] = None) -> Optional[dict]:
        """Boot side of a warm restart (engine.py:895-907): verified
        checkpoint pages back into the tiers (corrupt ones refused); call it
        before serving. A failed restore is a cold boot (logged)."""
        d = directory or os.environ.get("DYN_WARM_RESTART_DIR")
        if not d or self.block_manager is None:
            return None
        try:
            return self.block_manager.restore(d)
        except Exception:  # noqa: BLE001
            logger.exception("warm-restart restore failed")
            return None

    async def clear_kv_blocks(self) -> dict:
        """Drop the reusable KV state (engine.py:909-936): the host and disk
        tiers and the hash bookkeeping of the KV events. Running sequences
        keep their device blocks; their chains are published (and queued
        for offload) again from their next block on."""
        tier_blocks = 0
        if self.block_manager is not None:
            s = self.block_manager.stats
            tier_blocks = s.host_blocks_used + s.disk_blocks_used
            self.block_manager.clear()
        self._hash_refs.clear()
        for seq in self._admit_order:
            seq.emitted_hashes = 0
            seq.offload_mark = 0
        if self.on_cache_cleared is not None:
            self.on_cache_cleared()
        return {
            "status": "cleared",
            "offload_blocks_dropped": tier_blocks,
            "active_sequences_kept": sum(1 for s in self.slots if s is not None),
        }

    def _set_chain(self, seq: _Sequence) -> None:
        """The sequence's prefill is done: its hash chain (the one built for
        the prefix lookup when there was one) and the Stored events of its
        complete blocks."""
        seq.hash_seq = seq.pending_chain or TokenBlockSequence(
            list(seq.token_ids), self.config.block_size)
        seq.pending_chain = None
        self._emit_stored(seq)

    def _emit_stored(self, seq: _Sequence) -> None:
        """Stored events for the newly complete blocks, and their offload
        once KV-complete (engine.py:940-995)."""
        if seq.hash_seq is None:
            return
        blocks = seq.hash_seq.blocks
        new = blocks[seq.emitted_hashes:]
        for b in new:
            self._hash_refs[b.block_hash] = self._hash_refs.get(b.block_hash, 0) + 1
        bm = self.block_manager
        if self._offload_queue is not None:
            # mid-generation offload: a block becomes a host-tier candidate
            # as soon as its KV is complete, which lags its hash by a token
            # (kv_written), hence the separate offload_mark cursor
            ready = min(len(blocks), seq.kv_written // self.config.block_size)
            if ready > seq.offload_mark:
                self._offload_queue.enqueue(seq, [
                    (b.block_hash, b.position) for b in blocks[seq.offload_mark:ready]
                    if b.block_hash not in bm and not bm.is_quarantined(b.block_hash)
                ])
                seq.offload_mark = ready
        seq.emitted_hashes = len(blocks)
        if not new or self.on_blocks_stored is None:
            return
        # a quarantined hash is never offered for prefix reuse again
        self.on_blocks_stored([
            {"block_hash": b.block_hash, "parent_hash": b.parent_hash, "tokens": b.tokens,
             "block_id": seq.block_ids[b.position] if b.position < len(seq.block_ids) else -1}
            for b in new if bm is None or not bm.is_quarantined(b.block_hash)
        ])

    def _emit_removed(self, seq: _Sequence) -> None:
        """Removed events for the hashes whose last holder this sequence
        was."""
        if seq.hash_seq is None:
            return
        last_refs: list[int] = []
        for b in seq.hash_seq.blocks[:seq.emitted_hashes]:
            n = self._hash_refs.get(b.block_hash, 0) - 1
            if n <= 0:
                self._hash_refs.pop(b.block_hash, None)
                last_refs.append(b.block_hash)
            else:
                self._hash_refs[b.block_hash] = n
        if last_refs and self.on_blocks_removed is not None:
            self.on_blocks_removed(last_refs)

    def _tier_on_device(self) -> bool:
        """Whether blocks move between the cache and the tiers as the
        cache's own pages (a raw tier of the cache's dtype, or int8 tiers
        over an int8-resident cache: verbatim); else the tier codec runs on
        the host, over ``extract_blocks`` / ``inject_blocks``."""
        runner, bm = self.runner, self.block_manager
        if runner.kv_quantized:
            return bm.wire_codec == "int8"
        return bm.wire_codec == "raw" and bm.layout.dtype == dtype_name(runner.kv_logical_dtype)

    def _offload_pairs(self, seq: _Sequence) -> list[tuple[int, int]]:
        """(hash, chain index) of the sequence's offloadable blocks:
        KV-complete (``kv_written``), on the device and not in a tier yet."""
        kv_complete = seq.kv_written // self.config.block_size
        n = min(len(seq.block_ids), kv_complete)
        return [(b.block_hash, i) for i, b in enumerate(seq.hash_seq.blocks[:n])
                if b.block_hash not in self.block_manager]

    def _maybe_offload(self, seq: _Sequence, reason: FinishReason) -> None:
        """At a normal end, the sequence's full blocks go to the host tier
        before its device blocks are recycled (engine.py:1108-1127): the
        offload task owns them until the copy is done."""
        if (self.block_manager is None or self._closed or seq.hash_seq is None
                or not seq.block_ids or reason in (FinishReason.ERROR, FinishReason.CANCELLED)):
            return
        pairs = [(h, seq.block_ids[i]) for h, i in self._offload_pairs(seq)]
        if not pairs:
            return
        owned, seq.block_ids = seq.block_ids, []
        self._spawn_tier_task(self._offload_task(owned, pairs))

    def _spill_preempted(self, victim: _Sequence) -> None:
        """A preempted sequence's KV-complete blocks not in a tier yet go to
        an offload task; the rest free at once (engine.py:1364-1397). At
        least one block always frees now (the newest spill candidate is
        given up: dropping the oldest would leave the spill unreachable,
        lookups count only leading hits), so the preemptor's allocation
        succeeds without waiting for the copy."""
        if (self.block_manager is None or self._closed or victim.hash_seq is None
                or not victim.block_ids):
            return
        pairs = self._offload_pairs(victim)
        if len(pairs) >= len(victim.block_ids):
            pairs = pairs[:-1]
        if not pairs:
            return
        spill = {i for _, i in pairs}
        owned = [victim.block_ids[i] for _, i in pairs]
        hash_block = [(h, victim.block_ids[i]) for h, i in pairs]
        victim.block_ids = [b for i, b in enumerate(victim.block_ids) if i not in spill]
        self.stats.preempt_spills += 1
        self._spawn_tier_task(self._offload_task(owned, hash_block))

    def _spawn_tier_task(self, coro) -> asyncio.Task:
        t = asyncio.get_running_loop().create_task(coro)
        self._tier_tasks.add(t)
        t.add_done_callback(self._tier_tasks.discard)
        return t

    async def drain_offloads(self) -> None:
        """Wait until no offload task is in flight (the mid-generation
        queue is drained by the loop between dispatches)."""
        while self._tier_tasks:
            await asyncio.gather(*list(self._tier_tasks), return_exceptions=True)

    async def _offload_task(self, owned: list[int], pairs: list[tuple[int, int]]) -> None:
        try:
            await self._copy_blocks_to_tier([b for _, b in pairs], [h for h, _ in pairs])
        finally:
            # the copy is done (or failed): the device blocks recycle now
            self.allocator.free(owned)
            self._wake.set()

    async def _copy_blocks_to_tier(self, ids: list[int], hashes: list[int]) -> None:
        """Device blocks ``ids`` into the host tier under ``hashes``, on the
        device thread: the pages straight into arena slots, or through the
        host codec. Best-effort as in the reference (a failure loses reuse,
        never output), but every failure is counted in
        ``kv_offload_errors`` and logged."""
        bm, runner = self.block_manager, self.runner
        if faults.active():
            inj = faults.get_injector()
            if inj is not None:
                await inj.on_transfer()
        try:
            if self._tier_on_device():
                stored = await self._device(
                    lambda: bm.store_blocks_device(hashes, *runner.extract_pages(ids)),
                    "kv_offload")
            else:
                k, v = await self._device(lambda: runner.extract_blocks(ids), "kv_offload")
                stored = await asyncio.to_thread(bm.store_blocks, hashes, k, v)
        except Exception:  # noqa: BLE001 - best-effort, counted
            self.stats.kv_offload_errors += 1
            logger.exception("offloading %d block(s) failed", len(ids))
            return
        self.stats.kv_offloaded_blocks += stored
        self._offload_queue.stats.offloaded += stored

    async def _drain_offload(self) -> None:
        """Copy up to ``offload_per_step`` queued mid-generation blocks to
        the host tier (engine.py:1226-1241). On the loop between phases, so
        a candidate cannot go stale before its copy is queued."""
        q = self._offload_queue
        if q is None or not len(q) or self.config.offload_per_step <= 0:
            return
        cands = q.pop_valid(self.config.offload_per_step, self.block_manager)
        if cands:
            await self._copy_blocks_to_tier([b for _, _, b in cands], [h for _, h, _ in cands])

    async def _onboard_prefix(self, seq: _Sequence) -> int:
        """Inject the sequence's cached prefix blocks from the tiers into
        its leading device blocks, in place (engine.py:2195-2237); returns
        how many. A failure (a checksum, a race with eviction) onboards
        nothing: the prefix is recomputed, and the failure is counted in
        ``kv_onboard_errors`` and logged."""
        cached = seq.cached_prefix_blocks
        bm, runner = self.block_manager, self.runner
        if bm is None or not cached:
            return 0
        hashes, ids = seq.prefix_hashes[:cached], seq.block_ids[:cached]
        try:
            if self._tier_on_device():
                await self._device(
                    lambda: runner.inject_pages(ids, *bm.load_blocks_device(hashes, runner.device)),
                    "kv_onboard")
            else:
                k, v = await asyncio.to_thread(bm.load_blocks, hashes)
                await self._device(lambda: runner.inject_blocks(ids, k, v), "kv_onboard")
        except Exception:  # noqa: BLE001 - the prefix is recomputed, counted
            self.stats.kv_onboard_errors += 1
            logger.exception("onboarding %d prefix block(s) of seq %d failed", cached,
                             seq.seq_id)
            return 0
        self.stats.kv_onboarded_blocks += cached
        return cached

    # ---------------------------------------------------------- main loop

    async def _engine_loop(self) -> None:
        try:
            while not self._closed:
                self._reap_cancelled()
                self._process_landed()
                await self._drain_offload()
                # latch the degraded chunk width and budget once per
                # iteration: apply_brownout may land while a dispatch below
                # is awaited, and must wait for the next step boundary
                self._step_chunk_tokens = self._chunk_tokens()
                self._step_chunk_budget = self._chunk_budget()
                admitted = await self._admit_phase()
                if self._prefilling:
                    active = self._decode_lanes()
                    if active and self._can_mix(active):
                        # every decode lane and up to the budget of prompt
                        # tokens in one step
                        await self._mixed_step_phase(active)
                        self._update_perf_gauges(active)
                        if not admitted:
                            await asyncio.sleep(0)
                        continue
                # else at most one chunk per iteration, so the decode step
                # below never waits longer than one chunk
                chunked = False
                if self._prefilling:
                    await self._prefill_chunk_step()
                    chunked = True
                active = self._decode_lanes()
                if not active:
                    if chunked:
                        self._update_perf_gauges()
                        continue
                    if not self.waiting and not self._landed and not self._closed:
                        # a landing remote prefill sets the wake too; a
                        # deadline of one still in flight ends the wait (a
                        # close or fence during the last dispatch set it
                        # already: the loop ends instead)
                        self._wake.clear()
                        if not any(s is not None for s in self.slots):
                            # nothing in flight: the gap to the next
                            # dispatch is idleness, not a phase bubble
                            self.stats.goodput.mark_idle()
                        await self._idle_wait()
                    else:
                        await asyncio.sleep(0.001)  # backlog waits for blocks
                    continue
                await self._decode_phase(active)
                self._update_perf_gauges(active)
                if not admitted:
                    await asyncio.sleep(0)  # fairness for the stream consumers
        except Exception as e:
            logger.exception("engine loop crashed")
            for seq in [s for s in self.slots if s is not None] + list(self.waiting):
                # a sequence awaiting its remote prefill keeps its blocks
                # until the task ends (a late inject would land in blocks
                # handed to another sequence); its killed context reaps it
                if seq.pending_remote:
                    seq.ctx.kill()
                else:
                    self._free_seq(seq)
                if seq.spans:
                    self._sp_event(seq, "error", phase="decode", code="engine_loop_crash")
                    self._sp_close_all(seq)
                seq.out.put_nowait(LLMEngineOutput.final_error(
                    seq.ctx.id, "decode", f"{type(e).__name__}: {e}", "engine_loop_crash"
                ))
            self.waiting.clear()
            raise

    def _modelled_step(self, lanes: list) -> Any:
        """``perf_model.meshed_decode_hbm_bytes_per_token`` for a batch of
        ``lanes`` at their mean context, with this runner's weights, cache
        form, fused heads and tp group."""
        mcfg = self.runner.config
        params = getattr(self.runner, "params", None)
        quant_w = False
        if isinstance(params, dict):
            layers = params.get("layers") or [{}]
            quant_w = isinstance(layers[0].get("wq"), dict)
        group = getattr(self.runner, "group", None)
        return perf_model.meshed_decode_hbm_bytes_per_token(
            mcfg, batch=len(lanes), context=sum(len(s.token_ids) for s in lanes) / len(lanes),
            block_size=self.config.block_size, tp=group.world_size if group is not None else 1,
            weights_int8=quant_w, kv_int8=getattr(self.runner, "kv_quantized", False),
            fused=getattr(mcfg, "fused_decode", False),
            overlap=getattr(mcfg, "collective_overlap", False),
        )

    def _update_perf_gauges(self, lanes: Optional[list] = None) -> None:
        """The decode-bandwidth gauges (engine.py:3265-3321): modelled HBM
        bytes per emitted token of the live batch and context (per card
        under a group) and the tp axis's collective bytes per step
        (``perf_model.meshed_decode_hbm_bytes_per_token``), and an MFU
        estimate from the token rate over the last ~10 s; the goodput
        ledger takes the latest point, and with tracing on the
        ``mfu_achieved`` / ``tokens_wasted`` counter tracks. ``lanes``, the
        dispatch's decode lanes: the tokens it emitted add their modelled
        bytes at its batch to ``modelled_decode_bytes``."""
        mcfg = getattr(self.runner, "config", None)
        if mcfg is None or not hasattr(mcfg, "num_layers"):
            return
        st = self.stats
        active = [s for s in self.slots if s is not None]
        now = time.monotonic()
        win = self._mfu_window
        win.append((now, st.generated_tokens))
        while len(win) > 2 and now - win[0][0] > 10.0:
            win.popleft()
        if active:
            mb = self._modelled_step(active)
            st.decode_hbm_bytes_per_token = mb.per_chip.total
            st.tp_collective_bytes_per_step = mb.tp_collective_bytes_per_step
        if lanes:
            emitted = st.generated_tokens - self._gauge_tokens
            st.modelled_decode_bytes += self._modelled_step(lanes).per_chip.total * emitted
        self._gauge_tokens = st.generated_tokens
        dt = now - win[0][0]
        if dt > 0.5:
            rate = (st.generated_tokens - win[0][1]) / dt
            st.mfu_decode_est = perf_model.mfu_decode_est(mcfg, rate, perf_model.peak_flops_from_env())
        st.goodput.set_perf_gauges(st.mfu_decode_est, st.decode_hbm_bytes_per_token)
        if dtrace.enabled() and st.goodput.enabled:
            dtrace.counter("mfu_achieved", st.mfu_decode_est)
            dtrace.counter("tokens_wasted", float(st.goodput.wasted_total()))

    def mfu_window_rate(self) -> float:
        """The token rate the MFU gauge last used: generated tokens per
        second over the window its last refresh saw (0 before 0.5 s)."""
        win = self._mfu_window
        if len(win) < 2 or win[-1][0] - win[0][0] <= 0.5:
            return 0.0
        return (win[-1][1] - win[0][1]) / (win[-1][0] - win[0][0])

    async def _idle_wait(self) -> None:
        """Wait for new work, or until the earliest deadline of a sequence
        awaiting its remote prefill, which the next iteration sheds."""
        deadlines = [s.ctx.deadline for s in self.slots
                     if s is not None and s.pending_remote and s.ctx.deadline is not None
                     and not s.deadline_fired]
        if not deadlines:
            await self._wake.wait()
            return
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(self._wake.wait(), max(0.0, min(deadlines) - dclock.wall()) + 1e-3)

    def _decode_lanes(self) -> list[_Sequence]:
        return [s for s in self.slots
                if s is not None and not s.prefilling and not s.pending_remote]

    def _reap_cancelled(self) -> None:
        """Cancelled and expired sequences leave, once per loop iteration
        (engine.py:1486-1547)."""
        for seq in list(self.waiting):
            if seq.ctx.is_killed() or seq.ctx.is_stopped():
                self.waiting.remove(seq)
                self._sp_close_all(seq)
                seq.out.put_nowait(LLMEngineOutput.final(FinishReason.CANCELLED))
            elif seq.ctx.expired() or seq.ctx.ttft_expired():
                # queued past its deadline, or past the point where its
                # first token could still arrive in budget: shed before it
                # costs a prefill
                self.waiting.remove(seq)
                self.stats.deadline_exceeded += 1
                seq.ctx.kill()
                self._sp_event(seq, "deadline_exceeded", phase="queue")
                self._sp_close_all(seq)
                seq.out.put_nowait(LLMEngineOutput.final_error(
                    seq.ctx.id, "queue", "deadline exceeded while queued", "deadline_exceeded"))
        for seq in list(self._admit_order):
            if seq.pending_remote:
                # it keeps its blocks until its task lands (a late inject
                # would write into blocks handed to another sequence); the
                # killed context cancels the remote prefill and the landing
                # finishes it
                if seq.ctx.expired() and not seq.deadline_fired:
                    seq.deadline_fired = True
                    self.stats.deadline_exceeded += 1
                    seq.ctx.kill()
                    self._sp_event(seq, "deadline_exceeded", phase="remote_prefill")
                    seq.out.put_nowait(LLMEngineOutput.final_error(
                        seq.ctx.id, "remote_prefill", "deadline exceeded awaiting remote prefill",
                        "deadline_exceeded"))
                continue
            if seq.ctx.expired() or (seq.num_generated == 0 and seq.ctx.ttft_expired()):
                self.stats.deadline_exceeded += 1
                seq.ctx.kill()
                self._sp_event(seq, "deadline_exceeded", phase="decode")
                # the partial output is discarded: the consumer gets an error
                self.stats.goodput.record_waste("deadline_partial", seq.num_generated)
                self._finish_error(seq, "decode", "deadline exceeded mid-generation",
                                   "deadline_exceeded")
            elif seq.ctx.is_killed():
                # the consumer went away (a plain cancel or a hedge loser:
                # the frontend's hedger attributes hedge_loser on its side)
                self.stats.goodput.record_waste("cancelled_partial", seq.num_generated)
                self._finish(seq, FinishReason.CANCELLED)

    async def _admit_phase(self) -> bool:
        """Admit from the head of the queue while a lane and blocks are free
        (``JaxEngine._admit_phase``, engine.py:1549-1760). With a block
        manager the prompt's hash chain is looked up in the tiers first
        (:1586-1632); a prompt the disagg router ships (given the hit's
        length) goes to a remote-prefill task (:1633-1655), the others to
        the chunk / pack routing, where a hit that skips at least one full
        block is onboarded and chunked from after it, even a short prompt:
        the chunked prefill is the one that starts at an offset, and the
        final chunk keeps at least one token (:1662-1690). Between the
        lookup and the routing, the peer tier (``_peer_fetch``) may pull the
        rest of the chain into the tiers. A multimodal prompt (``extra["mm"]``)
        skips all of it and is prefilled on its own (``_run_mm_prefill``)."""
        admitted = False
        C = self._step_chunk_tokens
        bs = self.config.block_size
        bm = self.block_manager
        to_pack: list[_Sequence] = []
        idx = 0
        while idx < len(self.waiting):
            seq = self.waiting[idx]
            if seq.requeue_after and time.monotonic() < seq.requeue_after:
                # a preempted sequence's backoff: later arrivals go first
                idx += 1
                continue
            if not self._try_admit(seq):
                break
            self.waiting.pop(idx)
            admitted = True
            if seq.t_admitted is None:  # a first admission (not a resume)
                seq.t_admitted = time.monotonic()
                self.stats.phase_histograms.observe(
                    "queue_wait", (seq.t_admitted - seq.t_arrival) * 1e3)
            if seq.spans:
                self._sp_finish(seq, "queue_wait")
            mm = seq.request.extra.get("mm")
            if mm is not None:
                # token-hash prefix reuse would collide across different
                # images behind identical placeholder tokens
                self.admissions.append({"id": seq.ctx.id, "prompt_tokens": len(seq.token_ids),
                                        "cached_blocks": 0})
                if dtrace.enabled():
                    self._sp_begin(seq, "prefill", tokens=len(seq.token_ids), path="mm")
                await self._run_mm_prefill(seq, mm)
                continue
            hit_len = 0
            if bm is not None:
                seq.pending_chain = TokenBlockSequence(list(seq.token_ids), bs)
                seq.prefix_hashes = [b.block_hash for b in seq.pending_chain.blocks]
                seq.cached_prefix_blocks = bm.lookup_prefix(seq.prefix_hashes)
                await self._peer_fetch(seq)
                hit_len = seq.cached_prefix_blocks * bs
            self.admissions.append({"id": seq.ctx.id, "prompt_tokens": len(seq.token_ids),
                                    "cached_blocks": seq.cached_prefix_blocks})
            if await self._use_remote(seq, hit_len):
                # the sequence holds its lane and blocks and joins the
                # decode batch when its KV lands
                seq.pending_remote = True
                self.stats.remote_prefills += 1
                if dtrace.enabled():
                    self._sp_begin(seq, "remote_prefill", tokens=len(seq.token_ids),
                                   cached_blocks=seq.cached_prefix_blocks)
                task = asyncio.get_running_loop().create_task(self._remote_prefill_task(seq))
                self._remote_tasks.add(task)
                task.add_done_callback(self._remote_tasks.discard)
                continue
            if dtrace.enabled():
                self._sp_begin(seq, "prefill", tokens=len(seq.token_ids),
                               cached_blocks=seq.cached_prefix_blocks)
            # after a preemption the replay is prompt + generated tokens
            n = len(seq.token_ids)
            skippable = min(seq.cached_prefix_blocks, (n - 1) // bs) if bm is not None else 0
            if C and (n > C or skippable > 0):
                seq.prefilling = True
                seq.prefill_pos = 0
                if skippable:
                    onboarded = await self._onboard_prefix(seq)
                    seq.prefill_pos = min(onboarded, (n - 1) // bs) * bs
                self._prefilling.append(seq)
            elif C:
                to_pack.append(seq)
            else:
                await self._run_prefill(seq)
        # greedily fill each packed prefill up to C tokens and max_batch
        # segments, one call per group
        while to_pack:
            group, total = [], 0
            while (
                to_pack
                and total + len(to_pack[0].token_ids) <= C
                and len(group) < self.config.max_batch
            ):
                s = to_pack.pop(0)
                if s.slot is None:  # preempted by an earlier group's growth
                    continue
                group.append(s)
                total += len(s.token_ids)
            if group:
                await self._run_packed_prefill(group)
        return admitted

    async def _peer_fetch(self, seq: _Sequence) -> None:
        """The router's plan and the peer tier at admission
        (engine.py:1596-1631): the plan's fleet heat goes to the tier's
        eviction scoring; while the tiers miss part of the chain, the peer
        client pulls it (directed by the plan when there is one) and the
        lookup runs again."""
        bm = self.block_manager
        plan = decisions_of(seq.ctx).pull_plan
        if plan and plan.get("freq"):
            bm.note_fleet_heat([int(h) for h in plan.get("hashes", [])], plan["freq"])
        client = self.peer_block_client
        if client is None or seq.cached_prefix_blocks >= len(seq.prefix_hashes):
            return
        with dtrace.span("peer_fetch", ctx=seq.ctx, proc=self.trace_proc,
                         blocks_missing=len(seq.prefix_hashes) - seq.cached_prefix_blocks,
                         planned=bool(plan)):
            fetched = await client.fetch_remote_prefix(seq.prefix_hashes, plan=plan)
        self.stats.kv_pull_outcomes = dict(client.pull_outcomes)
        if fetched:
            seq.cached_prefix_blocks = bm.lookup_prefix(seq.prefix_hashes)

    async def _run_prefill(self, seq: _Sequence) -> None:
        """One prompt prefilled on its own (chunking off)."""
        replay = list(seq.token_ids)
        key_row = self._key_row(seq)
        runner = self.runner
        eos_suppress = seq.needs_eos_suppress
        sample = await self._device(
            lambda: runner.fetch_sample(runner.prefill(
                replay, seq.block_ids, seq.temperature, seq.top_p,
                seq.top_k, rep_pen=seq.rep_pen, key_data=key_row,
                eos_ids=seq.eos_row, eos_suppress=eos_suppress,
            )), "prefill", tokens=len(replay)
        )
        self.stats.prefills += 1
        if seq.slot is None:  # cancelled during the device call
            return
        self._set_chain(seq)
        tok, lp, tids, tlps = sample
        self._append_token(seq, int(tok[0]), float(lp[0]), tids[0], tlps[0])

    async def _run_mm_prefill(self, seq: _Sequence, mm: dict) -> None:
        """One multimodal prompt (engine.py:1739-1775): the vision
        embeddings spliced over the placeholder span by the runner's
        ``prefill_mm``. No hash chain is set, so no Stored event leaves."""
        replay = list(seq.token_ids)
        embeds, start = mm["embeds"], int(mm["start"])
        key_row = self._key_row(seq)
        runner = self.runner
        eos_suppress = seq.needs_eos_suppress
        sample = await self._device(
            lambda: runner.fetch_sample(runner.prefill_mm(
                replay, seq.block_ids, embeds, start, seq.temperature, seq.top_p,
                seq.top_k, rep_pen=seq.rep_pen, key_data=key_row,
                eos_ids=seq.eos_row, eos_suppress=eos_suppress,
            )), "prefill_mm", tokens=len(replay)
        )
        self.stats.prefills += 1
        self.stats.mm_prefills += 1
        if seq.slot is None:  # cancelled during the device call
            return
        tok, lp, tids, tlps = sample
        self._append_token(seq, int(tok[0]), float(lp[0]), tids[0], tlps[0])

    async def embed(self, token_ids: list[int]) -> np.ndarray:
        """The pooled embedding [hidden] (f32) of ``token_ids`` for
        ``/v1/embeddings`` (engine.py:2532): a cacheless forward on the
        device thread, in turn with the loop's dispatches."""
        runner = self.runner
        ids = list(token_ids)
        vec = await self._device(lambda: runner.embed(ids), "embed")
        self.stats.embeds += 1
        return vec

    async def _run_packed_prefill(self, group: list[_Sequence]) -> None:
        """Short prompts packed into one prefill (engine.py:1771)."""
        specs = [
            (
                list(s.token_ids), s.block_ids, s.temperature, s.top_p, s.top_k,
                s.rep_pen, self._key_row(s), s.eos_row, s.needs_eos_suppress,
            )
            for s in group
        ]
        runner = self.runner
        packed = runner.pack_prefill(specs)
        toks, lps, tids, tlps = await self._device(
            lambda: runner.fetch_sample(runner.prefill_packed_arrays(**packed)), "prefill_packed",
            tokens=sum(len(s.token_ids) for s in group))
        self.stats.packed_prefills += 1
        for i, seq in enumerate(group):
            if seq.slot is None:  # preempted by an earlier segment's growth
                continue
            self._set_chain(seq)
            self._append_token(seq, int(toks[i]), float(lps[i]), tids[i], tlps[i])

    async def _prefill_chunk_step(self) -> None:
        """One chunk of the oldest prompt being chunked, on its own
        (engine.py:1804). Only the final chunk's sample is read back; the
        earlier chunks are queued on the card without a wait."""
        seq = self._prefilling[0]
        C = self._step_chunk_tokens
        start = seq.prefill_pos
        total = len(seq.token_ids)
        chunk = seq.token_ids[start:start + C]
        final = start + C >= total
        key_row = self._key_row(seq)
        runner = self.runner
        eos_suppress = seq.needs_eos_suppress

        def run_chunk():
            out = runner.prefill_chunk(
                chunk, start, total, seq.block_ids, seq.temperature, seq.top_p,
                seq.top_k, rep_pen=seq.rep_pen, key_data=key_row,
                eos_ids=seq.eos_row, eos_suppress=eos_suppress,
            )
            return runner.fetch_sample(out) if final else None

        sample = await self._device(run_chunk, "prefill_chunk", tokens=len(chunk))
        self.stats.chunk_steps += 1
        if seq.spans:
            self._sp_span_event(seq, "prefill", "prefill_chunk", pos=start, tokens=len(chunk))
        if seq.slot is None:  # cancelled during the device call
            return
        seq.prefill_pos = min(start + C, total)
        if seq.prefill_pos >= total:
            self._prefilling.remove(seq)
            seq.prefilling = False
            self._set_chain(seq)
            tok, lp, tids, tlps = sample
            self._append_token(seq, int(tok[0]), float(lp[0]), tids[0], tlps[0])

    def _can_mix(self, active: list[_Sequence]) -> bool:
        """Whether one mixed step can replace this iteration's chunk and
        decode step (engine.py:1853): not while a drafter is active (the
        port has no brownout pause of drafting), nor when a lane has
        penalties, whose full-history program the mixed step does not
        carry, nor with a decode horizon. Read-only: it must not touch the
        drafter."""
        if not self._mixed_enabled or not self._step_chunk_budget:
            return False
        if self.drafter is not None and not self._spec_paused:
            return False
        if self.config.decode_horizon > 1:
            return False
        return not any(s.has_penalties for s in active)

    async def _mixed_step_phase(self, active: list[_Sequence]) -> None:
        """One step for the whole iteration (engine.py:1870-1990): every
        decode lane plus prompt chunks, oldest prompt first, up to the
        budget and the slot cap (several chunks of one prompt, or chunks of
        several prompts, may share a step). One device-to-host copy brings
        back the decode samples with the samples of every chunk that ends
        its prompt."""
        C = self._step_chunk_tokens
        budget = self._step_chunk_budget
        chunks: list[tuple] = []
        packed: list[tuple[_Sequence, int, int]] = []  # (seq, start, n)
        plan: list[tuple[_Sequence, int]] = []  # tokens each sequence advances
        for seq in sorted(self._prefilling, key=self._queue_key):
            if budget <= 0 or len(chunks) >= self._mixed_max_slots:
                break
            total = len(seq.token_ids)
            pos = seq.prefill_pos
            advanced = 0
            key_row = self._key_row(seq)
            while pos < total and budget > 0 and len(chunks) < self._mixed_max_slots:
                # the budget is a multiple of the block size, so every chunk
                # but a prompt's last starts and ends on a block boundary
                n = min(C, total - pos, budget)
                chunks.append((
                    seq.token_ids[pos:pos + n], pos, total, seq.block_ids,
                    seq.temperature, seq.top_p, seq.top_k, seq.rep_pen, key_row,
                    seq.eos_row, seq.needs_eos_suppress,
                ))
                packed.append((seq, pos, n))
                pos += n
                budget -= n
                advanced += n
            if advanced:
                plan.append((seq, advanced))
        # decode lanes: single-step semantics, and always the EOS-masked
        # variant (neutral rows are a bitwise no-op)
        bs = self.config.block_size
        self._clear_lanes()
        for seq in active:
            pos = self._fill_lane(seq)
            self._slot_indices[seq.slot] = seq.block_ids[pos // bs] * bs + pos % bs
        eos_ids, eos_sup = self._eos_rows(active)
        final_slots = [
            i for i, (seq, start, n) in enumerate(packed) if start + n >= len(seq.token_ids)
        ]
        runner = self.runner
        args = (
            self._tokens.copy(), self._positions.copy(), self._block_tables.copy(),
            self._slot_indices.copy(), self._keys.copy(), self._temps.copy(),
            self._top_ps.copy(), self._top_ks.copy(),
        )

        def run_mixed():
            chunk_outs, d_out = runner.mixed_step(
                chunks, *args, eos_ids=eos_ids, eos_suppress=eos_sup)
            fetch = [t for i in final_slots for t in chunk_outs[i]]
            return runner.fetch_sample((*fetch, *d_out))

        out = await self._device(run_mixed, "mixed_step", lanes=len(active),
                                 capacity=self.config.max_batch,
                                 tokens=sum(n for _, _, n in packed))
        self.stats.mixed_steps += 1
        for seq, start, n in packed:
            if seq.spans:
                self._sp_span_event(seq, "prefill", "prefill_chunk", pos=start, tokens=n)
        final_samples = {slot: out[4 * j:4 * j + 4] for j, slot in enumerate(final_slots)}
        toks, lps, tids, tlps = out[4 * len(final_slots):]
        for seq, advanced in plan:
            seq.prefill_pos = min(seq.prefill_pos + advanced, len(seq.token_ids))
            if seq.prefill_pos >= len(seq.token_ids):
                self._prefilling.remove(seq)
                seq.prefilling = False
                self._set_chain(seq)
        for i, (seq, _, _) in enumerate(packed):
            if i in final_samples and seq.slot is not None:
                tok, lp, tid, tlp = final_samples[i]
                self._append_token(seq, int(tok[0]), float(lp[0]), tid[0], tlp[0])
        if dtrace.enabled():
            self._sp_batch_event(active, "decode_step", batch=len(active))
        for seq in active:
            if seq.slot is None:
                continue  # finished, cancelled or preempted meanwhile
            i = seq.slot
            self._append_token(seq, int(toks[i]), float(lps[i]), tids[i], tlps[i])

    def _lane_remaining(self, seq: _Sequence) -> int:
        """Tokens this lane may still emit (max_new and model-length caps)."""
        return max(1, min(
            seq.max_new - seq.num_generated,
            self.config.max_model_len - len(seq.token_ids),
        ))

    def _clear_lanes(self) -> None:
        self._block_tables.fill(0)
        self._positions.fill(0)
        self._tokens.fill(0)
        self._slot_indices.fill(0)  # null block slot 0
        self._temps.fill(0.0)
        self._top_ps.fill(1.0)
        self._top_ks.fill(0)

    def _fill_lane(self, seq: _Sequence) -> int:
        """Write one active lane's per-step inputs into the batch arrays;
        returns the position of the token being fed."""
        i = seq.slot
        pos = len(seq.token_ids) - 1
        self._tokens[i] = seq.token_ids[-1]
        self._positions[i] = pos
        self._block_tables[i, : len(seq.block_ids)] = seq.block_ids
        self._temps[i] = seq.temperature
        self._top_ps[i] = seq.top_p
        self._top_ks[i] = seq.top_k
        self._keys[i] = self._key_row(seq)
        return pos

    async def _decode_phase(self, active: list[_Sequence]) -> None:
        # brownout >= spec_off pauses drafting: the verify premium and the
        # drafter's host time go back to real tokens while the SLO burns
        if self.drafter is not None and not self._spec_paused:
            drafts = self._collect_drafts(active)
            if drafts is not None:
                await self._spec_decode_phase(active, drafts)
                return
        H = self._horizon_for(active)
        active = [s for s in active if s.slot is not None]  # a degrade fails every lane
        if H > 1:
            await self._decode_multi_phase(active, H)
        elif active:
            await self._decode_single_phase(active)

    def _horizon_ready(self, H: int) -> bool:
        """Under ``lazy_horizon``, whether the runner has prepared H (its
        preparation queued on the device thread when not); a failed
        preparation degrades the horizon."""
        if not self.config.lazy_horizon:
            return True
        try:
            if self.runner.decode_multi_ready(H):
                return True
        except Exception:  # noqa: BLE001 - the reference's degrade
            logger.exception("preparing decode_multi@H%d failed; degrading to single-step", H)
            self._degrade_horizon()
            return False
        self.runner.prepare_decode_multi_async(H, self._executor)
        return False

    def _degrade_horizon(self) -> None:
        """The reference's lazy-horizon degrade (engine.py:3064-3081): H
        drops to 1 for good and every lane holding a slot fails with ERROR
        (its cache may hold the failed dispatch's partial writes)."""
        self.config.decode_horizon = 1
        self.stats.horizon_degrades += 1
        for seq in list(self._admit_order):
            # a sequence awaiting its remote prefill had no write in it
            if seq.slot is not None and not seq.pending_remote:
                self._finish(seq, FinishReason.ERROR)

    def _horizon_for(self, active: list[_Sequence]) -> int:
        """This iteration's decode horizon, 1 for a single step
        (engine.py:2634-2685)."""
        H = self.config.decode_horizon
        if H <= 1 or not self._horizon_ready(H):
            return 1
        # a min_tokens lane whose stop ids overflow the device mask needs a
        # redraw per token (_append_token), which a horizon cannot do
        if any(s.needs_eos_suppress and len(s.eos) > MAX_EOS_IDS for s in active):
            return 1
        # no lane emits more than its budget: no all-frozen steps
        H = max(1, min(H, max(self._lane_remaining(s) for s in active)))
        if H == 1:
            return 1
        # blocks for every write of the horizon, each lane capped by its own
        # budget; under pressure a single step (its allocation may preempt)
        bs = self.config.block_size
        for seq in active:
            last_write = len(seq.token_ids) - 1 + min(H, self._lane_remaining(seq)) - 1
            need = last_write // bs + 1 - len(seq.block_ids)
            if need > 0:
                try:
                    seq.block_ids.extend(self.allocator.alloc(need))
                except OutOfBlocks:
                    return 1
        return H

    def _horizon_rows(self, active: list[_Sequence]):
        """The per-lane rows a horizon or verify dispatch takes beside the
        batch arrays: (active, limit_remaining, min_remaining, eos_ids)."""
        B = self.config.max_batch
        act = np.zeros(B, bool)
        limit_rem = np.ones(B, np.int64)
        min_rem = np.zeros(B, np.int64)
        eos_ids, _ = self._eos_rows(active)
        for seq in active:
            i = seq.slot
            act[i] = True
            limit_rem[i] = self._lane_remaining(seq)
            min_rem[i] = max(0, seq.min_tokens - seq.num_generated)
        return act, limit_rem, min_rem, eos_ids

    def _append_row(self, seq: _Sequence, row: np.ndarray, n_top: int) -> None:
        self._append_token(seq, int(row[0]), float(row[1]),
                           row[2:2 + n_top].astype(np.int32), row[2 + n_top:])

    async def _decode_multi_phase(self, active: list[_Sequence], H: int) -> None:
        """H chained steps in one dispatch, one packed fetch
        (engine.py:2996-3101): the device freezes a lane at its EOS or
        budget and emits -1 after; the host replays the [H, B, .] samples
        through ``_append_token``, as single steps would."""
        self._clear_lanes()
        for seq in active:
            self._fill_lane(seq)
        rows = self._horizon_rows(active)
        # one history upload per horizon; the device keeps the count tables
        penalties = (
            self._penalty_rows(active) if any(s.has_penalties for s in active) else None
        )
        runner = self.runner
        args = (
            self._tokens.copy(), self._positions.copy(), self._block_tables.copy(),
            self._temps.copy(), self._top_ps.copy(), self._top_ks.copy(), self._keys.copy(),
            *rows,
        )
        try:
            packed = await self._device(
                lambda: runner.decode_multi(H, *args, penalties=penalties).cpu().numpy(),
                f"decode_multi@H{H}", lanes=len(active), capacity=self.config.max_batch)
        except Exception:
            if not self.config.lazy_horizon:
                raise
            logger.exception("decode_multi@H%d failed at run time; degrading to single-step", H)
            self._degrade_horizon()
            return
        self.stats.horizon_dispatches += 1
        self.stats.horizon_steps += H
        if dtrace.enabled():
            self._sp_batch_event(active, "decode_horizon", H=H, batch=len(active))
        n_top = (packed.shape[-1] - 2) // 2
        for h in range(H):
            for seq in active:
                if seq.slot is None:
                    continue  # finished earlier in this horizon
                row = packed[h, seq.slot]
                if row[0] < 0:
                    continue  # frozen on the device
                self.stats.horizon_tokens += 1
                self._append_row(seq, row, n_top)

    def _eos_rows(self, active: list[_Sequence]) -> tuple[np.ndarray, np.ndarray]:
        """Each lane's stop-id row and whether its EOS is masked this step."""
        B = self.config.max_batch
        eos_ids = np.full((B, MAX_EOS_IDS), -1, np.int64)
        eos_sup = np.zeros(B, bool)
        for seq in active:
            eos_ids[seq.slot] = seq.eos_row
            eos_sup[seq.slot] = seq.needs_eos_suppress
        return eos_ids, eos_sup

    def _penalty_rows(self, active: list[_Sequence]) -> tuple[np.ndarray, ...]:
        """(hist, hist_len, prompt_len, freq, pres, rep) of every lane, the
        history padded to max_model_len."""
        B, L = self.config.max_batch, self.config.max_model_len
        hist = np.zeros((B, L), np.int64)
        hist_len = np.zeros(B, np.int64)
        prompt_len = np.zeros(B, np.int64)
        freq = np.zeros(B, np.float32)
        pres = np.zeros(B, np.float32)
        rep = np.ones(B, np.float32)
        for seq in active:
            i = seq.slot
            n = min(len(seq.token_ids), L)
            hist[i, :n] = seq.token_ids[:n]
            hist_len[i] = n
            prompt_len[i] = min(seq.num_prompt, n)
            freq[i], pres[i], rep[i] = seq.freq_pen, seq.pres_pen, seq.rep_pen
        return hist, hist_len, prompt_len, freq, pres, rep

    async def _decode_single_phase(self, active: list[_Sequence]) -> None:
        bs = self.config.block_size
        self._clear_lanes()
        for seq in active:
            pos = self._fill_lane(seq)
            self._slot_indices[seq.slot] = seq.block_ids[pos // bs] * bs + pos % bs
        # the history goes up only when a lane has penalties; a min_tokens
        # lane alone needs only the stop-id rows
        penalties = eos_mask = None
        if any(s.has_penalties for s in active):
            penalties = (*self._penalty_rows(active), *self._eos_rows(active))
        elif any(s.needs_eos_suppress for s in active):
            eos_mask = self._eos_rows(active)
        runner = self.runner
        args = (
            self._tokens.copy(), self._positions.copy(), self._block_tables.copy(),
            self._slot_indices.copy(), self._temps.copy(), self._top_ps.copy(),
            self._top_ks.copy(), self._keys.copy(),
        )
        toks, lps, tids, tlps = await self._device(
            lambda: runner.fetch_sample(runner.decode(
                *args[:7], keys=args[7], penalties=penalties, eos_mask=eos_mask)), "decode",
            lanes=len(active), capacity=self.config.max_batch,
        )
        self.stats.decode_steps += 1
        if dtrace.enabled():
            self._sp_batch_event(active, "decode_step", batch=len(active))
        for seq in active:
            if seq.slot is None:
                continue  # finished, cancelled or preempted meanwhile
            i = seq.slot
            self._append_token(seq, int(toks[i]), float(lps[i]), tids[i], tlps[i])

    def _collect_drafts(self, active: list[_Sequence]) -> Optional[dict[int, list[int]]]:
        """Host drafting pass: seq_id -> proposed continuation tokens, or
        None for a plain decode step (no lane drafted, or fewer than
        ``spec_min_coverage`` of them, or a min_tokens lane holds more stop
        ids than the device mask: its early stop ids need a redraw per
        token, as in the JAX engine)."""
        if any(s.needs_eos_suppress and len(s.eos) > MAX_EOS_IDS for s in active):
            return None
        out: dict[int, list[int]] = {}
        for seq in active:
            if seq.spec_backoff > 0:
                seq.spec_backoff -= 1
                out[seq.seq_id] = []
                continue
            # the verify pass emits one token past the accepted drafts: cap
            # the drafts so the lane's writes stay inside its budget
            cap = min(self.config.spec_k, self._lane_remaining(seq) - 1)
            out[seq.seq_id] = self.drafter.draft(seq.token_ids, cap) if cap > 0 else []
        drafted = sum(1 for d in out.values() if d)
        need = max(1, int(np.ceil(self.config.spec_min_coverage * len(active))))
        return out if drafted >= need else None

    async def _spec_decode_phase(
        self, active: list[_Sequence], drafts: dict[int, list[int]]
    ) -> None:
        """One verify dispatch (with H > 1 and no penalty lane, H - 1
        decode steps chained after it on the device, engine.py:2826-2870),
        then host-side accept: each lane's samples go in order through
        ``_append_token`` (streaming, stops and block growth as on every
        other step) and the lane stops at its first draft mismatch; then
        the chained rows, frozen steps (-1) skipped. Every emitted token is
        the model's own sample; the draft only decides how many weight
        passes those tokens cost."""
        B = self.config.max_batch
        K = self.config.spec_k
        bs = self.config.block_size
        any_pen = any(s.has_penalties for s in active)
        # the chained continuation; penalty batches verify alone (the count
        # tables cannot take a rejected draft back out)
        H = self.config.decode_horizon
        E = H - 1 if H > 1 and not any_pen and self._horizon_ready(H) else 0
        if any(s.slot is None for s in active):
            return  # the horizon degraded and failed every lane
        # blocks for every write of this dispatch: the last emitted token is
        # not fed, so the writes reach lane_steps - 1 positions past the fed
        # one; under block pressure a plain step (its allocation preempts)
        for seq in active:
            lane_steps = min(len(drafts[seq.seq_id]) + 1 + E, self._lane_remaining(seq))
            need = (len(seq.token_ids) - 1 + lane_steps - 1) // bs + 1 - len(seq.block_ids)
            if need > 0:
                try:
                    seq.block_ids.extend(self.allocator.alloc(need))
                except OutOfBlocks:
                    await self._decode_single_phase(active)
                    return
        self._clear_lanes()
        draft_arr = np.full((B, K), -1, np.int64)
        draft_len = np.zeros(B, np.int64)
        act, limit_rem, min_rem, eos_ids = self._horizon_rows(active)
        for seq in active:
            i = seq.slot
            self._fill_lane(seq)
            d = drafts[seq.seq_id]
            draft_len[i] = len(d)
            if d:
                draft_arr[i, : len(d)] = d
                self.stats.num_drafts += 1
                self.stats.num_draft_tokens += len(d)
        # penalties ride the verify positions: one history upload per dispatch
        penalties = self._penalty_rows(active) if any_pen else None
        runner = self.runner
        args = (
            self._tokens.copy(), draft_arr, draft_len, self._positions.copy(),
            self._block_tables.copy(), self._temps.copy(), self._top_ps.copy(),
            self._top_ks.copy(), self._keys.copy(), act, limit_rem, min_rem, eos_ids,
        )
        # one device-to-host copy of the packed [S + E, B, 2 + 2K] samples
        packed = await self._device(
            lambda: runner.spec_verify(K, E, *args, penalties=penalties).cpu().numpy(),
            "spec_verify", lanes=len(active), capacity=self.config.max_batch)
        self.stats.verify_steps += 1
        self.stats.verify_chained_steps += E
        if dtrace.enabled():
            self._sp_batch_event(active, "spec_verify", K=K, E=E, batch=len(active))
        n_top = (packed.shape[-1] - 2) // 2
        for seq in active:
            if seq.slot is None:
                continue
            i = seq.slot
            d = drafts[seq.seq_id]
            accepted = 0
            for h in range(len(d) + 1):
                row = packed[h, i]
                tok = int(row[0])
                if tok < 0:
                    break  # the device marked the position invalid
                accept = h < len(d) and d[h] == tok
                self._append_row(seq, row, n_top)
                if accept:
                    accepted += 1
                    self.stats.num_accepted_tokens += 1
                    self.stats.accepted_per_pos[h] += 1
                if seq.slot is None or not accept:
                    break
            if d:
                # the verify premium paid for the rejected draft positions
                self.stats.goodput.record_waste("spec_rejected", len(d) - accepted)
                if accepted:
                    seq.spec_fail = 0
                else:
                    # the history stopped predicting: back off this lane's
                    # drafting exponentially
                    seq.spec_fail += 1
                    seq.spec_backoff = min(1 << seq.spec_fail, 32)
        # the chained steps from each lane's accept point (a lane finished
        # above holds no slot and skips them)
        for e in range(E):
            for seq in active:
                if seq.slot is None:
                    continue
                row = packed[K + 1 + e, seq.slot]
                if row[0] >= 0:
                    self._append_row(seq, row, n_top)

    def _append_token(self, seq: _Sequence, token: int, lp: float, top_ids, top_lps) -> None:
        """Record a newly generated token: stream it, grow blocks, stop."""
        self.stats.generated_tokens += 1
        self.stats.goodput.record_decode_tokens()
        if seq.spans and "decode" not in seq.spans:
            # first token: the prefill phase (local or remote) is over
            self._sp_finish(seq, "prefill")
            self._sp_finish(seq, "remote_prefill")
            self._sp_begin(seq, "decode")
        if faults.active():
            inj = faults.get_injector()
            if inj is not None and inj.on_token():
                self._abort_all("injected engine fault (abort_after_tokens)")
                return
        if seq.ctx.is_stopped():
            self._finish(seq, FinishReason.CANCELLED)
            return
        if token in seq.eos:
            if seq.num_generated >= seq.min_tokens:
                self._finish(seq, FinishReason.EOS)  # the stop token stays hidden
                return
            # min_tokens not reached, yet a stop id past the device mask's
            # MAX_EOS_IDS was sampled: drop it and redraw next step with a
            # fresh key (_key_row); a greedy lane may repeat it, so finish
            # after a few drops
            seq.eos_drops += 1
            if seq.eos_drops > 4:
                self._finish(seq, FinishReason.EOS)
            return
        seq.token_ids.append(token)
        if seq.hash_seq is not None:
            seq.hash_seq.append(token)
            self._emit_stored(seq)
        out = LLMEngineOutput(token_ids=[token], fetch=self._fetches)
        if seq.cold_seen != self.stats.cold_dispatches:
            out.cold = True
            seq.cold_seen = self.stats.cold_dispatches
        if seq.want_logprobs:
            out.log_probs = [lp]
            k = seq.num_top_lp
            if k:
                out.top_logprobs = [
                    [[int(t), float(v)] for t, v in zip(top_ids[:k], top_lps[:k])]
                ]
        seq.out.put_nowait(out)
        if (
            seq.num_generated >= seq.max_new
            or len(seq.token_ids) >= self.config.max_model_len
        ):
            self._finish(seq, FinishReason.LENGTH)
            return
        # the NEXT decode step writes KV at position len-1; allocate its
        # block just in time when the sequence crosses a block boundary
        if (len(seq.token_ids) - 1) // self.config.block_size >= len(seq.block_ids):
            try:
                seq.block_ids.extend(self.allocator.alloc(1))
            except OutOfBlocks:
                if self._preempt_victim(exclude=seq):
                    seq.block_ids.extend(self.allocator.alloc(1))
                elif any(v is not seq and v.slot is not None and not v.pending_remote
                         for v in self._admit_order):
                    # every other lane outranks this one: it yields itself
                    # (engine.py:3184-3200), its KV to the host tier when
                    # there is one, and resumes by re-admission
                    if dprov.enabled():
                        dprov.record("engine", "preempt", seq.priority, reason="self_yield",
                                     ctx=seq.ctx, proc=self.trace_proc, grower=seq.ctx.id,
                                     grower_class=seq.priority)
                    self._preempt(seq)
                else:
                    self._finish_error(seq, "decode", "out of KV blocks with no preemptable "
                                       "sequence", "out_of_kv_blocks")

    # ------------------------------------------ disaggregated prefill: decode

    async def _use_remote(self, seq: _Sequence, hit_len: int) -> bool:
        """Whether the router ships this sequence's prefill, given the
        tokens its tier hit covers (the queue depth refreshed first when the
        router has a queue)."""
        router = self.disagg_router
        if router is None or self.remote_prefill_client is None:
            return False
        refresh = getattr(router, "maybe_refresh", None)
        if refresh is not None:
            await refresh()
        return router.prefill_remote(len(seq.token_ids), hit_len)

    @staticmethod
    def _kv_stream_enabled() -> bool:
        """Streaming KV frames, on unless ``DYN_KV_STREAM=0``."""
        return os.environ.get("DYN_KV_STREAM", "1") not in ("0", "false", "no")

    def _land(self, seq: _Sequence, sample: Optional[tuple],
              fail: Optional[FinishReason]) -> None:
        self._landed.append((seq, sample, fail))
        self._wake.set()

    def _process_landed(self) -> None:
        """Complete the landed remote prefills on the engine loop, between
        dispatches (engine.py:2003-2028): each joins the decode batch with
        its first token, or finishes."""
        landed, self._landed = self._landed, []
        for seq, sample, fail in landed:
            if seq.slot is None:  # freed meanwhile (close, a loop crash)
                continue
            seq.pending_remote = False
            if sample is None:
                if fail is FinishReason.CANCELLED:
                    self._finish(seq, fail)
                else:
                    self._finish_error(seq, "remote_prefill", "landing remote prefill failed",
                                       "remote_prefill_failed")
                continue
            self._set_chain(seq)
            token, lp, top = sample
            top_ids = np.array([t for t, _ in top or []], np.int32)
            top_lps = np.array([v for _, v in top or []], np.float32)
            self._append_token(seq, int(token), float(lp or 0.0), top_ids, top_lps)

    async def _remote_prefill_task(self, seq: _Sequence) -> None:
        """Await the remote prefill, land its KV and hand the sequence to
        the loop (engine.py:2088-2193). The client gets the whole keyword
        surface of the reference's call. A killed sequence or a cancelled
        stream finishes it; a failure, an error answer or a stream that
        lost a frame falls back to a local prefill on this device. The
        sequence's cached prefix is onboarded first and not shipped
        (``cached_blocks``, :2102-2127)."""
        cached = await self._onboard_prefix(seq)
        stream = self._kv_stream_enabled()
        landed: set[int] = set()
        rsp = seq.spans.get("remote_prefill")

        async def on_frame(frame: KvStreamFrame) -> None:
            with dtrace.span("kv_land", parent=rsp, proc=self.trace_proc, seq=frame.seq,
                             blocks=frame.payload.num_blocks, nbytes=frame.payload.wire_nbytes):
                await self._land_stream_frame(seq, frame, landed)

        extra = None
        if rsp is not None:
            # the prefill worker parents its serving span under this one
            extra = {"trace": {"tid": rsp.trace_id, "sid": rsp.span_id}}

        try:
            resp = await self.remote_prefill_client.prefill(
                list(seq.token_ids), temperature=seq.temperature, top_p=seq.top_p,
                top_k=seq.top_k, cached_blocks=cached, rep_pen=seq.rep_pen,
                key_data=self._key_row(seq), eos_ids=seq.eos_row,
                eos_suppress=seq.needs_eos_suppress, stream=stream,
                on_frame=on_frame if stream else None, deadline=seq.ctx.deadline, ctx=seq.ctx,
                extra=extra,
            )
        except PrefillStreamCancelled:
            self._land(seq, None, FinishReason.CANCELLED)
            return
        except asyncio.CancelledError:
            if self._closed:
                raise
            logger.warning("remote prefill of seq %d cancelled; falling back local", seq.seq_id)
            resp = None
        except Exception as e:  # noqa: BLE001 - any failure of the remote side
            logger.warning("remote prefill of seq %d failed (%s: %s); falling back local",
                           seq.seq_id, type(e).__name__, e)
            resp = None
        if resp is not None and resp.code == "deadline_exceeded":
            seq.ctx.kill()
            self._land(seq, None, FinishReason.CANCELLED)
            return
        if seq.slot is None:
            return
        if seq.ctx.is_killed() or seq.ctx.is_stopped():
            self._land(seq, None, FinishReason.CANCELLED)
            return
        if resp is not None and resp.error is not None:
            logger.warning("remote prefill of seq %d answered %r; falling back local",
                           seq.seq_id, resp.error)
        elif resp is not None and resp.streamed_blocks:
            # every block before the final payload must have landed from a
            # frame: a lost frame would leave a hole in the KV
            missing = set(range(cached, resp.first_block)) - landed
            if missing:
                logger.warning("seq %d: the stream lost %d block(s); falling back local",
                               seq.seq_id, len(missing))
                resp = None
        if faults.active():
            inj = faults.get_injector()
            if inj is not None:
                await inj.on_transfer()
        if rsp is not None:
            rsp.set(blocks_landed=len(landed), fallback_local=resp is None)
        try:
            self._land(seq, await self._land_prefill(seq, resp), None)
        except Exception:  # noqa: BLE001 - never strand the consumer
            logger.exception("landing the prefill of seq %d failed", seq.seq_id)
            self._land(seq, None, FinishReason.ERROR)

    async def _land_prefill(self, seq: _Sequence, resp) -> tuple:
        """Land a response's KV in the sequence's blocks (device payload,
        or the host payload's blocks not streamed), or prefill locally when
        there is none to land (engine.py:2239-2294). Returns (first token,
        logprob, top)."""
        runner = self.runner
        if resp is not None and resp.error is None:
            if isinstance(resp, DevicePrefillResponse):
                ids = seq.block_ids[resp.first_block:resp.first_block + resp.num_blocks]
                if ids:
                    k, v = resp.k_dev[:, :, :len(ids)], resp.v_dev[:, :, :len(ids)]
                    await self._device(lambda: runner.inject_blocks_device(ids, k, v), "kv_inject")
            elif resp.payload is not None:
                self.stats.kv_wire_bytes_rx += resp.payload.wire_nbytes
                ids = seq.block_ids[resp.first_block:resp.first_block + resp.payload.num_blocks]
                if ids:
                    await self._inject_payload(ids, resp.payload)
            return resp.first_token, resp.first_logprob, resp.first_top
        self.stats.remote_fallbacks += 1
        self.stats.prefills += 1
        replay = list(seq.token_ids)
        key_row = self._key_row(seq)
        eos_suppress = seq.needs_eos_suppress
        tok, lp, tids, tlps = await self._device(
            lambda: runner.fetch_sample(runner.prefill(
                replay, seq.block_ids, seq.temperature, seq.top_p, seq.top_k,
                rep_pen=seq.rep_pen, key_data=key_row, eos_ids=seq.eos_row,
                eos_suppress=eos_suppress,
            )), "prefill", tokens=len(replay)
        )
        return int(tok[0]), float(lp[0]), [[int(t), float(v)] for t, v in zip(tids[0], tlps[0])]

    async def _inject_payload(self, ids: list[int], payload: KvBlockPayload) -> None:
        """Land a host payload in ``ids`` (engine.py:2037-2063): an int8
        payload verbatim into an int8-resident cache, every other through
        ``decode()`` and the (quantize-on-inject) scatter. Verifying and
        decoding run off the event loop."""
        n = len(ids)
        runner = self.runner
        if payload.codec == "int8" and runner.kv_quantized:
            kq, ks, vq, vs = await asyncio.to_thread(payload.quantized_arrays)
            await self._device(lambda: runner.inject_blocks_quant(
                ids, kq[:, :, :n], ks[:, :, :n], vq[:, :, :n], vs[:, :, :n]), "kv_inject")
            return
        k, v = await asyncio.to_thread(payload.decode)
        await self._device(lambda: runner.inject_blocks(ids, k[:, :, :n], v[:, :, :n]), "kv_inject")

    async def _land_stream_frame(self, seq: _Sequence, frame: KvStreamFrame,
                                 landed: set) -> None:
        """Land one streamed frame while later chunks still compute
        (engine.py:2065-2086); a cancelled sequence drops it."""
        if seq.slot is None or seq.ctx.is_killed() or seq.ctx.is_stopped():
            return
        n = frame.payload.num_blocks
        ids = seq.block_ids[frame.first_block:frame.first_block + n]
        if not ids:
            return
        await self._inject_payload(ids, frame.payload)
        landed.update(range(frame.first_block, frame.first_block + len(ids)))
        nbytes = frame.payload.wire_nbytes
        self.stats.kv_frames_rx += 1
        self.stats.kv_wire_bytes_rx += nbytes
        self.stats.kv_bytes_overlapped += nbytes

    # ----------------------------------------- disaggregated prefill: prefill

    def _prefill_request(self, req) -> tuple[list[int], Optional[Any]]:
        """(scratch blocks, None) for a request, or (None, the error
        answer) when the prompt is too long."""
        T = len(req.token_ids)
        if T > self.config.max_model_len:
            return [], f"prompt {T} exceeds max_model_len"
        bs = self.config.block_size
        return self.allocator.alloc(-(-T // bs)), None

    @staticmethod
    def _first_token_args(req) -> dict:
        """The requester's first-token identity as the runner takes it."""
        return dict(
            rep_pen=req.rep_pen,
            key_data=np.asarray(req.key_data, np.int64) if req.key_data is not None else None,
            eos_ids=np.asarray(req.eos_ids, np.int64) if req.eos_ids is not None else None,
            eos_suppress=req.eos_suppress,
        )

    def _served(self, req, sample, cls, **kw):
        tok, lp, tids, tlps = sample
        self.stats.generated_tokens += 1
        self.stats.prefills_served += 1
        return cls(request_id=req.request_id, first_token=int(tok[0]),
                   first_logprob=float(lp[0]),
                   first_top=[[int(t), float(v)] for t, v in zip(tids[0], tlps[0])], **kw)

    def _payload_builder(self) -> tuple[Callable, Callable]:
        """(extract, build): the host payload of some blocks, read verbatim
        from an int8-resident cache, else encoded with ``DYN_KV_WIRE``'s
        codec."""
        runner = self.runner
        if runner.kv_quantized:
            return runner.extract_blocks_quant, lambda data: KvBlockPayload.from_quantized(*data)
        codec, dtype = wire_codec_from_env(), dtype_name(runner.kv_logical_dtype)
        return runner.extract_blocks, lambda data: KvBlockPayload.encode(*data, codec, dtype)

    async def prefill_only(self, req) -> RemotePrefillResponse:
        """Serve one RemotePrefillRequest, the prefill-worker role
        (engine.py:2296-2383): the whole prompt through the single-shot
        prefill on scratch blocks, the blocks from ``req.cached_blocks`` on
        shipped as a host payload."""
        block_ids, error = self._prefill_request(req)
        if error:
            return RemotePrefillResponse(request_id=req.request_id, first_token=-1, error=error)
        runner = self.runner
        extract, build = self._payload_builder()
        ship = block_ids[req.cached_blocks:]
        args = self._first_token_args(req)
        try:
            def run():
                sample = runner.fetch_sample(runner.prefill(
                    list(req.token_ids), block_ids, req.temperature, req.top_p, req.top_k,
                    **args))
                return sample, extract(ship) if ship else None

            sample, data = await self._device(run, "prefill", tokens=len(req.token_ids))
        finally:
            self.allocator.free(block_ids)
        payload = None
        if ship:
            payload = await asyncio.to_thread(build, data)
            self.stats.kv_wire_bytes_tx += payload.wire_nbytes
        return self._served(req, sample, RemotePrefillResponse, payload=payload,
                            first_block=req.cached_blocks)

    async def prefill_only_stream(
        self, req, emit, cancelled: Optional[Callable[[], bool]] = None
    ) -> Optional[RemotePrefillResponse]:
        """The streaming prefill-worker role (engine.py:2385-2530): the
        prompt through the chunked prefill, and after each chunk but the
        last a KvStreamFrame of the blocks it completed goes to ``emit``
        (which may await). A truthy ``cancelled()`` between chunks ends the
        stream: the scratch blocks are freed and None is returned. A prompt
        that fits one chunk is answered by ``prefill_only``."""
        C = self.runner.prefill_chunk_tokens
        T = len(req.token_ids)
        if not C or T <= C:
            return await self.prefill_only(req)
        block_ids, error = self._prefill_request(req)
        if error:
            return RemotePrefillResponse(request_id=req.request_id, first_token=-1, error=error)
        runner = self.runner
        extract, build = self._payload_builder()
        args = self._first_token_args(req)
        bs = self.config.block_size
        # cached leading blocks are never shipped; `shipped` is the block
        # cursor of the stream
        shipped = min(int(req.cached_blocks or 0), len(block_ids) - 1)
        streamed = frames = 0
        try:
            out = None
            pos = 0
            while pos < T:
                if cancelled is not None and cancelled():
                    return None
                chunk = req.token_ids[pos:pos + C]
                start = pos
                out = await self._device(lambda: runner.prefill_chunk(
                    chunk, start, T, block_ids, req.temperature, req.top_p, req.top_k, **args),
                    "prefill_chunk", tokens=len(chunk))
                pos += len(chunk)
                # the blocks this chunk completed; the partial tail waits for
                # the final frame, so each block lands exactly once
                upto = pos // bs
                if pos < T and upto > shipped:
                    ids = block_ids[shipped:upto]
                    data = await self._device(lambda: extract(ids), "kv_extract")
                    payload = await asyncio.to_thread(build, data)
                    frame = KvStreamFrame(request_id=req.request_id, seq=frames,
                                          first_block=shipped, payload=payload)
                    frames += 1
                    self.stats.kv_frames_tx += 1
                    self.stats.kv_wire_bytes_tx += payload.wire_nbytes
                    await emit(frame)
                    streamed += len(ids)
                    shipped = upto
            if cancelled is not None and cancelled():
                return None
            ship = block_ids[shipped:]
            sample, data = await self._device(
                lambda: (runner.fetch_sample(out), extract(ship) if ship else None), "kv_extract")
        finally:
            self.allocator.free(block_ids)
        payload = None
        if ship:
            payload = await asyncio.to_thread(build, data)
            self.stats.kv_wire_bytes_tx += payload.wire_nbytes
        return self._served(req, sample, RemotePrefillResponse, payload=payload,
                            first_block=shipped, streamed_blocks=streamed)

    async def prefill_only_device(self, req) -> DevicePrefillResponse:
        """The colocated prefill-worker role (engine.py:2541-2607): as
        ``prefill_only``, but the shipped blocks stay on this engine's
        device (``extract_blocks_device``) for the decode engine's
        ``inject_blocks_device``: no host copy."""
        block_ids, error = self._prefill_request(req)
        if error:
            return DevicePrefillResponse(request_id=req.request_id, first_token=-1, error=error)
        runner = self.runner
        ship = block_ids[req.cached_blocks:]
        args = self._first_token_args(req)
        try:
            def run():
                sample = runner.fetch_sample(runner.prefill(
                    list(req.token_ids), block_ids, req.temperature, req.top_p, req.top_k,
                    **args))
                return sample, runner.extract_blocks_device(ship) if ship else (None, None, 0)

            sample, (k, v, n) = await self._device(run, "prefill", tokens=len(req.token_ids))
        finally:
            self.allocator.free(block_ids)
        return self._served(req, sample, DevicePrefillResponse, k_dev=k, v_dev=v, num_blocks=n,
                            first_block=req.cached_blocks)
