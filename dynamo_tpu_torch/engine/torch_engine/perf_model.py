"""Decode-step HBM traffic model and the MFU estimate.

The port's own copy of dynamo_tpu/engine/jax_engine/perf_model.py, with the
same byte model: every decode step streams the weights once per batch
(amortized over B lanes), each lane's live KV pages (whole blocks, as the
paged kernels read them; int8 scales when the cache is int8), and the
activation round trips between separately launched ops; under a tensor-
parallel group the per-card share and the tp axis's collective bytes.
``TorchEngine`` exports it as the ``decode_hbm_bytes_per_token``,
``tp_collective_bytes_per_step`` and ``mfu_decode_est`` gauges of its
load metrics.

Two differences from the reference, by design:

  * ``DEFAULT_PEAK_FLOPS`` is the H100 SXM's dense bf16 peak, 989.4e12
    FLOP/s (the reference's is a v5e's, 197e12); ``DYN_TPU_PEAK_FLOPS``
    overrides it under the reference's name.
  * The layer boundaries are the port's decode layer's
    (``models/llama.py``), counted as tensors one op of the layer writes and
    the next reads back. Unfused: norm, q/k/v, rope, attention, o-proj,
    residual add, norm, gate/up, act, down, residual add = 11 (the
    reference's XLA layer fuses the MLP's residual add: 10). Fused: the
    fused norm+QKV+RoPE head, attention, the fused o-proj + residual, norm,
    gate/up, act, down, residual add = 8 (reference: 5). The count is by op,
    as the reference's is by XLA program: in eager torch (and its captured
    graphs) rms_norm and rope run as several elementwise kernels each.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

# the H100 SXM's dense bf16 peak; DYN_TPU_PEAK_FLOPS overrides
DEFAULT_PEAK_FLOPS = 989.4e12

# tensors of [B, hidden] (or [B, proj]) the decode layer writes to HBM and
# reads back between ops (module docstring)
UNFUSED_LAYER_BOUNDARIES = 11
FUSED_LAYER_BOUNDARIES = 8


@dataclass
class DecodeBytesBreakdown:
    weight_bytes_per_token: float
    kv_bytes_per_token: float
    kv_scale_bytes_per_token: float
    activation_bytes_per_token: float

    @property
    def total(self) -> float:
        return (
            self.weight_bytes_per_token
            + self.kv_bytes_per_token
            + self.kv_scale_bytes_per_token
            + self.activation_bytes_per_token
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total_bytes_per_token"] = self.total
        return d


def decode_hbm_bytes_per_token(
    config,
    *,
    batch: int,
    context: float,
    block_size: int = 16,
    weights_int8: bool = False,
    kv_int8: bool = False,
    fused: bool = False,
) -> DecodeBytesBreakdown:
    """Modeled HBM bytes one decode step reads/writes per emitted token.

    weights: every step streams the full dense weight set once (MoE expert
    stacks stay bf16 and are counted at 2 bytes), amortized over the B
    lanes decoding together. KV: each lane reads its live context's K+V
    pages (whole blocks, as the paged kernels DMA them) at the resident
    itemsize, plus the per-(layer, head, block) f32 scale plane when
    int8-resident. Activations: one [B, hidden] write + read per program
    boundary in the layer hot path (UNFUSED/FUSED_LAYER_BOUNDARIES).
    """
    from dynamo_tpu_torch.models.llama import param_count

    c = config
    # a dense model's count is its dense count (no config copy: the engine
    # refreshes this every decode iteration)
    dense_params = (param_count(dataclasses.replace(c, num_experts=0)) if c.num_experts
                    else param_count(c))
    expert_params = param_count(c) - dense_params
    weight_bytes = dense_params * (1 if weights_int8 else 2) + expert_params * 2
    # lm_head/embed are shared in param_count's total already

    blocks = -(-context // block_size)  # whole pages, as the kernels DMA
    kv_elems = 2 * c.num_layers * c.num_kv_heads * c.head_dim
    kv_bytes = kv_elems * blocks * block_size * (1 if kv_int8 else 2)
    kv_scale_bytes = (
        2 * c.num_layers * c.num_kv_heads * blocks * 4 if kv_int8 else 0.0
    )

    boundaries = (
        FUSED_LAYER_BOUNDARIES if fused else UNFUSED_LAYER_BOUNDARIES
    )
    # each boundary writes then reads a [B, hidden]-sized bf16 tensor;
    # per token that is 2 (w+r) * hidden * 2 bytes
    act_bytes = c.num_layers * boundaries * 2 * c.hidden_size * 2

    return DecodeBytesBreakdown(
        weight_bytes_per_token=weight_bytes / max(1, batch),
        kv_bytes_per_token=float(kv_bytes),
        kv_scale_bytes_per_token=float(kv_scale_bytes),
        activation_bytes_per_token=float(act_bytes),
    )


def mixed_step_hbm_bytes_per_token(
    config,
    *,
    decode_lanes: int,
    chunk_tokens: int,
    context: float,
    block_size: int = 16,
    weights_int8: bool = False,
    kv_int8: bool = False,
    fused: bool = False,
) -> DecodeBytesBreakdown:
    """Modeled HBM bytes per token for a unified mixed prefill+decode
    device step.

    Why mixed steps win on paper, in one number: the weight stream — the
    dominant term at small batch — is paid ONCE per device step, so
    riding `chunk_tokens` prefill tokens along the decode batch amortizes
    it over (decode_lanes + chunk_tokens) tokens instead of decode_lanes.
    A phase-separated schedule streams weights once for the decode step
    AND once for the prefill chunk; the unified step halves that traffic
    whenever both halves are non-empty. KV and activation round-trips are
    charged per decode token as in `decode_hbm_bytes_per_token` (prefill
    chunk tokens write fresh KV but read none of the live context, and
    their activations run at chunk width so the per-token boundary cost
    is the same expression).
    """
    base = decode_hbm_bytes_per_token(
        config,
        batch=max(1, decode_lanes),
        context=context,
        block_size=block_size,
        weights_int8=weights_int8,
        kv_int8=kv_int8,
        fused=fused,
    )
    tokens = max(1, decode_lanes + chunk_tokens)
    return DecodeBytesBreakdown(
        weight_bytes_per_token=base.weight_bytes_per_token
        * max(1, decode_lanes)
        / tokens,
        kv_bytes_per_token=base.kv_bytes_per_token,
        kv_scale_bytes_per_token=base.kv_scale_bytes_per_token,
        activation_bytes_per_token=base.activation_bytes_per_token,
    )


# Decomposed-collective byte accounting, in units of
# u = (tp-1)/tp * B * hidden per layer: the plain psum path all-reduces
# the o-proj and down-proj outputs in f32 (2 * 4u bytes each); the
# overlap path decomposes each into a reduce-scatter + all-gather ring —
# f32 scatter halves (4u) hidden behind the per-chunk o-proj/down-proj
# matmuls, the bf16 normed-chunk gather (2u) hidden behind the gate/up
# chunks, and only the final bf16 output gather (2u) exposed
# (ops/collective.fused_tail_overlap mirrors exactly this schedule).
_PLAIN_PSUM_UNITS = 16.0  # 2 all-reduces x 2 ring passes x 4 bytes
_OVERLAP_UNITS = 12.0  # 4+2 (o-proj) + 4+2 (down-proj)
_OVERLAP_HIDDEN_UNITS = 10.0  # all but the final output all-gather


@dataclass
class MeshedDecodeBreakdown:
    """Per-chip decode traffic under a tp mesh + the tp-axis collective
    stream (the `dyn_llm_tp_collective_bytes_per_step` gauge)."""

    per_chip: DecodeBytesBreakdown
    tp: int
    tp_collective_bytes_per_step: float
    overlap_hidden_fraction: float

    @property
    def exposed_collective_bytes_per_step(self) -> float:
        return self.tp_collective_bytes_per_step * (
            1.0 - self.overlap_hidden_fraction
        )

    def to_dict(self) -> dict:
        d = self.per_chip.to_dict()
        d.update(
            tp=self.tp,
            tp_collective_bytes_per_step=self.tp_collective_bytes_per_step,
            overlap_hidden_fraction=self.overlap_hidden_fraction,
            exposed_collective_bytes_per_step=(
                self.exposed_collective_bytes_per_step
            ),
        )
        return d


def tp_collective_bytes_per_step(
    config, *, batch: int, tp: int, overlap: bool = False
) -> tuple[float, float]:
    """(bytes, hidden_fraction) the tp axis moves per decode STEP (whole
    batch). Plain psum: two f32 all-reduces of [B, hidden] per layer,
    nothing hidden. Decomposed (DYN_COLLECTIVE_OVERLAP): fewer bytes
    (bf16 gather halves) and ~10/12 of them pipelined behind matmul
    chunks — see the unit accounting above."""
    if tp <= 1:
        return 0.0, 0.0
    u = (tp - 1) / tp * batch * config.hidden_size
    per_layer = (_OVERLAP_UNITS if overlap else _PLAIN_PSUM_UNITS) * u
    hidden = (
        _OVERLAP_HIDDEN_UNITS / _OVERLAP_UNITS if overlap else 0.0
    )
    return config.num_layers * per_layer, hidden


def meshed_decode_hbm_bytes_per_token(
    config,
    *,
    batch: int,
    context: float,
    block_size: int = 16,
    tp: int = 1,
    weights_int8: bool = False,
    kv_int8: bool = False,
    fused: bool = False,
    overlap: bool = False,
) -> MeshedDecodeBreakdown:
    """The meshed decode model: per-chip HBM bytes/token (the Megatron
    split divides weight and KV streams by tp; the replicated activation
    round-trips do not divide) plus the tp-axis collective bytes/step.
    tp=1 degenerates to `decode_hbm_bytes_per_token` exactly."""
    base = decode_hbm_bytes_per_token(
        config,
        batch=batch,
        context=context,
        block_size=block_size,
        weights_int8=weights_int8,
        kv_int8=kv_int8,
        fused=fused,
    )
    t = max(1, tp)
    per_chip = DecodeBytesBreakdown(
        weight_bytes_per_token=base.weight_bytes_per_token / t,
        kv_bytes_per_token=base.kv_bytes_per_token / t,
        kv_scale_bytes_per_token=base.kv_scale_bytes_per_token / t,
        activation_bytes_per_token=base.activation_bytes_per_token,
    )
    coll, hidden = tp_collective_bytes_per_step(
        config, batch=batch, tp=t, overlap=overlap
    )
    return MeshedDecodeBreakdown(
        per_chip=per_chip,
        tp=t,
        tp_collective_bytes_per_step=coll,
        overlap_hidden_fraction=hidden,
    )


def mfu_decode_est(
    config, tok_s_per_chip: float, peak_flops: float = DEFAULT_PEAK_FLOPS
) -> float:
    """Decode MFU estimate: 2 * params * tok/s / peak (the reference's
    formula)."""
    from dynamo_tpu_torch.models.llama import param_count

    if tok_s_per_chip <= 0 or peak_flops <= 0:
        return 0.0
    return 2.0 * param_count(config) * tok_s_per_chip / peak_flops


def peak_flops_from_env() -> float:
    """The peak the MFU gauge divides by: ``DYN_TPU_PEAK_FLOPS`` (the
    reference's name for the override), else the H100 SXM's dense bf16
    peak."""
    v = os.environ.get("DYN_TPU_PEAK_FLOPS")
    return float(v) if v else DEFAULT_PEAK_FLOPS
