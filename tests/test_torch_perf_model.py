"""The port's decode perf model and a worker's perf gauges against the JAX
package's, on the CPU.

- ``engine/torch_engine/perf_model.py`` against
  ``dynamo_tpu/engine/jax_engine/perf_model.py`` over {bf16, int8 weights} x
  {bf16, int8 KV} x {fused, unfused} x tp {1, 2, 4} x overlap, at
  Llama-3.1-8B, Mixtral-like and tiny shapes: every byte term, the collective
  bytes, the hidden fraction and the MFU (peak passed explicitly) equal to a
  relative 1e-12. The activation term is the one difference by design: the
  port counts its own decode layer's boundaries (11 unfused, 8 fused against
  the reference's 10 and 5), so it equals the reference's scaled by that
  ratio.
- The peak: the H100 SXM's dense bf16 989.4e12 by default, and the
  reference's ``DYN_TPU_PEAK_FLOPS`` overrides it.
- C16: ``TorchEngine`` and ``JaxEngine`` over the same tiny model serve the
  same greedy requests; at each refresh of their gauges (the same points in
  their loops) the live batch is the same, ``tp_collective_bytes_per_step``
  is equal and ``decode_hbm_bytes_per_token`` differs by exactly the
  documented activation term (to a relative 1e-9), at tp 1 and with both
  runners reporting tp 2. A port worker's load metrics carry the gauges and
  a typed goodput ledger.
"""

import asyncio
import dataclasses
import itertools
import types

import pytest

from dynamo_tpu.engine.jax_engine import perf_model as ref_pm
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine.torch_engine import perf_model as pm
from dynamo_tpu_torch.entrypoint.inputs import load_metrics
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.telemetry.goodput import GoodputStats
from tests.test_torch_engine import (
    MAX_NEW,
    PROMPTS,
    JaxContext,
    collect,
    jp,
    make_jax_engine,
    make_torch_engine,
    request,
    tp,
)

H100_PEAK = 989.4e12


def _configs():
    """(port config, reference config) pairs with the same fields."""
    big = tl.LlamaConfig.llama3_8b()
    moe = dataclasses.replace(big, num_layers=4, num_experts=8, num_experts_per_tok=2)
    tiny = tl.LlamaConfig.tiny(vocab_size=128)
    out = []
    for c in (big, moe, tiny):
        fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(jl.LlamaConfig)
                  if hasattr(c, f.name)}
        out.append((c, jl.LlamaConfig(**fields)))
    return out


def _close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def _act_ratio(fused: bool) -> float:
    if fused:
        return pm.FUSED_LAYER_BOUNDARIES / ref_pm.FUSED_LAYER_BOUNDARIES
    return pm.UNFUSED_LAYER_BOUNDARIES / ref_pm.UNFUSED_LAYER_BOUNDARIES


GRID = list(itertools.product((False, True), (False, True), (False, True), (1, 2, 4),
                              (False, True)))


@pytest.mark.parametrize("w8,kv8,fused,tpn,overlap", GRID,
                         ids=[f"w{'8' if a else '16'}-kv{'8' if b else '16'}-{'fused' if c else 'unfused'}"
                              f"-tp{d}{'-overlap' if e else ''}" for a, b, c, d, e in GRID])
def test_perf_model_equals_the_reference(w8, kv8, fused, tpn, overlap):
    for port_cfg, ref_cfg in _configs():
        for batch, context in ((1, 17.0), (8, 1025.0), (32, 3000.5)):
            kw = dict(batch=batch, context=context, block_size=16, weights_int8=w8,
                      kv_int8=kv8, fused=fused)
            got = pm.meshed_decode_hbm_bytes_per_token(port_cfg, tp=tpn, overlap=overlap, **kw)
            want = ref_pm.meshed_decode_hbm_bytes_per_token(ref_cfg, tp=tpn, overlap=overlap, **kw)
            g, w = got.per_chip, want.per_chip
            for name in ("weight_bytes_per_token", "kv_bytes_per_token",
                         "kv_scale_bytes_per_token"):
                assert _close(getattr(g, name), getattr(w, name), 1e-12), name
            assert _close(g.activation_bytes_per_token,
                          w.activation_bytes_per_token * _act_ratio(fused), 1e-12)
            assert _close(got.tp_collective_bytes_per_step, want.tp_collective_bytes_per_step, 1e-12)
            assert got.overlap_hidden_fraction == want.overlap_hidden_fraction
            assert _close(got.exposed_collective_bytes_per_step,
                          want.exposed_collective_bytes_per_step, 1e-12)
            assert got.tp == want.tp
            # one card: the meshed model is the plain one
            if tpn == 1:
                plain = pm.decode_hbm_bytes_per_token(port_cfg, **kw)
                assert plain.total == g.total
            # the mixed step amortizes the weights over decode lanes + chunk
            mkw = dict(decode_lanes=batch, chunk_tokens=256, context=context, block_size=16,
                       weights_int8=w8, kv_int8=kv8, fused=fused)
            mg = pm.mixed_step_hbm_bytes_per_token(port_cfg, **mkw)
            mw = ref_pm.mixed_step_hbm_bytes_per_token(ref_cfg, **mkw)
            assert _close(mg.weight_bytes_per_token, mw.weight_bytes_per_token, 1e-12)
            assert _close(mg.kv_bytes_per_token, mw.kv_bytes_per_token, 1e-12)
            # the MFU estimate, with the peak passed explicitly
            for rate in (0.0, 151.3, 2400.0):
                assert _close(pm.mfu_decode_est(port_cfg, rate, H100_PEAK),
                              ref_pm.mfu_decode_est(ref_cfg, rate, H100_PEAK), 1e-12)


def test_peak_is_the_h100s_and_the_references_override_reads(monkeypatch):
    assert pm.DEFAULT_PEAK_FLOPS == H100_PEAK
    monkeypatch.delenv("DYN_TPU_PEAK_FLOPS", raising=False)
    assert pm.peak_flops_from_env() == H100_PEAK
    monkeypatch.setenv("DYN_TPU_PEAK_FLOPS", "197e12")
    assert pm.peak_flops_from_env() == ref_pm.peak_flops_from_env() == 197e12
    cfg = tl.LlamaConfig.llama3_8b()
    # Llama-3.1-8B at 1000 tokens/s on the H100: ~1.6% of its dense peak
    assert _close(pm.mfu_decode_est(cfg, 1000.0),
                  2 * tl.param_count(cfg) * 1000.0 / H100_PEAK, 1e-12)


def _recorder(engine, set_tp):
    """Wrap ``engine._update_perf_gauges``: after each refresh record the
    live batch's context lengths and the two gauges at tp 1 and (with the
    runner reporting tp 2 for the length of one synchronous call) at tp 2."""
    orig = engine._update_perf_gauges
    rows = []

    def wrapped(*lanes):
        orig(*lanes)
        st = engine.stats
        lens = sorted(len(s.token_ids) for s in engine.slots if s is not None)
        row = [lens, st.decode_hbm_bytes_per_token, st.tp_collective_bytes_per_step]
        undo = set_tp(2)
        try:
            orig()
            row += [st.decode_hbm_bytes_per_token, st.tp_collective_bytes_per_step]
        finally:
            undo()
        orig()
        rows.append(row)

    engine._update_perf_gauges = wrapped
    return rows


def _swap(obj, name, value):
    missing = object()
    old = getattr(obj, name, missing)
    setattr(obj, name, value)

    def undo():
        if old is missing:
            delattr(obj, name)
        else:
            setattr(obj, name, old)

    return undo


async def test_a_port_worker_ships_the_jax_workers_perf_gauges():
    jeng, teng = make_jax_engine(), make_torch_engine()
    jrows = _recorder(jeng, lambda n: _swap(jeng.runner, "mesh", types.SimpleNamespace(shape={"tp": n})))
    trows = _recorder(teng, lambda n: _swap(teng.runner, "group", types.SimpleNamespace(world_size=n)))
    try:
        jres = await asyncio.gather(*(
            collect(jeng, request(jp, p, n), JaxContext()) for p, n in zip(PROMPTS, MAX_NEW)))
        tres = await asyncio.gather(*(
            collect(teng, request(tp, p, n), tp.Context()) for p, n in zip(PROMPTS, MAX_NEW)))
        assert [t for t, _, _ in tres] == [t for t, _, _ in jres]
        m = load_metrics(teng)
    finally:
        await jeng.close()
        await teng.close()
    cfg = teng.runner.config
    # the port's unfused layer writes one more [B, hidden] boundary than the
    # reference's program model: 2 (write + read) x hidden x 2 bytes a layer
    delta = (pm.UNFUSED_LAYER_BOUNDARIES - ref_pm.UNFUSED_LAYER_BOUNDARIES) * cfg.num_layers \
        * 2 * cfg.hidden_size * 2
    assert len(trows) == len(jrows) > 0
    live = 0
    for (tl_, th1, tc1, th2, tc2), (jl_, jh1, jc1, jh2, jc2) in zip(trows, jrows):
        assert tl_ == jl_  # the same batch at the same point of both loops
        if not tl_:
            continue
        live += 1
        assert _close(th1 - delta, jh1, 1e-9) and _close(th2 - delta, jh2, 1e-9)
        assert tc1 == jc1 == 0.0
        assert tc2 > 0 and _close(tc2, jc2, 1e-9)
    assert live > 0
    # the load metrics a worker publishes carry the gauges and the ledger
    ws = m.worker_stats
    assert ws.decode_hbm_bytes_per_token == teng.stats.decode_hbm_bytes_per_token > 0
    assert ws.tp_collective_bytes_per_step == teng.stats.tp_collective_bytes_per_step
    assert ws.mfu_decode_est == teng.stats.mfu_decode_est
    # the decode dispatches' tokens at their batches' modelled bytes
    assert teng.stats.modelled_decode_bytes > 0
    assert isinstance(m.goodput, GoodputStats)
    assert m.goodput.decode_tokens == teng.stats.generated_tokens == sum(MAX_NEW)
    assert m.goodput.steps_total > 0
    back = type(m).from_dict(m.to_dict())
    assert back.goodput.to_dict() == m.goodput.to_dict()
