"""C15: a dispatch that captured a graph or loaded a kernel library stays
out of the worker's ``inter_token`` histogram, on the CPU.

On the card a fresh worker's first dispatch at each shape captures a CUDA
graph (seconds); the health plane read those gaps as a gray straggler. The
runner reports its one-off costs (``warm_events``: graph captures plus
kernel libraries loaded), and a sequence whose next delivery came from a
dispatch during which they moved records no ``inter_token`` sample for
that gap (``ttft``, ``prefill`` and ``e2e`` are unchanged), nor a
``pace`` sample, the health plane's own series; the delivery
is marked ``cold`` on the wire, and a frontend's ``RemoteEngine`` leaves it
out of its first-frame and inter-frame signals. Here a runner stands in
for the card: chosen decode dispatches sleep and report a capture. The
other gaps are all observed, as the reference observes every gap
(``JaxEngine`` on the same requests), and a warmed fresh worker is not
scored gray by the port's health plane -- from its own histograms, nor
from a frontend's view of its stream -- where the same worker without the
repair is.
"""

import asyncio
import time

import jax
import numpy as np

from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.telemetry.health import HealthConfig, HealthScorer
from tests.test_torch_engine import _jax_params, make_jax_engine
from tests.test_torch_tail import _fleet

BS, NB, MAX_BATCH, MAX_LEN = 4, 64, 4, 64
PROMPTS = [[5, 9, 7, 3, 11], [6, 8, 10, 12], [13, 14, 15]]
OUT = 12


class CapturingRunner(TorchModelRunner):
    """Every decode dispatch takes at least ``step_s`` (a device's step
    time, so the CPU's noise does not decide a ratio); those numbered in
    ``cold_at`` (1-based) sleep ``cold_s`` more, as a capture does, and
    report a capture in ``warm_events`` when ``report`` is set."""

    def __init__(self, *a, cold_at=(), cold_s=0.0, report=True, step_s=0.0, cold_prefill=False,
                 **kw):
        super().__init__(*a, **kw)
        self.cold_at, self.cold_s, self.report = set(cold_at), cold_s, report
        self.step_s = step_s
        self.cold_prefill = cold_prefill  # the first packed prefill captures too
        self.decodes = 0
        self.fake_captures = 0

    @property
    def warm_events(self) -> int:
        return super().warm_events + self.fake_captures

    def decode(self, *a, **kw):
        self.decodes += 1
        time.sleep(self.step_s)
        if self.decodes in self.cold_at:
            time.sleep(self.cold_s)
            if self.report:
                self.fake_captures += 1
        return super().decode(*a, **kw)

    def prefill_packed_arrays(self, *a, **kw):
        time.sleep(self.step_s)
        if self.cold_prefill:
            self.cold_prefill = False
            time.sleep(self.cold_s)
            if self.report:
                self.fake_captures += 1
        return super().prefill_packed_arrays(*a, **kw)

    def decode_multi(self, *a, **kw):
        time.sleep(self.step_s)
        return super().decode_multi(*a, **kw)


def make_engine(horizon=1, **runner_kw):
    cfg = tl.LlamaConfig.tiny(vocab_size=128)
    params = params_from_jax(jax.tree.map(np.asarray, _jax_params()[1]), device="cpu")
    runner = CapturingRunner(cfg, params, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                             max_model_len=MAX_LEN, device="cpu", **runner_kw)
    return TorchEngine(runner, TorchEngineConfig(max_batch=MAX_BATCH, block_size=BS,
                                                 num_blocks=NB, max_model_len=MAX_LEN,
                                                 decode_horizon=horizon))


async def serve(engine, mod=tp, ctx=Context):
    async def one(prompt):
        req = mod.PreprocessedRequest(token_ids=list(prompt),
                                      sampling=mod.SamplingOptions(greedy=True),
                                      stop=mod.StopConditions(max_tokens=OUT, ignore_eos=True))
        toks = []
        async for item in engine.generate(req, ctx()):
            toks.extend(item.token_ids or [])
        return toks

    return await asyncio.gather(*(one(p) for p in PROMPTS))


def counts(engine) -> dict:
    ph = engine.stats.phase_histograms
    return {k: ph.get(k).count for k in ("ttft", "prefill", "inter_token", "e2e")}


async def test_a_capturing_dispatch_adds_no_inter_token_sample():
    warm = make_engine()
    want = await serve(warm)
    await warm.close()
    cold = make_engine(cold_at=(1, 4), cold_s=0.2)
    got = await serve(cold)
    assert got == want
    c, w = counts(cold), counts(warm)
    # the first decode dispatch delivers every lane's second token, the
    # fourth its fifth: one gap per lane each
    assert cold.stats.cold_dispatches == 2
    assert cold.stats.cold_gaps == 2 * len(PROMPTS)
    assert c["inter_token"] == w["inter_token"] - 2 * len(PROMPTS)
    assert {k: c[k] for k in ("ttft", "prefill", "e2e")} == {k: w[k] for k in ("ttft", "prefill", "e2e")}
    await cold.close()


async def test_the_other_gaps_are_observed_as_the_reference_observes_them():
    """Without a cold dispatch every gap is a sample, one per token after
    the first, as JaxEngine records them on the same requests."""
    warm = make_engine()
    await serve(warm)
    jeng = make_jax_engine()
    await serve(jeng, jp, JaxContext)
    ref = jeng.stats.phase_histograms
    got = warm.stats.phase_histograms
    assert got.get("inter_token").count == ref.get("inter_token").count == len(PROMPTS) * (OUT - 1)
    assert got.get("ttft").count == ref.get("ttft").count == len(PROMPTS)
    assert warm.stats.cold_dispatches == warm.stats.cold_gaps == 0
    await warm.close()
    await jeng.close()


async def test_a_warmed_fresh_worker_is_not_scored_gray():
    """Two workers serve the same traffic; the fresh one's first decode
    dispatches and its first prefill capture (900 ms each; a step takes at
    least 100 ms on both, so a loaded host's noise does not decide the
    ratio). With the repair the health plane scores it near the healthy
    one -- its TTFTs, all cold, are kept in ``ttft`` and left out of the
    score through ``ttft_cold`` -- and the same stalls unreported (what the
    reference records) score it a gray straggler."""
    cold_at = range(1, 8)  # 7 of the 11 decode dispatches

    async def score(report: bool) -> float:
        healthy = make_engine(step_s=0.1)
        fresh = make_engine(cold_at=cold_at, cold_s=0.9, report=report, step_s=0.1,
                            cold_prefill=True)
        await serve(healthy)
        await serve(fresh)
        scorer = HealthScorer(HealthConfig(eject_ratio=3.0))
        ttft = fresh.stats.phase_histograms.get("ttft")
        cold = fresh.stats.health_histograms.get("ttft_cold")
        assert ttft.count == len(PROMPTS)  # every TTFT kept
        assert (cold is not None and cold.count == len(PROMPTS)) == report
        for _ in range(6):
            scorer.observe_worker_hists(1, healthy.stats.phase_histograms,
                                        healthy.stats.health_histograms)
            scorer.observe_worker_hists(2, fresh.stats.phase_histograms,
                                        fresh.stats.health_histograms)
            scorer.tick()
        await healthy.close()
        await fresh.close()
        return scorer.workers[2].score

    repaired = await score(True)
    assert repaired < 3.0, repaired
    assert await score(False) >= 3.0


def test_a_cold_frame_rides_the_wire_and_the_reference_ignores_it():
    from dynamo_tpu.protocols import common as ref

    out = tp.LLMEngineOutput(token_ids=[5], cold=True)
    d = out.to_dict()
    assert d["cold"] is True and tp.LLMEngineOutput.from_dict(d).cold
    assert "cold" not in tp.LLMEngineOutput(token_ids=[5]).to_dict()
    assert ref.LLMEngineOutput.from_dict(d).token_ids == [5]  # an unknown key, ignored


async def test_a_frontend_does_not_score_a_fresh_workers_cold_frames():
    """Two workers behind a RemoteEngine with a HealthScorer (round robin,
    one stream each, in turns; a step takes at least 100 ms); the fresh
    one's last decode dispatches capture (1.5 s each), so its stream ends
    on stalls. The frames after
    them arrive ``cold`` and stay out of the scorer's inter-frame signal:
    the fresh worker's reads near the healthy one's; unreported, the same
    stalls read as a gray straggler's (over the eject ratio, 3)."""
    from dynamo_tpu_torch.discovery import RemoteEngine
    from dynamo_tpu_torch.pipeline.router import PushRouter, RouterMode

    async def score(report: bool, ns: str):
        engines = [make_engine(step_s=0.1),
                   make_engine(cold_at=(OUT - 3, OUT - 2, OUT - 1), cold_s=1.5, report=report,
                               step_s=0.1)]
        drts, services, front, client = await _fleet(ns, engines)
        scorer = HealthScorer(HealthConfig(eject_ratio=3.0))
        remote = RemoteEngine(PushRouter(client, RouterMode.ROUND_ROBIN), health=scorer)
        cold_frames = 0
        try:
            for prompt in PROMPTS[:2]:
                req = tp.PreprocessedRequest(
                    token_ids=list(prompt), sampling=tp.SamplingOptions(greedy=True),
                    stop=tp.StopConditions(max_tokens=OUT, ignore_eos=True))
                async for out in remote(req, Context()):
                    cold_frames += out.cold
            assert len(scorer.workers) == 2  # one stream on each
            # the signal the stalls reach: each worker's inter-frame EWMA
            # over the fleet's median (the lower of two); the dispatch and
            # first-frame signals are sub-millisecond noise on the CPU
            itl = sorted(v.observed("inter_frame") for v in scorer.workers.values())
            return itl[1] / itl[0], cold_frames
        finally:
            await client.close()
            for svc in services:
                await svc.stop(drain=False)
            for d in drts + [front]:
                await d.close()
            for e in engines:
                await e.close()

    repaired, cold = await score(True, "c15a")
    assert cold >= 1 and repaired < 3.0, (cold, repaired)
    unrepaired, cold = await score(False, "c15b")
    assert cold == 0 and unrepaired >= 3.0, unrepaired


async def test_a_horizons_tokens_share_its_gap():
    """Under a decode horizon of 4 one fetch delivers up to 4 tokens back
    to back. ``inter_token`` keeps the reference's samples, one a gap, so
    its median is the stream consumer's microseconds between queued tokens
    (which scored fresh workers gray); in the health plane's ``pace`` each
    token takes its share of the fetch's wait (here >= 50 ms a dispatch),
    so its median is a step's pace. Every token after the first is one
    sample of each; the frames carry their fetch."""
    engine = make_engine(horizon=4, step_s=0.05)
    fetches = []
    req = tp.PreprocessedRequest(token_ids=list(PROMPTS[0]), sampling=tp.SamplingOptions(greedy=True),
                                 stop=tp.StopConditions(max_tokens=OUT, ignore_eos=True))
    async for out in engine.generate(req, Context()):
        if out.token_ids:
            fetches.append(out.fetch)
    h = engine.stats.phase_histograms.get("inter_token")
    assert engine.stats.phase_histograms.get("pace") is None  # not a phase: the health plane's
    pace = engine.stats.health_histograms.get("pace")
    assert h.count == pace.count == OUT - 1
    assert pace.percentile(50) >= 8.0, pace.percentile(50)  # ~50 / 4 ms a token
    assert h.percentile(50) < pace.percentile(50) / 4, (h.percentile(50), pace.percentile(50))
    assert len(set(fetches)) < len(fetches)  # a horizon's tokens share a fetch
    assert fetches == sorted(fetches)
    await engine.close()



def test_a_port_worker_is_scored_on_its_pace_alone():
    """A port worker ships its health series even empty, and the scorer
    then reads its ITL from ``pace`` alone: an interval whose only new
    samples are a horizon's near-zero ``inter_token`` gaps (its delivery not
    closed yet) leaves its pace as it was, where reading those gaps would
    score its peer many times slower. A worker that ships no health series
    (the reference's) is scored on ``inter_token``."""
    from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.telemetry.histogram import PhaseHistograms

    def ship(phases, health):
        m = ForwardPassMetrics(phase_histograms=phases, health_histograms=health)
        return ForwardPassMetrics.from_dict(m.to_dict())

    empty = ship(PhaseHistograms(), PhaseHistograms())
    assert empty.health_histograms is not None and empty.health_histograms.total_count() == 0
    assert ship(PhaseHistograms(), None).health_histograms is None

    scorer = HealthScorer(HealthConfig(eject_ratio=3.0))
    phases = {w: PhaseHistograms() for w in (1, 2)}
    health = {w: PhaseHistograms() for w in (1, 2)}
    for w in (1, 2):
        for _ in range(8):
            phases[w].observe("inter_token", 0.01)
            phases[w].observe("inter_token", 50.0)
            health[w].observe("pace", 12.5)
    for _ in range(3):
        for w in (1, 2):
            m = ship(phases[w], health[w])
            scorer.observe_worker_hists(w, m.phase_histograms, m.health_histograms)
        scorer.tick()
        for _ in range(6):  # worker 2's next interval: a horizon's queued tokens only
            phases[2].observe("inter_token", 0.01)
    assert scorer.workers[1].self_itl_ms == scorer.workers[2].self_itl_ms
    assert scorer.score(1) < 1.5 and scorer.score(2) < 1.5

    ref = HealthScorer(HealthConfig(eject_ratio=3.0))
    ref.observe_worker_hists(3, phases[2])
    assert ref.workers[3].self_itl_ms < 1.0  # the reference's rule: the gaps' median


async def test_a_labels_first_dispatch_on_a_card_is_cold():
    """On a card a label's first dispatch loads torch's kernel modules and
    cuBLAS's workspaces, so it is cold like a capture (the engine turns the
    rule on for a runner on a card; here it is turned on by hand). Each
    label's first dispatch is cold once, and the gaps it held stay out of
    ``inter_token`` and ``pace``; the tokens are the same."""
    warm = make_engine()
    want = await serve(warm)
    await warm.close()
    card = make_engine()
    card._first_use_cold = True
    got = await serve(card)
    assert got == want
    labels = set(card.dispatch_first_s)
    assert "decode" in labels
    assert card.stats.cold_dispatches == len(labels)
    # the first decode dispatch delivers every lane's second token
    assert card.stats.cold_gaps >= len(PROMPTS)
    c, w = counts(card), counts(warm)
    assert c["inter_token"] == w["inter_token"] - card.stats.cold_gaps
    ttft_cold = card.stats.health_histograms.get("ttft_cold")
    assert ttft_cold is not None and ttft_cold.count == len(PROMPTS)  # the first prefill's
    await card.close()
