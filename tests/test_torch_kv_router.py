"""The port's KV-aware router against the JAX package's, on the CPU.

- The indexers: the same random store / remove / clear event streams
  (numpy seed; block size 4 and 16) into both packages' ``RadixTree``,
  ``KvIndexer``, ``ShardedKvIndexer`` and ``ApproxKvIndexer``: equal overlap
  scores (and frequencies) and per-worker block sets.
- Selection: ``KvScheduler`` / ``ActiveSequencesMultiWorker`` pick the same
  workers at temperature 0 and, under the same ``random.seed``, at 0.5.
- Twins of every case of ``tests/test_kv_router.py`` that runs no mocker
  (the pull-source ranking against the reference's ``_plan_pull``), and of
  ``tests/test_router_scale.py``'s sharded equivalence and floors.
- Events and metrics on the wire: the publishers' payloads equal
  ``msgpack.packb`` of the reference's dicts; a port worker's events feed
  the JAX ``KvRouter`` and a JAX worker's the port's.
- End to end: two f32 ``TorchEngine`` workers behind the port's
  ``ModelWatcher`` in KV mode; a shared-prefix request lands on the warm
  worker, with the SSE text of the JAX frontend over two ``JaxEngine``
  workers with the same weights. The standalone router's two cases over
  ``TorchEngine`` workers, and the recorder's round trip.
"""

import asyncio
import collections
import gc
import http.client
import json
import random
import threading
import time

import msgpack
import numpy as np
import pytest

from dynamo_tpu.discovery import register_llm as j_register_llm
from dynamo_tpu.entrypoint import inputs as j_inputs
from dynamo_tpu.fabric import FabricServer as JFabricServer
from dynamo_tpu.kv_router import indexer as j_indexer
from dynamo_tpu.kv_router import protocols as j_protocols
from dynamo_tpu.kv_router import publisher as j_publisher
from dynamo_tpu.kv_router import router as j_router
from dynamo_tpu.kv_router import scheduler as j_scheduler
from dynamo_tpu.kv_router import sequence as j_sequence
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.pipeline.router import RouterMode as JRouterMode
from dynamo_tpu_torch.discovery import register_llm
from dynamo_tpu_torch.entrypoint import inputs as t_inputs
from dynamo_tpu_torch.fabric import FabricServer, mpack
from dynamo_tpu_torch.fabric import client as t_client
from dynamo_tpu_torch.kv_router import indexer as t_indexer
from dynamo_tpu_torch.kv_router import protocols as t_protocols
from dynamo_tpu_torch.kv_router import publisher as t_publisher
from dynamo_tpu_torch.kv_router import router as t_router
from dynamo_tpu_torch.kv_router import scheduler as t_scheduler
from dynamo_tpu_torch.kv_router import sequence as t_sequence
from dynamo_tpu_torch.kv_router.indexer import (
    ApproxKvIndexer,
    KvIndexer,
    OverlapScores,
    RadixTree,
    ShardedKvIndexer,
    rank_pull_sources,
)
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    KvCacheStoredBlock,
    KvStats,
    RouterEvent,
    WorkerStats,
)
from dynamo_tpu_torch.kv_router.publisher import (
    KvEventPublisher,
    KvMetricsAggregator,
    WorkerMetricsPublisher,
    stats_key,
)
from dynamo_tpu_torch.kv_router.recorder import KvRecorder, replay
from dynamo_tpu_torch.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvRouterConfig,
    KvScheduler,
    NoEndpointsError,
    SchedulingRequest,
    softmax_sample,
)
from dynamo_tpu_torch.kv_router.sequence import ActiveSequences, ActiveSequencesMultiWorker
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.pipeline.router import RouterMode
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.router import StandaloneRouter
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.tokens import compute_seq_hash_chain
from tests.test_torch_distributed import Recording, jax_drt, port_drt, wait_models
from tests.test_torch_engine import make_jax_engine, make_torch_engine
from tests.test_torch_frontend import MODEL, afetch, summarize, write_model_dir

BS = 4  # block size of the reference's cases


@pytest.fixture(autouse=True)
def _fresh_port_fabric():
    t_client.reset_shared_state()
    yield
    t_client.reset_shared_state()


def stored(worker, hashes, parent=None, eid=0, mod=t_protocols):
    return mod.RouterEvent(worker, mod.KvCacheEvent.stored_event(
        eid, parent, [mod.KvCacheStoredBlock(h) for h in hashes]))


def _count_nodes(node):
    return 1 + sum(_count_nodes(c) for c in node.children.values())


def _overlap(scores: dict, mod=t_indexer):
    ov = mod.OverlapScores()
    ov.scores.update(scores)
    return ov


# ------------------------------------------- indexers on random event streams


def random_event_stream(seed: int, bs: int, n_workers: int = 5, n_events: int = 400):
    """(event dicts, query chains): stores that extend a worker's chains or
    start new ones from shared and private prefixes, removes of held and
    unknown blocks, and clears, as a fleet's workers would emit them."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, 50, size=bs * int(rng.integers(1, 6)))) for _ in range(6)]
    held: dict[int, list[list[int]]] = {w: [] for w in range(n_workers)}
    events, queries = [], []
    for eid in range(n_events):
        w = int(rng.integers(n_workers))
        r = rng.random()
        if r < 0.6:
            base = prefixes[int(rng.integers(len(prefixes)))] if rng.random() < 0.6 else []
            tokens = [int(t) for t in base] + [int(t) for t in rng.integers(0, 50, size=bs * int(rng.integers(1, 5)))]
            chain = compute_seq_hash_chain(tokens, bs)
            cut = int(rng.integers(0, len(chain)))
            parent = chain[cut - 1] if cut else None
            events.append({"worker_id": w, "event": {"event_id": eid, "parent_hash": parent,
                                                     "stored": [{"block_hash": h} for h in chain[cut:]]}})
            held[w].append(chain)
            queries.append(tokens)
        elif r < 0.9:
            chains = held[w]
            if chains:
                chain = chains[int(rng.integers(len(chains)))]
                k = int(rng.integers(1, len(chain) + 1))
                gone = [chain[-i] for i in range(1, k + 1)] + [int(rng.integers(1 << 60))]
            else:
                gone = [int(rng.integers(1 << 60))]
            events.append({"worker_id": w, "event": {"event_id": eid, "removed": gone}})
        elif r < 0.96:
            events.append({"worker_id": w, "event": {"event_id": eid, "cleared": True}})
            held[w] = []
    return events, queries


def _block_sets(tree) -> dict:
    return {w: set(t) for w, t in tree.lookup.items()}


@pytest.mark.parametrize("bs", [4, 16])
def test_radix_tree_and_indexers_equal_the_reference_on_random_streams(bs):
    events, queries = random_event_stream(bs, bs)
    now = [100.0]
    clock = lambda: now[0]  # noqa: E731 - one virtual clock for both packages
    ref = {"tree": j_indexer.RadixTree(60.0, now_fn=clock),
           "kv": j_indexer.KvIndexer(bs, 60.0, now_fn=clock),
           "sharded": j_indexer.ShardedKvIndexer(bs, 3, 60.0, now_fn=clock)}
    port = {"tree": RadixTree(60.0, now_fn=clock), "kv": KvIndexer(bs, 60.0, now_fn=clock),
            "sharded": ShardedKvIndexer(bs, 3, 60.0, now_fn=clock)}
    for i, d in enumerate(events):
        for name in ref:
            ref[name].apply_event(j_protocols.RouterEvent.from_dict(d))
            port[name].apply_event(RouterEvent.from_dict(d))
        if i % 20 == 19:
            now[0] += 7.0
            for q in queries[-5:]:
                chain = compute_seq_hash_chain(q, bs)
                for name in ref:
                    a, b = ref[name].find_matches(chain), port[name].find_matches(chain)
                    assert (b.scores, b.frequencies) == (a.scores, a.frequencies), name
    assert _block_sets(port["tree"]) == _block_sets(ref["tree"])
    assert _count_nodes(port["tree"].root) == _count_nodes(ref["tree"].root)
    assert port["kv"].block_counts() == {w: len(s) for w, s in _block_sets(ref["kv"].tree).items()}
    for q in queries:
        a = ref["kv"].find_matches_for_request(q)
        assert port["kv"].find_matches_for_request(q).scores == a.scores
        assert port["sharded"].find_matches_for_request(q).scores == a.scores
    for w in (0, 3):
        ref["sharded"].remove_worker(w)
        port["sharded"].remove_worker(w)
    for q in queries:
        chain = compute_seq_hash_chain(q, bs)
        assert port["sharded"].find_matches(chain).scores == ref["sharded"].find_matches(chain).scores


@pytest.mark.parametrize("bs", [4, 16])
def test_approx_indexer_equals_the_reference(bs):
    _, queries = random_event_stream(100 + bs, bs)
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    ref, port = j_indexer.ApproxKvIndexer(bs, ttl=5.0, now_fn=clock), ApproxKvIndexer(bs, ttl=5.0, now_fn=clock)
    rng = random.Random(bs)
    for i, q in enumerate(queries):
        w = rng.randrange(4)
        ref.process_routing_decision_for_request(q, w)
        port.process_routing_decision_for_request(q, w)
        now[0] += 0.3
        probe = queries[rng.randrange(i + 1)]
        assert port.find_matches_for_request(probe).scores == ref.find_matches_for_request(probe).scores
        if i % 17 == 16:
            ref.remove_worker(w)
            port.remove_worker(w)
    assert _block_sets(port.tree) == _block_sets(ref.tree)


# ----------------------------------------------------------------- selection


def test_scheduler_picks_the_reference_workers_at_temperature_0_and_seeded():
    bs = 4
    events, queries = random_event_stream(7, bs, n_workers=4)
    for temp in (0.0, 0.5):
        picks = {}
        for name, ix_mod, sc_mod, pr_mod in (("ref", j_indexer, j_scheduler, j_protocols),
                                             ("port", t_indexer, t_scheduler, t_protocols)):
            ix = ix_mod.KvIndexer(bs)
            for d in events[:200]:
                ix.apply_event(pr_mod.RouterEvent.from_dict(d))
            cfg = sc_mod.KvRouterConfig(router_temperature=temp, overlap_score_weight=1.5)
            if name == "ref":
                cfg.prefix_pull = False
            sched = sc_mod.KvScheduler(bs, sc_mod.DefaultWorkerSelector(cfg), config=cfg)
            sched.update_workers([0, 1, 2, 3])
            random.seed(1234)
            out = []
            for i, q in enumerate(queries[:120]):
                r = sched.schedule(q, ix.find_matches_for_request(q), request_id=f"r{i}")
                out.append((r.worker_id, r.required_blocks, r.overlap_blocks, r.fleet_blocks))
                if i % 3 == 2:
                    sched.free(f"r{i - 1}")
            picks[name] = (out, sched.sequences.active_blocks(), dict(sched.hit_stats))
        assert picks["port"] == picks["ref"], temp


def test_active_sequences_equal_the_reference():
    rng = random.Random(3)
    ref, port = j_sequence.ActiveSequencesMultiWorker(4, [1, 2, 3]), ActiveSequencesMultiWorker(4, [1, 2, 3])
    rids = []
    for i in range(200):
        toks = [rng.randrange(20) for _ in range(rng.randrange(1, 40))]
        if rng.random() < 0.6 or not rids:
            w, rid = rng.choice([1, 2, 3, 4]), f"q{i}"
            ref.add_request(w, toks, rid)
            port.add_request(w, toks, rid)
            rids.append(rid)
        else:
            rid = rids.pop(rng.randrange(len(rids)))
            ref.free(rid)
            port.free(rid)
        if i == 120:
            ref.update_workers([2, 3, 4])
            port.update_workers([2, 3, 4])
        assert port.potential_blocks(toks) == ref.potential_blocks(toks)
        assert port.active_blocks() == ref.active_blocks()


# -------------------------------------- twins of tests/test_kv_router.py cases


def test_radix_store_and_match():
    t = RadixTree()
    t.apply_event(stored(1, [10, 11, 12]))
    t.apply_event(stored(2, [10, 11]))
    assert t.find_matches([10, 11, 12, 13]).scores == {1: 3, 2: 2}
    assert t.find_matches([99]).scores == {}


def test_radix_store_under_parent_and_remove():
    t = RadixTree()
    t.apply_event(stored(1, [10, 11]))
    t.apply_event(stored(1, [12], parent=11))
    assert t.find_matches([10, 11, 12]).scores == {1: 3}
    t.apply_event(RouterEvent(1, KvCacheEvent.removed_event(1, [12])))
    assert t.find_matches([10, 11, 12]).scores == {1: 2}
    t.apply_event(stored(1, [55], parent=404))  # unknown parent: dropped
    assert t.find_matches([55]).scores == {}


def test_radix_removal_detaches_nodes():
    t = RadixTree()
    for i in range(50):
        base = 1000 * i
        t.apply_event(stored(1, [base, base + 1, base + 2], eid=i))
    assert _count_nodes(t.root) == 1 + 150
    for i in range(50):
        base = 1000 * i
        t.apply_event(RouterEvent(1, KvCacheEvent.removed_event(100 + i, [base, base + 1, base + 2])))
    assert _count_nodes(t.root) == 1
    t2 = RadixTree()
    t2.apply_event(stored(1, [1, 2, 3]))
    t2.remove_worker(1)
    assert _count_nodes(t2.root) == 1


def test_radix_remove_worker_and_clear():
    t = RadixTree()
    t.apply_event(stored(1, [1, 2, 3]))
    t.apply_event(stored(2, [1, 2]))
    t.remove_worker(1)
    assert t.find_matches([1, 2, 3]).scores == {2: 2}
    t.apply_event(RouterEvent(2, KvCacheEvent.cleared_event(5)))
    assert t.find_matches([1, 2]).scores == {}


def test_radix_shared_block_removal_keeps_other_worker():
    t = RadixTree()
    t.apply_event(stored(1, [7, 8]))
    t.apply_event(stored(2, [7, 8]))
    t.apply_event(RouterEvent(1, KvCacheEvent.removed_event(0, [8])))
    assert t.find_matches([7, 8]).scores == {1: 1, 2: 2}


def test_radix_worker_churn_empties_jump_table():
    t = RadixTree()
    t.apply_event(stored(1, [10, 11, 12]))
    t.apply_event(stored(2, [10, 11]))
    t.remove_worker(1)
    assert t.worker_block_count(1) == 0 and 1 not in t.workers()
    assert t.find_matches([10, 11, 12]).scores == {2: 2}
    assert _count_nodes(t.root) == 1 + 2
    t.apply_event(RouterEvent(2, KvCacheEvent.cleared_event(9)))
    assert t.worker_block_count(2) == 0
    assert _count_nodes(t.root) == 1


def test_radix_reregistered_worker_does_not_resurrect_stale_offers():
    t = RadixTree()
    t.apply_event(stored(1, [10, 11, 12]))
    t.remove_worker(1)
    assert t.find_matches([10, 11, 12]).scores == {}
    t.apply_event(stored(1, [12], parent=11, eid=1))
    assert t.find_matches([10, 11, 12]).scores == {}
    assert t.worker_block_count(1) == 0
    t.apply_event(RouterEvent(1, KvCacheEvent.removed_event(2, [10])))
    t.apply_event(stored(1, [20, 21], eid=3))
    assert t.find_matches([20, 21]).scores == {1: 2}
    assert _count_nodes(t.root) == 1 + 2


def test_pull_plan_source_ranking_live_over_suspect_over_dead():
    """``rank_pull_sources`` ranks as the reference's ``_plan_pull`` does:
    healthy holders before SUSPECT ones before dead ones; its first is the
    reference plan's source, on the reference case and on random ones."""
    ranked = rank_pull_sources(_overlap({2: 6, 3: 6, 9: 8}), routed=1, required_blocks=8,
                               routed_blocks=0, live={1, 2, 3}, suspects={3})
    assert ranked == [2, 3, 9]
    ref = j_scheduler.KvScheduler(block_size=BS, config=j_scheduler.KvRouterConfig(
        prefix_pull=True, prefix_pull_min_blocks=1))
    rng = random.Random(5)
    for _ in range(300):
        scores = {w: rng.randrange(0, 10) for w in rng.sample(range(8), rng.randrange(1, 7))}
        routed, req = rng.randrange(8), rng.randrange(1, 10)
        routed_blocks = min(scores.get(routed, 0), req)
        live = set(rng.sample(range(8), rng.randrange(1, 8))) | {routed}
        suspects = {w for w in live if rng.random() < 0.3}
        fleet = min(req, max(scores.values()))
        plan = ref._plan_pull(
            result=j_scheduler.WorkerSelectionResult(worker_id=routed, required_blocks=req,
                                                     overlap_blocks=routed_blocks, fleet_blocks=fleet),
            overlap=_overlap(scores, j_indexer), chain=list(range(req)), live=live,
            health_factors={w: 2.0 for w in suspects})
        ranked = rank_pull_sources(_overlap(scores), routed, req, routed_blocks, live, suspects)
        assert (ranked[0] if ranked else None) == (plan["src"] if plan else None)


def test_indexer_token_api():
    ix = KvIndexer(block_size=BS)
    tokens = list(range(12))
    ix.apply_event(stored(3, compute_seq_hash_chain(tokens, BS)))
    assert ix.find_matches_for_request(tokens + [100, 101]).scores == {3: 3}


def test_approx_indexer_ttl():
    ix = ApproxKvIndexer(block_size=BS, ttl=0.05)
    tokens = list(range(8))
    ix.process_routing_decision_for_request(tokens, worker_id=9)
    assert ix.find_matches_for_request(tokens).scores == {9: 2}
    time.sleep(0.08)
    assert ix.find_matches_for_request(tokens).scores == {}


def test_softmax_sample_temperature_zero_argmin():
    rng = random.Random(0)
    for _ in range(10):
        assert softmax_sample({1: 5.0, 2: 1.0, 3: 3.0}, 0.0, rng) == 2
    with pytest.raises(NoEndpointsError):
        softmax_sample({}, 0.0)


def test_softmax_sample_prefers_lower_logit():
    rng = random.Random(42)
    picks = [softmax_sample({1: 10.0, 2: 0.5}, 0.5, rng) for _ in range(200)]
    assert picks.count(2) > picks.count(1)


def test_default_selector_cost_function():
    sel = DefaultWorkerSelector(KvRouterConfig(overlap_score_weight=1.0, router_temperature=0.0))
    req = SchedulingRequest(isl_tokens=8 * BS, overlap=OverlapScores(scores={1: 6}),
                            potential_blocks={1: 20, 2: 10})
    assert sel.select_worker([1, 2], req, BS).worker_id == 2  # 22 vs 18
    sel10 = DefaultWorkerSelector(KvRouterConfig(overlap_score_weight=10.0, router_temperature=0.0))
    assert sel10.select_worker([1, 2], req, BS).worker_id == 1  # 40 vs 90


def test_scheduler_tracks_load_and_frees():
    sched = KvScheduler(block_size=BS)
    sched.update_workers([1, 2])
    tokens = list(range(4 * BS))
    r1 = sched.schedule(tokens, OverlapScores(), request_id="r1")
    loads = sched.sequences.active_blocks()
    other = 2 if r1.worker_id == 1 else 1
    assert loads[r1.worker_id] > 0 and loads[other] == 0
    sched2 = KvScheduler(block_size=BS, selector=DefaultWorkerSelector(KvRouterConfig(router_temperature=0.0)))
    sched2.update_workers([1, 2])
    first = sched2.schedule(tokens, OverlapScores(), request_id="a")
    second = sched2.schedule(tokens, OverlapScores(), request_id="b")
    assert second.worker_id != first.worker_id
    sched2.free("a")
    sched2.free("b")
    assert all(v == 0 for v in sched2.sequences.active_blocks().values())


def test_active_sequences_shared_prefix_counts_once():
    seqs = ActiveSequences(block_size=BS)
    seqs.add_request("a", [1, 2, 3], partial_blocks=1)
    assert seqs.active_blocks == 4
    assert seqs.new_blocks([1, 2, 4], partial=1) == 2
    seqs.add_request("b", [1, 2, 4], partial_blocks=1)
    assert seqs.active_blocks == 6
    seqs.free("a")
    assert seqs.active_blocks == 4
    seqs.free("b")
    assert seqs.active_blocks == 0


def test_multi_worker_churn_drops_state():
    mw = ActiveSequencesMultiWorker(BS, [1, 2])
    rid = mw.add_request(1, list(range(8)))
    assert mw.active_blocks()[1] > 0
    mw.update_workers([2, 3])
    assert set(mw.active_blocks()) == {2, 3}
    mw.free(rid)


async def test_metrics_publisher_and_aggregator():
    drt = await DistributedRuntime.detached()
    try:
        component = drt.namespace("test").component("mock")
        eid = component.endpoint("generate").id
        pub = WorkerMetricsPublisher(component, eid, 0xAB, interval_s=0.02)
        pub.publish(ForwardPassMetrics(worker_stats=WorkerStats(request_active_slots=3),
                                       kv_stats=KvStats(kv_active_blocks=17, kv_total_blocks=100)))
        await pub.start()
        await asyncio.sleep(0.08)
        agg = KvMetricsAggregator(component, eid)
        per_worker = await agg.collect()
        assert per_worker[0xAB].kv_stats.kv_active_blocks == 17
        assert (await agg.aggregate()).worker_stats.request_active_slots == 3
        await pub.stop()
    finally:
        await drt.close()


async def test_recorder_roundtrip(tmp_path):
    path = tmp_path / "events.jsonl"
    tokens = list(range(8))
    chain = compute_seq_hash_chain(tokens, BS)
    with KvRecorder(path) as rec:
        rec.record(stored(5, chain))
        rec.record(RouterEvent(5, KvCacheEvent.removed_event(1, [chain[1]])))
    ix = KvIndexer(block_size=BS)
    assert await replay(path, ix.apply_event) == 2
    assert ix.find_matches_for_request(tokens).scores == {5: 1}
    # the reference replays the port's recording, and the port the reference's
    from dynamo_tpu.kv_router.recorder import KvRecorder as JKvRecorder
    from dynamo_tpu.kv_router.recorder import replay as j_replay

    jix = j_indexer.KvIndexer(block_size=BS)
    assert await j_replay(path, jix.apply_event) == 2
    assert jix.find_matches_for_request(tokens).scores == {5: 1}
    jpath = tmp_path / "ref.jsonl"
    with JKvRecorder(jpath) as rec:
        rec.record(stored(6, chain, mod=j_protocols))
    ix2 = KvIndexer(block_size=BS)
    assert await replay(jpath, ix2.apply_event) == 1
    assert ix2.find_matches_for_request(tokens).scores == {6: 2}


# ------------------------------------ twins of tests/test_router_scale.py


def _scale_events(workers, chains_per_worker, chain_blocks=32, seed=0):
    rng = random.Random(seed)
    chains, events = [], []
    for w in range(workers):
        for _ in range(chains_per_worker):
            half = chain_blocks // 2
            if rng.random() < 0.25:
                pid = rng.randrange(20)
                prefix = [hash((pid, i)) & 0x7FFFFFFF for i in range(half)]
            else:
                prefix = [rng.randrange(1 << 48) for _ in range(half)]
            chain = prefix + [rng.randrange(1 << 48) for _ in range(chain_blocks - half)]
            chains.append(chain)
            events.append(stored(w, chain, eid=len(events)))
    return chains, events


def test_sharded_matches_single_tree():
    chains, events = _scale_events(workers=16, chains_per_worker=20)
    single = KvIndexer(16, expiration_duration=60.0)
    sharded = ShardedKvIndexer(16, num_shards=4, expiration_duration=60.0)
    for ev in events:
        single.apply_event(ev)
        sharded.apply_event(ev)
    rng = random.Random(1)
    for _ in range(200):
        chain = chains[rng.randrange(len(chains))]
        s, sh = single.find_matches(chain), sharded.find_matches(chain)
        assert (sh.scores, sh.frequencies) == (s.scores, s.frequencies)
    single.remove_worker(3)
    sharded.remove_worker(3)
    for _ in range(100):
        chain = chains[rng.randrange(len(chains))]
        s, sh = single.find_matches(chain), sharded.find_matches(chain)
        assert sh.scores == s.scores and 3 not in sh.scores


def test_indexer_scale_floors():
    """The reference's reduced-load floors: 16 workers x ~10k blocks."""
    chains, events = _scale_events(workers=16, chains_per_worker=20)
    blocks = len(events) * 32
    rate = 0.0
    for _ in range(2):
        gc.collect()
        idx = KvIndexer(16)
        t0 = time.perf_counter()
        for ev in events:
            idx.apply_event(ev)
        rate = max(rate, blocks / (time.perf_counter() - t0))
    assert rate > 20_000, f"ingest too slow: {rate:.0f}/s"
    rng = random.Random(2)
    lat = []
    for _ in range(500):
        chain = chains[rng.randrange(len(chains))]
        t = time.perf_counter()
        idx.find_matches(chain)
        lat.append(time.perf_counter() - t)
    lat.sort()
    assert lat[int(0.99 * len(lat))] < 2e-3


def test_scheduler_scale_floor():
    chains, events = _scale_events(workers=16, chains_per_worker=20)
    idx = KvIndexer(16)
    for ev in events:
        idx.apply_event(ev)
    sched = KvScheduler(16)
    sched.update_workers(list(range(16)))
    rng = random.Random(3)
    lat = []
    for i in range(300):
        chain = chains[rng.randrange(len(chains))]
        tokens = list(range(len(chain) * 16))
        overlap = idx.find_matches(chain)
        t = time.perf_counter()
        sched.schedule(tokens, overlap, request_id=str(i), chain=chain)
        lat.append(time.perf_counter() - t)
        if i % 2:
            sched.free(str(i))
    lat.sort()
    assert lat[int(0.99 * len(lat))] < 5e-3


# ------------------------------------------------------ events on the wire


class _Recorder:
    """A component whose namespace records what is published on it."""

    def __init__(self):
        self.published = []
        self.namespace = self

    async def publish_event(self, subject, data):
        self.published.append((subject, data))


async def test_event_and_metric_payloads_are_the_reference_bytes():
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(30):
        toks = [int(t) for t in rng.integers(0, 100, size=4 * int(rng.integers(1, 6)))]
        chain = compute_seq_hash_chain(toks, 4)
        parents = [0] + chain[:-1]
        blocks = [{"block_hash": h, "parent_hash": p, "tokens": toks[4 * i:4 * i + 4], "block_id": i}
                  for i, (h, p) in enumerate(zip(chain, parents))]
        if len(blocks) > 2 and rng.random() < 0.5:
            del blocks[1]  # a batch that skips an already-published block
        batches.append(blocks)
    ref_c, port_c = _Recorder(), _Recorder()
    ref, port = j_publisher.KvEventPublisher(ref_c, 0x1F), KvEventPublisher(port_c, 0x1F)
    for blocks in batches:
        ref.on_blocks_stored(blocks)
        port.on_blocks_stored(blocks)
        ref.on_blocks_removed([b["block_hash"] for b in blocks[:1]])
        port.on_blocks_removed([b["block_hash"] for b in blocks[:1]])
    ref.publish_cleared()
    port.publish_cleared()
    await asyncio.sleep(0)
    await ref.drain()
    await port.drain()
    assert len(port_c.published) == len(ref_c.published) > 60
    for (ps, pd), (rs, rd) in zip(port_c.published, ref_c.published):
        assert ps == rs == "kv_events"
        assert mpack.packb(pd) == msgpack.packb(rd, use_bin_type=True)
    # the load metrics' dict, with the JAX package's pass-through fields
    ref_m = j_protocols.ForwardPassMetrics(
        worker_stats=j_protocols.WorkerStats(request_active_slots=3, request_total_slots=8,
                                             num_requests_waiting=2, num_deadline_exceeded=1,
                                             integrity_failures_by_path={"tier_host": 1}),
        kv_stats=j_protocols.KvStats(kv_active_blocks=17, kv_total_blocks=63, gpu_cache_usage_perc=17 / 63),
        spec_decode_stats=j_protocols.SpecDecodeStats(num_spec_tokens=3, num_drafts=4, num_draft_tokens=9,
                                                      num_accepted_tokens=5,
                                                      num_accepted_tokens_per_pos=[3, 2, 0]),
        kv_transfer_stats=j_protocols.KvTransferStats(kv_frames_rx=4, kv_wire_bytes_rx=1024))
    d = ref_m.to_dict()
    d["stamp"] = {"iid": 5, "ep": 7}
    port_m = ForwardPassMetrics.from_dict(msgpack.unpackb(msgpack.packb(d), raw=False))
    pd = port_m.to_dict()
    pd["stamp"] = {"iid": 5, "ep": 7}
    assert mpack.packb(pd) == msgpack.packb(d, use_bin_type=True)
    # the reference's phase histograms read back typed, to the same wire
    # dict; its goodput dict passes through unchanged
    from dynamo_tpu.telemetry.histogram import PhaseHistograms as JPhaseHistograms

    jph = JPhaseHistograms()
    for v in (0.3, 12.5, 80.0, 80.0, 4000.0):
        jph.observe("ttft", v)
    jph.observe("inter_token", 9.75)
    passthrough = {**ref_m.to_dict(), "phase_histograms": jph.to_dict(), "goodput": {"steps": 4}}
    back = ForwardPassMetrics.from_dict(passthrough)
    assert back.phase_histograms.phases["ttft"].count == 5
    assert back.to_dict() == passthrough


async def _serve_worker(drt, engine, pub_mod, namespace="kv", component="backend"):
    ep = drt.namespace(namespace).component(component).endpoint("generate")
    handler = (t_inputs.make_engine_handler(engine) if pub_mod is t_publisher
               else j_inputs.make_engine_handler(engine))
    svc = await ep.serve_endpoint(handler)
    pub = pub_mod.KvEventPublisher(ep.component, svc.instance_id)
    inner = getattr(engine, "engine", engine)
    inner.on_blocks_stored = pub.on_blocks_stored
    inner.on_blocks_removed = pub.on_blocks_removed
    return ep, svc


def slowed(engine, seconds: float = 0.02):
    """Each device call of a TorchEngine (or a JaxEngine) takes ``seconds``
    longer, so a leader on the CPU stays live (its blocks indexed) while its
    followers are routed: the tiny model's 20 tokens would otherwise be done
    in milliseconds. ``engine.dispatches`` counts the calls by label."""
    engine.dispatches = collections.Counter()
    if hasattr(engine, "_dispatch"):  # JaxEngine._dispatch(label, fn, **kw)
        dispatch = engine._dispatch

        async def _slow_dispatch(label, fn, **kw):
            engine.dispatches[label] += 1
            await asyncio.sleep(seconds)
            return await dispatch(label, fn, **kw)

        engine._dispatch = _slow_dispatch
        return engine
    device = engine._device

    async def _slow(fn, label):
        engine.dispatches[label] += 1
        await asyncio.sleep(seconds)
        return await device(fn, label)

    engine._device = _slow
    return engine


def _request(mod, prompt, max_tokens):
    return mod.PreprocessedRequest(token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
                                   stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))


async def _hold_open(client, req, worker_id, ctx, first: asyncio.Event):
    """Stream ``req`` from one worker, setting ``first`` at its first token."""
    stream = await client.direct(req.to_dict(), worker_id, ctx)
    n = 0
    async for item in stream:
        if item.data and item.data.get("token_ids"):
            n += 1
            first.set()
    return n


async def test_events_cross_packages_into_either_kv_router():
    """A port worker's KV events feed the JAX package's KvRouter, and a JAX
    worker's feed the port's, over one fabric server: each router names
    the worker holding the live prompt's prefix."""
    from dynamo_tpu.kv_router.router import KvRouter as JKvRouter
    from dynamo_tpu.protocols import common as jp

    prompt = [7 + i % 50 for i in range(40)]
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    tdrts = [await port_drt(server.addr) for _ in range(2)]
    jdrts = [await jax_drt(server.addr) for _ in range(2)]
    engines = [slowed(make_torch_engine()), make_jax_engine()]
    try:
        for ns, worker_drt, router_drt, engine, pub_mod, router_cls, proto, ctx_cls in (
                ("to_jax", tdrts[0], jdrts[0], engines[0], t_publisher, JKvRouter, tp, Context),
                ("to_port", jdrts[1], tdrts[1], engines[1], j_publisher, t_router.KvRouter, jp, JContext)):
            ep, svc = await _serve_worker(worker_drt, engine, pub_mod, namespace=ns)
            other_ep = router_drt.namespace(ns).component("backend").endpoint("generate")
            client = await other_ep.client()
            await client.wait_for_instances(5.0)
            router = router_cls(other_ep.component, client, block_size=BS,
                                config=(j_scheduler if router_cls is JKvRouter else t_scheduler
                                        ).KvRouterConfig(router_temperature=0.0))
            await router.start()
            first = asyncio.Event()
            wclient = await ep.client()
            task = asyncio.ensure_future(_hold_open(wclient, _request(proto, prompt, 20), svc.instance_id,
                                                    ctx_cls(), first))
            await asyncio.wait_for(first.wait(), 10)
            for _ in range(100):
                wid, overlap = await router.find_best_match(prompt + [1, 2, 3])
                if overlap:
                    break
                await asyncio.sleep(0.02)
            assert (wid, overlap) == (svc.instance_id, len(prompt) // BS)
            assert await task == 20
            await router.close()
            await client.close()
            await wclient.close()
    finally:
        for drt in tdrts + jdrts:
            await drt.close()
        for e in engines:
            await e.close()
        await server.close()


# -------------------------------------------------------------- end to end


def _stream_marking_first(port: int, body: dict, first: threading.Event) -> tuple[int, bytes]:
    """A streamed completion over http.client; ``first`` is set when its
    first token chunk arrives."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = b""
        while True:
            line = resp.readline()
            if not line:
                return resp.status, data
            data += line
            if line.startswith(b"data: {") and b'"text": ""' not in line:
                first.set()
    finally:
        first.set()
        conn.close()


async def _warm_then_follow(port: int, prefix: str, follow: str, log: list, tags: list):
    """Stream a long greedy completion of ``prefix``; once its first token
    arrives (its Stored events went out with its prefill), send ``prefix +
    follow``. Returns both texts; ``tags`` gets the workers (log tags) that
    served them."""
    leader = {"model": MODEL, "prompt": prefix, "max_tokens": 16, "stream": True,
              "temperature": 0, "nvext": {"ignore_eos": True}}
    follower = {"model": MODEL, "prompt": prefix + follow, "max_tokens": 6, "stream": True,
                "temperature": 0}
    log.clear()
    first = threading.Event()
    lead = asyncio.ensure_future(asyncio.to_thread(_stream_marking_first, port, leader, first))
    await asyncio.to_thread(first.wait, 60)
    await asyncio.sleep(0.1)  # the events cross the fabric to the router
    st_f, _, data_f = await afetch(port, "POST", "/v1/completions", follower)
    st_l, data_l = await lead
    assert st_l == st_f == 200
    tags.append(list(log))
    return (summarize(st_l, data_l, True)["choices"][0]["text"],
            summarize(st_f, data_f, True)["choices"][0]["text"])


async def test_kv_frontend_routes_a_shared_prefix_to_the_warm_worker_as_the_jax_frontend(tmp_path):
    from dynamo_tpu import model_card as j_card
    from dynamo_tpu_torch import model_card as t_card
    from dynamo_tpu.kv_router.scheduler import KvRouterConfig as JKvRouterConfig

    model_dir = write_model_dir(tmp_path / "m")
    ref_mdc = j_card.ModelDeploymentCard.from_model_dir(model_dir, MODEL, kv_block_size=BS)
    port_mdc = t_card.ModelDeploymentCard.from_model_dir(model_dir, MODEL, kv_block_size=BS)
    jserver, tserver = JFabricServer("127.0.0.1", 0), FabricServer("127.0.0.1", 0)
    await jserver.start()
    await tserver.start()
    jdrts = [await jax_drt(jserver.addr) for _ in range(3)]
    tdrts = [await port_drt(tserver.addr) for _ in range(3)]
    jengines = [make_jax_engine(), make_jax_engine()]
    tengines = [slowed(make_torch_engine()), slowed(make_torch_engine())]
    log_j, log_t = [], []
    jsvc = tsvc = None
    try:
        for drts, engines, log, pub_mod, mdc, register in (
                (jdrts, jengines, log_j, j_publisher, ref_mdc, j_register_llm),
                (tdrts, tengines, log_t, t_publisher, port_mdc, register_llm)):
            for i, (drt, engine) in enumerate(zip(drts[:2], engines)):
                rec = Recording(engine, i, log)
                ep, svc = await _serve_worker(drt, rec, pub_mod, namespace="dynamo")
                await register(drt, ep, mdc)
        jsvc = await j_inputs.run_http(jdrts[2], j_inputs.EngineConfig.dynamic(
            JRouterMode.KV, kv_router_config=JKvRouterConfig(router_temperature=0.0, prefix_pull=False)),
            host="127.0.0.1", port=0)
        tsvc = await t_inputs.run_http(t_inputs.EngineConfig.dynamic(
            RouterMode.KV, kv_router_config=KvRouterConfig(router_temperature=0.0)),
            host="127.0.0.1", port=0, drt=tdrts[2])
        await wait_models(jsvc.port)
        await wait_models(tsvc.port)
        prefix = " ".join(["the quick brown fox jumps over the lazy dog"] * 3)
        texts, tags = {}, {"jax": [], "port": []}
        for k, follow in enumerate([" one two", " three four five", " six"]):
            for name, svc, log in (("jax", jsvc, log_j), ("port", tsvc, log_t)):
                texts.setdefault(name, []).append(
                    await _warm_then_follow(svc.port, prefix.replace("quick", f"w{k}"), follow, log,
                                            tags[name]))
        assert texts["port"] == texts["jax"]
        # every follower on its leader's worker (the JAX frontend's router
        # also weighs its health scorer's latency samples, which the port
        # leaves to A10 part 2, so only the texts are held against it)
        assert all(len(served) == 2 and served[0] == served[1] for served in tags["port"]), tags
        router = tsvc.watcher.kv_routers["dyn://dynamo.backend.generate"]
        assert router.scheduler.hit_stats["decisions"] == 6
        # each follower found the 6 full blocks of its 27-word prefix cached
        assert router.scheduler.hit_stats["matched_blocks"] >= 3 * 6
        for _ in range(100):  # every stream ended: the Removed events empty the index
            if not any(router.indexer.block_counts().values()):
                break
            await asyncio.sleep(0.02)
        assert not any(router.indexer.block_counts().values())
        assert all(e.allocator.free_count == e.config.num_blocks - 1 for e in tengines)
    finally:
        for svc in (jsvc, tsvc):
            if svc:
                await svc.close()
        if tsvc:
            await tsvc.watcher.stop()
        for drt in jdrts + tdrts:
            await drt.close()
        for e in jengines + tengines:
            await e.close()
        await jserver.close()
        await tserver.close()


# ------------------------------- twins of tests/test_standalone_router.py


async def _ask(finder, body):
    stream = await finder.direct(body, finder.instance_ids()[0], Context())
    async for item in stream:
        return item.data


async def test_standalone_router_serves_decisions():
    drt = await DistributedRuntime.detached()
    wdrts = [await DistributedRuntime.detached() for _ in range(2)]  # a lease (instance id) each
    engines = [slowed(make_torch_engine()), slowed(make_torch_engine())]
    try:
        services = []
        for wdrt, engine in zip(wdrts, engines):
            ep, svc = await _serve_worker(wdrt, engine, t_publisher, namespace="sr")
            services.append(svc)
        assert services[0].instance_id != services[1].instance_id
        router = StandaloneRouter(drt, namespace="sr", component="backend", endpoint="generate",
                                  block_size=BS)
        await router.start()
        finder = await drt.namespace("sr").component("router").endpoint("find_best").client()
        await finder.wait_for_instances(2.0)
        worker_client = await drt.namespace("sr").component("backend").endpoint("generate").client()
        await worker_client.wait_for_instances(2.0)
        prefix = [3 + i % 60 for i in range(8 * BS)]
        warm_id = services[0].instance_id
        first = asyncio.Event()
        task = asyncio.ensure_future(_hold_open(worker_client, _request(tp, prefix, 20), warm_id,
                                                Context(), first))
        await asyncio.wait_for(first.wait(), 10)
        await asyncio.sleep(0.1)  # the Stored events reach the router's indexer
        decision = await _ask(finder, {"token_ids": prefix + [99, 98], "request_id": "q1"})
        assert decision["worker_id"] == warm_id and decision["overlap_blocks"] == 8
        assert decision["fleet_frac"] == round(8 / 9, 4)
        index = await _ask(finder, {"op": "index"})
        assert index["index_blocks"][f"{warm_id:x}"] >= 8 and index["decisions"] == 1
        assert (await _ask(finder, {"op": "free", "request_id": "q1"}))["ok"] is True
        await task
        for _ in range(100):  # the stream ended: its Removed events empty the index
            index = await _ask(finder, {"op": "index"})
            if not any(index["index_blocks"].values()):
                break
            await asyncio.sleep(0.02)
        assert not any(index["index_blocks"].values())
        # --metrics-port is served now: the registry reads this router's
        # decisions and its scheduler's hit accounting
        from dynamo_tpu_torch.router import build_router_registry
        from dynamo_tpu_torch.runtime.prom import generate_latest

        text = generate_latest(build_router_registry(
            router.router.scheduler, lambda: router.decisions_total, lambda: router.shed_total,
            health=router.health)).decode()
        assert "dyn_llm_router_decisions_total 1.0" in text
        assert f"dyn_llm_kv_matched_blocks_total {float(8)}" in text
        await router.close()
    finally:
        for d in [drt] + wdrts:
            await d.close()
        for e in engines:
            await e.close()


async def test_standalone_router_sheds_past_watermark():
    drt = await DistributedRuntime.detached()
    engine = make_torch_engine()
    try:
        ep, svc = await _serve_worker(drt, engine, t_publisher, namespace="shed")
        router = StandaloneRouter(drt, namespace="shed", component="backend", endpoint="generate",
                                  block_size=BS, queue_factor=2.0)
        await router.start()
        finder = await drt.namespace("shed").component("router").endpoint("find_best").client()
        await finder.wait_for_instances(2.0)

        async def publish_load(active: int, waiting: int, slots: int):
            m = ForwardPassMetrics(worker_stats=WorkerStats(
                request_active_slots=active, request_total_slots=slots, num_requests_waiting=waiting))
            await drt.fabric.kv_put(stats_key(ep.id, svc.instance_id), mpack.packb(m.to_dict()))
            router._load = None  # drop the router's 1 s snapshot

        # the worker's own publisher, fed by load_metrics(engine)
        m = t_inputs.load_metrics(engine)
        assert (m.worker_stats.request_total_slots, m.kv_stats.kv_total_blocks) == (4, 63)
        await publish_load(active=2, waiting=0, slots=8)
        decision = await _ask(finder, {"token_ids": [1, 2, 3]})
        assert "worker_id" in decision and not decision.get("shed")
        await publish_load(active=8, waiting=10, slots=8)
        decision = await _ask(finder, {"token_ids": [4, 5, 6]})
        assert decision.get("shed") is True and decision["retry_after_ms"] > 0
        assert router.shed_total == 1
        await publish_load(active=1, waiting=0, slots=8)
        assert "worker_id" in await _ask(finder, {"token_ids": [7, 8, 9]})
        await router.close()
    finally:
        await drt.close()
        await engine.close()


# ------------------------------------------------------- the prefix-pull plan


def _plan_case(mod_s, mod_i, scores, freqs, routed, req, live, suspects, min_blocks=1):
    sched = mod_s.KvScheduler(block_size=BS, config=mod_s.KvRouterConfig(
        prefix_pull=True, prefix_pull_min_blocks=min_blocks))
    ov = _overlap(scores, mod_i)
    ov.frequencies.extend(freqs)
    routed_blocks = min(scores.get(routed, 0), req)
    plan = sched._plan_pull(
        result=mod_s.WorkerSelectionResult(
            worker_id=routed, required_blocks=req, overlap_blocks=routed_blocks,
            fleet_blocks=min(req, max(scores.values(), default=0))),
        overlap=ov, chain=list(range(100, 100 + req)), live=live,
        health_factors={w: 2.0 for w in suspects})
    return plan, dict(sched.pull_stats)


def test_plan_pull_and_pull_stats_equal_the_reference():
    """``KvScheduler._plan_pull`` gives the reference's plan (source,
    blocks, hashes, avoid list, fleet frequencies) and pull_stats on the
    same overlap scores: the reference's ranking case, then random ones."""
    case = ({2: 6, 3: 6, 9: 8}, [], 1, 8, {1, 2, 3}, {3})
    plan, stats = _plan_case(t_scheduler, t_indexer, *case)
    assert plan == _plan_case(j_scheduler, j_indexer, *case)[0]
    assert (plan["src"], plan["blocks"], plan["avoid"]) == (2, 6, [3, 9])
    assert plan["hashes"] == list(range(100, 106)) and "freq" not in plan
    assert stats == {"plans": 1, "planned_blocks": 6}
    rng = random.Random(19)
    plans = 0
    for _ in range(400):
        scores = {w: rng.randrange(0, 12) for w in rng.sample(range(8), rng.randrange(1, 7))}
        routed, req = rng.randrange(8), rng.randrange(0, 12)
        freqs = [rng.randrange(0, 9) for _ in range(rng.randrange(0, 12))]
        live = set(rng.sample(range(8), rng.randrange(1, 8))) | {routed}
        suspects = {w for w in live if rng.random() < 0.3}
        min_blocks = rng.choice([0, 1, 4])
        args = (scores, freqs, routed, req, live, suspects, min_blocks)
        got = _plan_case(t_scheduler, t_indexer, *args)
        assert got == _plan_case(j_scheduler, j_indexer, *args), args
        plans += got[0] is not None
    assert plans > 50


def test_prefix_pull_knobs_read_the_reference_env(monkeypatch):
    assert KvRouterConfig().prefix_pull is True
    assert KvRouterConfig().prefix_pull_min_blocks == 4
    monkeypatch.setenv("DYN_PREFIX_PULL", "off")
    monkeypatch.setenv("DYN_PREFIX_PULL_MIN_BLOCKS", "9")
    for mod in (t_scheduler, j_scheduler):
        cfg = mod.KvRouterConfig()
        assert (cfg.prefix_pull, cfg.prefix_pull_min_blocks) == (False, 9)


@pytest.mark.parametrize("min_blocks", [1, 4])
def test_scheduler_plans_equal_the_reference_on_random_streams(min_blocks):
    """``schedule`` on the same indexed events and queries, prefix_pull on
    (temperature 0, frequency tracking on): the same picks, plans (with
    the radix tree's recent-use counts) and pull_stats."""
    events, queries = random_event_stream(11, BS, n_workers=4)
    got = {}
    for name, ix_mod, sc_mod, pr_mod in (("ref", j_indexer, j_scheduler, j_protocols),
                                         ("port", t_indexer, t_scheduler, t_protocols)):
        ix = ix_mod.KvIndexer(BS, expiration_duration=600.0)
        for d in events[:250]:
            ix.apply_event(pr_mod.RouterEvent.from_dict(d))
        cfg = sc_mod.KvRouterConfig(router_temperature=0.0, prefix_pull=True,
                                    prefix_pull_min_blocks=min_blocks)
        sched = sc_mod.KvScheduler(BS, sc_mod.DefaultWorkerSelector(cfg), config=cfg)
        sched.update_workers([0, 1, 2, 3])
        random.seed(77)
        out = []
        for i, q in enumerate(queries[:150]):
            r = sched.schedule(q, ix.find_matches_for_request(q), request_id=f"r{i}")
            out.append((r.worker_id, r.overlap_blocks, r.fleet_blocks, r.pull_plan))
            if i % 4 == 3:
                sched.free(f"r{i - 2}")
        got[name] = (out, dict(sched.pull_stats))
    assert got["port"] == got["ref"]
    if min_blocks == 1:  # these short chains trail by fewer than 4 blocks
        assert got["port"][1]["plans"] > 0
        assert any(p and p.get("freq") for *_, p in got["port"][0])


class _StubKvRouter:
    """``route`` answers a fixed selection (a plan attached)."""

    def __init__(self, mod, plan):
        self.mod, self.plan, self.freed = mod, plan, []

    async def route(self, token_ids, request_id=None):
        return self.mod.WorkerSelectionResult(worker_id=5, required_blocks=10, overlap_blocks=2,
                                              fleet_blocks=9, pull_plan=dict(self.plan))

    def free(self, request_id):
        self.freed.append(request_id)


PLAN = {"src": 7, "blocks": 9, "hashes": list(range(9)), "avoid": [3], "freq": [4] * 9}


async def test_kv_push_router_puts_the_plan_on_the_context():
    """KvPushRouter carries the result's plan and fleet fraction on the
    Context's decision metadata, under the reference's wire keys."""
    got = {}
    for name, r_mod, s_mod, Ctx in (("ref", j_router, j_scheduler, JContext),
                                    ("port", t_router, t_scheduler, Context)):
        ctx = Ctx()
        picked = await r_mod.KvPushRouter(_StubKvRouter(s_mod, PLAN)).select_worker([1, 2, 3], ctx)
        got[name] = (picked, dict(ctx.metadata))
    assert got["port"] == got["ref"]
    assert got["port"][0] == (5, 2.0)
    ctx_md = got["port"][1]
    assert Context(metadata=ctx_md).decisions().pull_plan == PLAN


class _StubClient:
    def __init__(self, ids):
        self.ids, self.calls = ids, []

    def instance_ids(self):
        return list(self.ids)

    async def direct(self, request, iid, ctx):
        self.calls.append(iid)
        return []


class _PlanningSelector:
    """Picks worker 5 and attaches a plan, as KvPushRouter does."""

    async def select_worker(self, token_ids, context):
        context.decisions().pull_plan = dict(PLAN)
        return 5, 2.0


@pytest.mark.parametrize("dead", [True, False])
async def test_a_fallback_pick_clears_the_pull_plan(dead):
    """When the KV pick is a worker that just failed this request, the push
    router sends to another instance and drops the plan (made against the
    dead pick's overlap), as the reference's does; otherwise the plan
    stays."""
    from dynamo_tpu.pipeline.router import PushRouter as JPushRouter
    from dynamo_tpu_torch.pipeline.router import PushRouter

    got = {}
    for name, Router, Mode, Ctx in (("ref", JPushRouter, JRouterMode, JContext),
                                    ("port", PushRouter, RouterMode, Context)):
        client = _StubClient([5, 6])
        ctx = Ctx()
        await Router(client, Mode.KV, _PlanningSelector()).generate(
            {"token_ids": [1, 2, 3]}, ctx, exclude={5} if dead else None)
        got[name] = (client.calls, ctx.decisions().pull_plan)
    assert got["port"] == got["ref"]
    assert got["port"] == (([6], None) if dead else ([5], PLAN))


async def test_standalone_router_returns_the_prefix_pull():
    """find_best's reply carries the scheduler's plan as ``prefix_pull``,
    as the reference's does."""
    from dynamo_tpu.router import StandaloneRouter as JStandaloneRouter
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JDistributedRuntime

    replies = {}
    for name, Router, DRT, s_mod, Ctx in (
            ("ref", JStandaloneRouter, JDistributedRuntime, j_scheduler, JContext),
            ("port", StandaloneRouter, DistributedRuntime, t_scheduler, Context)):
        drt = await DRT.detached()
        try:
            router = Router(drt, namespace="pp")
            router.router = _StubKvRouter(s_mod, PLAN)
            replies[name] = [r async for r in router._handler({"token_ids": [1, 2, 3],
                                                               "request_id": "q"}, Ctx())]
        finally:
            await drt.close()
    assert replies["port"] == replies["ref"]
    assert replies["port"] == [{"worker_id": 5, "overlap_blocks": 2, "prefix_pull": PLAN,
                                "fleet_frac": 0.9}]
