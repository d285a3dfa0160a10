"""The port's tiered block manager and its engine integration against the
JAX package's, on the CPU.

* ``TieredBlockManager``: the same store / load / lookup / spill / promote /
  clear / checkpoint / restore sequences, on numpy blocks made from seeds,
  give the reference manager's results: return values, raised errors,
  stats, the host LRU and disk order, the arena bytes, every disk page's
  bytes, events, manifests and the integrity counters (raw bf16 and f32
  tiers, int8 tiers quantizing on store and taking int8 pages verbatim,
  quarantine after arena and page corruption, torn pages, fleet heat);
  the device-facing ``store_blocks_device`` / ``load_blocks_device`` (CPU
  tensors here, the card's path on a card) give the numpy interface's
  bytes;
* ``OffloadQueue``: the reference's dedupe / stale / bound / forget cases;
* ``TorchEngine`` with a manager against ``JaxEngine`` with one (the tiny
  Llama, f32 caches, block 4): offload on finish (the same
  ``offloaded_g2``), prefix reuse through a remote prefill (token-identical,
  the same ``cached_blocks`` and onboarded counts), a live prefix hit
  mid-generation and the completion-only control that misses it, a
  preemption that spills and resumes by onboarding, the int8 round trip
  and spec decode over offloaded blocks.
"""

import asyncio
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu import integrity as j_integrity
from dynamo_tpu.block_manager.block import Block as JBlock
from dynamo_tpu.block_manager.layout import LayoutConfig as JLayout
from dynamo_tpu.block_manager.layout import LayoutKind as JLayoutKind
from dynamo_tpu.block_manager.manager import TieredBlockManager as JManager
from dynamo_tpu.block_manager.offload import OffloadQueue as JQueue
from dynamo_tpu.disagg import protocols as JP
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch import integrity as t_integrity
from dynamo_tpu_torch.block_manager import LayoutConfig, OffloadQueue, TieredBlockManager
from dynamo_tpu_torch.block_manager.block import Block, BlockState, InvalidTransition
from dynamo_tpu_torch.block_manager.layout import LayoutKind
from dynamo_tpu_torch.disagg.colocated import HostPrefillClient
from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.protocols import common as tp

BS = 4
DIMS = dict(num_layers=2, page_size=BS, num_kv_heads=2, head_dim=16)


# ------------------------------------------------------------ unit level

def test_layout_and_block_state_machine_equal_the_reference():
    for dtype in ("bfloat16", "float32"):
        for kind in LayoutKind:
            ours = LayoutConfig(**DIMS, dtype=dtype, kind=kind)
            ref = JLayout(**DIMS, dtype=dtype, kind=JLayoutKind(kind.value))
            assert (ours.block_shape, ours.block_numel, ours.block_nbytes, ours.arena_shape(10)) == (
                ref.block_shape, ref.block_numel, ref.block_nbytes, ref.arena_shape(10))
    for b in (Block(page_size=4), JBlock(page_size=4)):
        b.append_tokens([1, 2])
        assert b.state.value == "partial"
        with pytest.raises(Exception, match="register in state"):
            b.register(123, None)
        b.append_tokens([3, 4])
        with pytest.raises(Exception, match="append in state"):
            b.append_tokens([5])
        b.register(123, None)
        b.acquire()
        with pytest.raises(Exception, match="refs held"):
            b.reset()
        b.release()
        b.reset()
        assert b.state.value == "reset" and b.seq_hash is None
    with pytest.raises(InvalidTransition):
        Block(page_size=2).release()
    assert BlockState.REGISTERED.value == "registered"


# --------------------------------------------------- manager against manager

def _blocks(dtype, n, seed):
    """(port arrays, reference arrays): [L, H, n, bs, D] K and V; bf16 as
    uint16 words for the port, ml_dtypes bfloat16 for the reference."""
    rng = np.random.default_rng(seed)
    shape = (DIMS["num_layers"], DIMS["num_kv_heads"], n, BS, DIMS["head_dim"])
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if dtype == "bfloat16":
        kv = [a.astype(ml_dtypes.bfloat16) for a in kv]
        return [a.view(np.uint16) for a in kv], kv
    return kv, kv


def _quant(n, seed):
    _, (k, v) = _blocks("bfloat16", n, seed)
    kq, ks = JP.kv_quantize_int8(k)
    vq, vs = JP.kv_quantize_int8(v)
    return kq, ks, vq, vs


def _err(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared between the packages
        return (type(e).__name__, str(e))


def _words(a):
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _state(m, disk_dir):
    pages = {}
    if disk_dir and os.path.isdir(disk_dir):
        for name in sorted(os.listdir(disk_dir)):
            with open(os.path.join(disk_dir, name), "rb") as f:
                pages[name] = f.read()
    arena = {h: (_words(m._k_arena[hnd.index]).tobytes(), _words(m._v_arena[hnd.index]).tobytes(),
                 hnd.k_sum, hnd.v_sum) for h, hnd in m._host.items()}
    return {"stats": dataclasses.asdict(m.stats), "host": list(m._host), "disk": list(m._disk),
            "arena": arena, "pages": pages, "quarantined": sorted(m._quarantined),
            "free": sorted(m._free_slots), "adverts": m.advert_blocks()}


def _apply(m, op, mine: bool, disk_dir, ckpt_dir):
    kind, args = op[0], op[1:]
    if kind == "store":
        hashes, dtype, seed = args
        ours, ref = _blocks(dtype, len(hashes), seed)
        return m.store_blocks(hashes, *(ours if mine else ref))
    if kind == "store_quant":
        hashes, seed = args
        return m.store_blocks_quant(hashes, *_quant(len(hashes), seed))
    if kind == "load":
        return tuple(_words(a).tobytes() for a in m.load_blocks(args[0]))
    if kind == "load_quant":
        return tuple(np.asarray(a).tobytes() for a in m.load_blocks_quant(args[0]))
    if kind == "lookup":
        return m.lookup_prefix(args[0])
    if kind == "contains":
        return [h in m for h in args[0]]
    if kind == "flip":  # a bit of host RAM: arena (k / v) or scale plane
        h, plane, byte, mask = args
        m.__dict__[plane][m._host[h].index].reshape(-1).view(np.uint8)[byte] ^= mask
        return None
    if kind == "tear":  # truncate a disk page to half
        path = m._disk[args[0]]
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        return None
    if kind == "rot":  # one flipped byte in a disk page's body
        path = m._disk[args[0]]
        with open(path, "r+b") as f:
            f.seek(40)
            b = f.read(1)
            f.seek(40)
            f.write(bytes([b[0] ^ 1]))
        return None
    if kind == "heat":
        return m.note_fleet_heat(*args)
    if kind == "clear":
        return m.clear()
    if kind == "checkpoint":
        out = m.checkpoint(ckpt_dir)
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
        pages = {}
        for name in sorted(os.listdir(os.path.join(ckpt_dir, "pages"))):
            with open(os.path.join(ckpt_dir, "pages", name), "rb") as f:
                pages[name] = f.read()
        return out["blocks"], manifest, pages
    if kind == "restore":
        return m.restore(ckpt_dir)
    if kind == "quarantine":
        m._quarantined.add(args[0])
        return None
    if kind == "skew_disk_tier":  # the disk tier's fingerprint changed shape
        path = os.path.join(ckpt_dir, "manifest.json")
        with open(path) as f:
            manifest = json.load(f)
        manifest["tiers"]["disk"]["layout"]["page_size"] = 999
        with open(path, "w") as f:
            json.dump(manifest, f)
        return None
    if kind == "corrupt_ckpt":  # a flipped byte in a checkpoint page
        path = os.path.join(ckpt_dir, "pages", f"{args[0]:#x}.kvb")
        with open(path, "r+b") as f:
            f.seek(30)
            b = f.read(1)
            f.seek(30)
            f.write(bytes([b[0] ^ 4]))
        return None
    raise AssertionError(kind)


BF, F32 = "bfloat16", "float32"
SCENARIOS = {
    # test_block_manager.py:93-150: round trip and dedupe, LRU spill and
    # promotion, the disk cap, no disk drops under pressure
    "host_roundtrip_dedupe": (BF, dict(host_blocks=8), [
        ("store", [11, 22, 33], BF, 0), ("lookup", [11, 22, 33, 44]), ("lookup", [99]),
        ("store", [11, 22], BF, 0), ("load", [11, 22, 33]), ("store", [44, 44, 55], BF, 1)]),
    "lru_spill_promote": (BF, dict(host_blocks=2, disk_blocks=8), [
        ("store", [1, 2, 3, 4], BF, 0), ("lookup", [1, 2, 3, 4]), ("load", [1]),
        ("load", [2, 3, 4]), ("contains", [1, 2, 3, 4, 5])]),
    "disk_cap": (BF, dict(host_blocks=1, disk_blocks=2), [
        ("store", [1, 2, 3, 4, 5], BF, 0), ("contains", [1, 2, 3, 4, 5]), ("load", [5, 4])]),
    "no_disk_drops": (F32, dict(host_blocks=2), [
        ("store", [1, 2, 3], F32, 2), ("lookup", [1]), ("lookup", [2, 3]), ("load", [3, 2])]),
    "oversized_store": (BF, dict(host_blocks=3, disk_blocks=0), [
        ("store", list(range(100, 108)), BF, 3), ("lookup", list(range(100, 108))),
        ("load", [100, 101, 107])]),
    # test_integrity.py:183-244: arena corruption into quarantine, a torn
    # page, a rotten page
    "host_corruption_quarantine": (BF, dict(host_blocks=8), [
        ("store", [100, 101], BF, 0), ("flip", 100, "_k_arena", 7, 0x04),
        ("load", [100, 101]), ("store", [100], BF, 0), ("flip", 100, "_v_arena", 3, 0x80),
        ("load", [100]), ("store", [100], BF, 0), ("lookup", [100, 101]),
        ("contains", [100, 101])]),
    "torn_and_rotten_pages": (BF, dict(host_blocks=1, disk_blocks=0), [
        ("store", [200, 201, 202], BF, 3), ("tear", 200), ("load", [200]), ("rot", 201),
        ("load", [201]), ("load", [202]), ("contains", [200, 201, 202])]),
    # fleet heat keeps a hot block past an older cold one
    "fleet_heat_eviction": (BF, dict(host_blocks=3, disk_blocks=0), [
        ("store", [1, 2, 3], BF, 4), ("heat", [1, 2], [9.0, 1.0]), ("store", [4], BF, 5),
        ("contains", [1, 2, 3, 4]), ("store", [5], BF, 6), ("contains", [1, 2, 3, 4, 5])]),
    # warm restart: checkpoint (host and disk pages), clear, restore, a
    # corrupt checkpoint page refused
    "checkpoint_restore": (BF, dict(host_blocks=2, disk_blocks=0), [
        ("store", [7, 8, 9], BF, 7), ("checkpoint",), ("clear",), ("lookup", [7]),
        ("corrupt_ckpt", 8), ("restore",), ("lookup", [7, 8, 9]), ("load", [9, 7]),
        ("restore",)]),
    # int8 tiers: quantize on store, dequantize on load; verbatim int8 pages
    # (test_int8_kv.py:294-347), a flipped scale byte into quarantine
    # test_blackout.py:412-560: warm restarts into a fresh manager ("fresh":
    # host blocks, disk or not, layout dtype, codec): corrupt pages refused,
    # quarantined hashes skipped, capacity respected, overflow to disk, a
    # layout / codec mismatch refused whole, a skewed disk tier refused
    # while the host tier is salvaged
    "warm_restore_fresh": (BF, dict(host_blocks=8), [
        ("store", [21, 22, 23, 24, 25, 26], BF, 10), ("checkpoint",), ("corrupt_ckpt", 21),
        ("fresh", 3, False, BF, "raw"), ("quarantine", 23), ("restore",),
        ("lookup", [22, 23]), ("lookup", [24, 25]), ("load", [24, 22])]),
    "warm_restore_overflow_and_mismatch": (BF, dict(host_blocks=8), [
        ("store", [31, 32, 33, 34, 35], BF, 11), ("checkpoint",),
        ("fresh", 2, True, BF, "raw"), ("restore",), ("lookup", [31, 32, 33, 34, 35]),
        ("load", [31, 35]), ("fresh", 8, False, F32, "raw"), ("restore",),
        ("fresh", 8, False, BF, "int8"), ("restore",)]),
    "warm_tier_skew": (BF, dict(host_blocks=2, disk_blocks=0), [
        ("store", [41, 42, 43, 44], BF, 12), ("checkpoint",), ("skew_disk_tier",),
        ("fresh", 8, True, BF, "raw"), ("restore",), ("lookup", [43, 44]),
        ("contains", [41, 42, 43, 44])]),
    "int8_codec": ("int8", dict(host_blocks=2, disk_blocks=0), [
        ("store", [1, 2, 3], BF, 8), ("load", [1, 2, 3]), ("load_quant", [3])]),
    "int8_verbatim_quarantine": ("int8", dict(host_blocks=16), [
        ("store_quant", [201, 202], 9), ("load_quant", [201, 202]),
        ("flip", 201, "_k_arena", 3, 0x5A), ("load_quant", [201]), ("store_quant", [201], 9),
        ("flip", 201, "_k_scales", 1, 0x01), ("load_quant", [201]), ("store_quant", [201], 9),
        ("lookup", [201, 202]), ("checkpoint",), ("restore",)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_manager_sequences_equal_the_reference(name, tmp_path):
    """Every op's result (or error) and the whole state after it."""
    dtype, kw, ops = SCENARIOS[name]
    codec = "int8" if dtype == "int8" else "raw"
    ldtype = BF if dtype == "int8" else dtype
    t_integrity.COUNTERS.reset()
    j_integrity.COUNTERS.reset()
    managers = {}

    def make(side, host_blocks, disk, dtype, codec):
        events = []
        cls, lay = (TieredBlockManager, LayoutConfig) if side == "ours" else (JManager, JLayout)
        m = cls(lay(**DIMS, dtype=dtype), host_blocks=host_blocks, disk_dir=disk,
                disk_blocks=kw.get("disk_blocks", 0), wire_codec=codec,
                on_event=lambda kind, hs, tier, ev=events: ev.append((kind, list(hs), tier)))
        managers[side] = (m, disk, str(tmp_path / side / "ckpt"), events)

    for side in ("ours", "ref"):
        make(side, kw["host_blocks"],
             str(tmp_path / side / "disk") if "disk_blocks" in kw else None, ldtype, codec)
    for n_op, op in enumerate(ops):
        if op[0] == "fresh":  # a restarted worker: a new manager, the same checkpoint
            for side in managers:
                make(side, op[1], str(tmp_path / side / f"disk{n_op}") if op[2] else None,
                     op[3], op[4])
            continue
        got = {}
        for side, (m, disk, ckpt, events) in managers.items():
            got[side] = (_err(lambda: _apply(m, op, side == "ours", disk, ckpt)),
                         _state(m, disk), list(events))
        ours, ref = got["ours"], got["ref"]
        assert ours[0][0] == ref[0][0], (op, ours[0], ref[0])
        if ours[0][0] == "ok":
            res_o, res_r = ours[0][1], ref[0][1]
            if op[0] == "checkpoint":  # the directory names differ
                assert res_o[1]["blocks"] == res_r[1]["blocks"] and res_o[2] == res_r[2]
                assert res_o[1] == res_r[1]
            else:
                assert res_o == res_r, op
        else:
            assert ours[0][1] == ref[0][1], op
        assert ours[1] == ref[1], op
        assert ours[2] == ref[2], op
    assert t_integrity.COUNTERS.snapshot()["integrity_failures_by_path"] == dict(
        j_integrity.COUNTERS.failures)
    assert t_integrity.COUNTERS.blocks_quarantined == j_integrity.COUNTERS.blocks_quarantined


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_device_path_lands_the_numpy_interfaces_bytes(codec, tmp_path):
    """``store_blocks_device`` and ``load_blocks_device`` over blocks-first
    tensors give the arena, the pages and the blocks that ``store_blocks``
    / ``load_blocks*`` give; slots out of order are copied by runs; a
    promotion under pressure copies from the new slot."""
    lay = LayoutConfig(**DIMS, dtype=BF)
    a = TieredBlockManager(lay, host_blocks=3, disk_dir=str(tmp_path / "a"), wire_codec=codec)
    b = TieredBlockManager(lay, host_blocks=3, disk_dir=str(tmp_path / "b"), wire_codec=codec)
    hashes = [5, 6, 7, 8, 9]
    if codec == "raw":
        (k, v), _ = _blocks(BF, 5, 11)
        a.store_blocks(hashes, k, v)
        first = [torch.from_numpy(np.moveaxis(x, 2, 0).copy().view(np.int16)).view(torch.bfloat16)
                 for x in (k, v)]
    else:
        kq, ks, vq, vs = _quant(5, 11)
        a.store_blocks_quant(hashes, kq, ks, vq, vs)
        first = [torch.from_numpy(np.moveaxis(x, 2, 0).copy()) for x in (kq, vq, ks, vs)]
    assert b.store_blocks_device(hashes, *first) == 5
    assert _state(a, a.disk_dir)["arena"] == _state(b, b.disk_dir)["arena"]
    assert sorted(os.listdir(a.disk_dir)) == sorted(os.listdir(b.disk_dir))
    for name in os.listdir(a.disk_dir):
        with open(os.path.join(a.disk_dir, name), "rb") as fa, \
                open(os.path.join(b.disk_dir, name), "rb") as fb:
            assert fa.read() == fb.read()
    order = [9, 5, 8, 6]  # host hits, then disk pages promoted under pressure
    got = b.load_blocks_device(order, "cpu")
    if codec == "raw":
        want = a.load_blocks(order)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy().view(np.uint16),
                                          np.moveaxis(w, 2, 0))
    else:
        want = a.load_blocks_quant(order)
        for g, w in zip(got, (want[0], want[2], want[1], want[3])):
            np.testing.assert_array_equal(g.numpy(), np.moveaxis(w, 2, 0))
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert list(a._host) == list(b._host) and list(a._disk) == list(b._disk)
    with pytest.raises(ValueError):
        b.store_blocks_device([1], *first[:2])  if codec == "int8" else \
            b.store_blocks_device([1], first[0].float(), first[1].float())
    assert not b.pinned  # pinned only with a card and pin_memory=True
    assert b.host_bytes == sum(t.numel() * t.element_size() for t in
                               [b._k_host, b._v_host] + ([b._k_scales_host, b._v_scales_host]
                                                         if codec == "int8" else []))


# ------------------------------------------------------------ offload queue

class _FakeSeq:
    def __init__(self, hashes, block_ids):
        class _Chain:
            pass

        class _Blk:
            def __init__(self, h, p):
                self.block_hash = h
                self.position = p

        self.hash_seq = _Chain()
        self.hash_seq.blocks = [_Blk(h, i) for i, h in enumerate(hashes)]
        self.block_ids = block_ids
        self.slot = 0
        self.pending_remote = False


class _FakeManager:
    def __init__(self, present=()):
        self.present = set(present)

    def __contains__(self, h):
        return h in self.present


def _queue_cases(cls):
    """test_midgen_offload.py:59-110, on either package's queue."""
    out = []
    q = cls(max_pending=8)
    seq = _FakeSeq([10, 20, 30], [5, 6, 7])
    out.append(q.enqueue(seq, [(10, 0), (20, 1)]))
    out.append(q.enqueue(seq, [(10, 0)]))
    out.append([(h, b) for _, h, b in q.pop_valid(10, _FakeManager(present={20}))])
    q = cls()
    seq = _FakeSeq([10, 20], [5, 6])
    q.enqueue(seq, [(10, 0), (20, 1)])
    seq.slot = None
    out.append(q.pop_valid(10, _FakeManager()))
    seq2 = _FakeSeq([11, 21], [5, 6])
    q.enqueue(seq2, [(11, 0)])
    seq2.hash_seq.blocks[0].block_hash = 99
    out.append(q.pop_valid(10, _FakeManager()))
    q2 = cls(max_pending=2)
    a = _FakeSeq([1, 2, 3], [4, 5, 6])
    q2.enqueue(a, [(1, 0), (2, 1)])
    out.append(q2.enqueue(a, [(3, 2)]))
    out.append([(h, b) for _, h, b in q2.pop_valid(10, _FakeManager())])
    q3 = cls()
    a, b = _FakeSeq([1, 2], [4, 5]), _FakeSeq([3], [6])
    q3.enqueue(a, [(1, 0), (2, 1)])
    q3.enqueue(b, [(3, 0)])
    out.append(q3.forget_seq(a, cancelled=True))
    out.append([(h, blk) for _, h, blk in q3.pop_valid(10, _FakeManager())])
    out.append(q3.enqueue(b, [(1, 0)]))
    out += [dataclasses.asdict(x.stats) for x in (q, q2, q3)]
    return out


def test_offload_queue_cases_equal_the_reference():
    assert _queue_cases(OffloadQueue) == _queue_cases(JQueue)
    ours = _queue_cases(OffloadQueue)
    assert ours[:3] == [2, 0, [(10, 5)]] and ours[5] == 0


# ------------------------------------------------------------------ engines

VOCAB = 64


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    qparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32, quantize=True)
    tq = params_from_jax(jax.tree.map(np.asarray, qparams), device="cpu")
    return jcfg, jparams, tparams, qparams, tq


def _layout(mod, cfg, dtype):
    return mod(num_layers=cfg.num_layers, page_size=BS, num_kv_heads=cfg.num_kv_heads,
               head_dim=cfg.head_dim, dtype=dtype)


def _pair(models, *, nb=64, max_batch=2, max_len=96, chunk=512, host_blocks=64, int8=False,
          bm=True, **ekw):
    """(JaxEngine, TorchEngine), each with its own manager when ``bm``."""
    jcfg, jparams, tparams, qparams, tq = models
    dims = dict(num_blocks=nb, block_size=BS, max_batch=max_batch, max_model_len=max_len)
    ecfg = dict(dims, watermark_blocks=2, **ekw)
    dtype, codec = ("bfloat16", "int8") if int8 else ("float32", "raw")
    jbm = JManager(_layout(JLayout, jcfg, dtype), host_blocks, wire_codec=codec) if bm else None
    tbm = (TieredBlockManager(_layout(LayoutConfig, jcfg, dtype), host_blocks, wire_codec=codec)
           if bm else None)
    jr = ModelRunner(jcfg, qparams if int8 else jparams, kv_dtype="int8" if int8 else jnp.float32,
                     prefill_chunk_tokens=chunk, **dims)
    tr = TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), tq if int8 else tparams,
                          device="cpu", prefill_chunk_tokens=chunk,
                          kv_dtype="int8" if int8 else "bf16", **dims)
    return (JaxEngine(jr, JaxEngineConfig(**ecfg), block_manager=jbm),
            TorchEngine(tr, TorchEngineConfig(**ecfg), block_manager=tbm))


def _req(mod, prompt, n, **stop):
    return mod.PreprocessedRequest(token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
                                   stop=mod.StopConditions(max_tokens=n, ignore_eos=True, **stop))


async def _collect(engine, prompt, n):
    mod, ctx = (tp, tp.Context) if isinstance(engine, TorchEngine) else (jp, JaxContext)
    out = []
    async for o in engine.generate(_req(mod, prompt, n), ctx()):
        out.extend(o.token_ids)
    return out


async def _settle(engine, until, tries=200):
    for _ in range(tries):
        if until():
            return
        await asyncio.sleep(0.02)


async def test_engine_offloads_on_finish_as_the_reference(models):
    """test_block_manager.py:179: 13 prompt + 8 generated tokens -> 5
    KV-complete blocks offloaded, by the mid-generation drain and the
    completion offload together."""
    jeng, teng = _pair(models)
    prompt = list(range(2, 15))
    got = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        got[name] = await _collect(eng, prompt, 8)
        await _settle(eng, lambda e=eng: e.block_manager.stats.offloaded_g2 >= 5)
        await eng.close()
    assert got["torch"] == got["jax"]
    assert teng.block_manager.stats.offloaded_g2 == jeng.block_manager.stats.offloaded_g2 == 5
    assert list(teng.block_manager._host) == list(jeng.block_manager._host)
    assert teng.stats.kv_offloaded_blocks == 5 and teng.stats.kv_offload_errors == 0
    assert teng.allocator.free_count == teng.config.num_blocks - 1


class _JaxHostClient:
    """The reference's remote-prefill client contract over an in-process
    prefill JaxEngine (its ``prefill_only``), recording ``cached_blocks``."""

    def __init__(self, engine):
        self.engine, self.cached = engine, []

    async def prefill(self, token_ids, *, temperature=0.0, top_p=1.0, top_k=0, cached_blocks=0,
                      rep_pen=1.0, key_data=None, eos_ids=None, eos_suppress=False, **_):
        self.cached.append(cached_blocks)
        return await self.engine.prefill_only(JP.RemotePrefillRequest(
            request_id="r", token_ids=list(token_ids), reply_subject="-",
            temperature=temperature, top_p=top_p, top_k=top_k, cached_blocks=cached_blocks,
            block_size=BS, rep_pen=rep_pen,
            key_data=[int(x) for x in key_data] if key_data is not None else None,
            eos_ids=[int(x) for x in eos_ids] if eos_ids is not None else None,
            eos_suppress=eos_suppress))


class _Recording(HostPrefillClient):
    def __init__(self, engine, block_size):
        super().__init__(engine, block_size)
        self.cached = []

    async def prefill(self, token_ids, **kw):
        self.cached.append(kw["cached_blocks"])
        return await super().prefill(token_ids, **kw)


async def test_prefix_reuse_through_a_remote_prefill_as_the_reference(models, monkeypatch):
    """test_block_manager.py:198: the second identical prompt onboards the
    offloaded blocks and the prefill engine ships only the rest; the
    tokens are a local engine's, ``cached_blocks`` and the onboarded
    counts the reference's."""
    from dynamo_tpu.disagg.router import DisaggConfig as JDisaggConfig
    from dynamo_tpu.disagg.router import DisaggregatedRouter as JRouter
    from dynamo_tpu.fabric.client import FabricClient

    monkeypatch.setenv("DYN_KV_STREAM", "0")
    jeng, teng = _pair(models)
    jpre, tpre = _pair(models, bm=False)
    jclient, tclient = _JaxHostClient(jpre), _Recording(tpre, BS)
    jeng.disagg_router = JRouter(FabricClient.in_process(), "bm",
                                 JDisaggConfig(max_local_prefill_length=0,
                                               max_prefill_queue_size=100))
    jeng.remote_prefill_client = jclient
    teng.disagg_router = DisaggregatedRouter(DisaggConfig(max_local_prefill_length=0,
                                                          max_prefill_queue_size=100))
    teng.remote_prefill_client = tclient
    ref_j, ref_t = _pair(models, bm=False)
    prompt = list(range(2, 19))  # 4 full blocks and a tail
    want = await _collect(ref_j, prompt, 8)
    got = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        first = await _collect(eng, prompt, 8)
        await _settle(eng, lambda e=eng: e.block_manager.stats.offloaded_g2 >= 6)
        second = await _collect(eng, prompt, 8)
        got[name] = (first, second, dataclasses.asdict(eng.block_manager.stats))
    assert got["torch"][:2] == got["jax"][:2] == (want, want)
    assert got["torch"][2] == got["jax"][2]
    assert tclient.cached == jclient.cached and tclient.cached[1] >= 4
    assert teng.stats.kv_onboarded_blocks == tclient.cached[1]
    assert teng.stats.remote_fallbacks == 0 and teng.stats.kv_onboard_errors == 0
    for e in (jeng, teng, jpre, tpre, ref_j, ref_t):
        await e.close()


async def _live_prefix(engine, midgen: bool):
    """test_midgen_offload.py:140-172: A decodes 40 tokens; after its second
    token, B with the same prompt arrives while A still runs."""
    prompt = list(range(2, 14))
    bm = engine.block_manager
    a_tokens, b_task, live, a_live = [], None, 0, False
    is_torch = isinstance(engine, TorchEngine)
    mod, ctx = (tp, tp.Context) if is_torch else (jp, JaxContext)
    async for o in engine.generate(_req(mod, prompt, 40), ctx()):
        a_tokens.extend(o.token_ids)
        if len(a_tokens) == 2:
            for _ in range(50):
                if not midgen or bm.stats.offloaded_g2 >= 3:
                    break
                await asyncio.sleep(0.02)
            live = bm.stats.offloaded_g2
            a_live = any(s is not None for s in engine.slots)
            b_task = asyncio.ensure_future(_collect(engine, prompt, 8))
    b_tokens = await b_task
    await engine.close()
    return a_tokens, b_tokens, live, a_live, bm.stats.onboarded


@pytest.mark.parametrize("midgen", [True, False], ids=["midgen", "completion_only"])
async def test_live_prefix_hit_mid_generation_as_the_reference(models, midgen):
    """test_midgen_offload.py:182 / :196: with the drain, B onboards the
    prefix A is still decoding; without it (offload_per_step 0), B
    recomputes. Either way B's tokens are A's first 8."""
    got = {}
    for name, eng in zip(("jax", "torch"), _pair(models, offload_per_step=4 if midgen else 0)):
        got[name] = await _live_prefix(eng, midgen)
    for a, b, live, a_live, onboarded in got.values():
        assert a_live and len(a) == 40 and b == a[:8]
        if midgen:
            assert live >= 3 and onboarded >= 2
        else:
            assert live == 0 and onboarded == 0
    assert got["torch"][:2] == got["jax"][:2]
    assert got["torch"][4] == got["jax"][4]


async def test_preemption_spills_and_resumes_by_onboarding_as_the_reference(models):
    """test_midgen_offload.py:210: two decodes outgrow 15 usable blocks;
    the younger is preempted, its complete blocks spill to the host tier and
    its re-admission onboards them. Tokens equal an unpressured run's."""
    ref_j, _ = _pair(models, bm=False)
    pa, pb = list(range(2, 10)), list(range(30, 38))
    want = [await _collect(ref_j, p, 40) for p in (pa, pb)]
    await ref_j.close()
    jeng, teng = _pair(models, nb=16)
    got = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        got[name] = await asyncio.gather(_collect(eng, pa, 40), _collect(eng, pb, 40))
        await eng.close()
    assert got["torch"] == got["jax"] == want
    s = teng.stats
    assert s.preemptions > 0 and s.preempt_spills > 0
    assert teng.block_manager.stats.offloaded_g2 > 0 and teng.block_manager.stats.onboarded > 0
    assert s.kv_onboarded_blocks > 0 and s.kv_offload_errors == s.kv_onboard_errors == 0
    assert teng.allocator.free_count == teng.config.num_blocks - 1


async def test_int8_offload_onboard_round_trip_as_the_reference(models):
    """test_int8_kv.py:389 / test_protocol_parity.py:389: an int8-resident
    cache offloads its pages verbatim into int8 tiers and onboards them
    verbatim; the follow-up stream equals the first, and the tiers' bytes
    equal the reference's."""
    jeng, teng = _pair(models, int8=True, host_blocks=32)
    prompt = list(range(2, 14))
    got = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        first = await _collect(eng, prompt, 8)
        await _settle(eng, lambda e=eng: e.block_manager.stats.host_blocks_used >= 4)
        before = eng.block_manager.stats.onboarded
        second = await _collect(eng, prompt, 8)
        got[name] = (first, second, eng.block_manager.stats.onboarded - before)
        await eng.close()
    assert got["torch"] == got["jax"]
    first, second, onboarded = got["torch"]
    assert second == first and onboarded > 0
    # the tiers hold each cache's pages verbatim; two f32 pipelines' K / V
    # differ in the last bits, so the pages agree within 1e-5 (the runner
    # parity tests' tolerance) in the scales and a step in the mantissas
    tb, jb = teng.block_manager, jeng.block_manager
    assert list(tb._host) == list(jb._host)
    for h in tb._host:
        ti, ji = tb._host[h].index, jb._host[h].index
        for a, b in ((tb._k_arena, jb._k_arena), (tb._v_arena, jb._v_arena)):
            assert np.abs(a[ti].astype(np.int32) - b[ji].astype(np.int32)).max() <= 1
        for a, b in ((tb._k_scales, jb._k_scales), (tb._v_scales, jb._v_scales)):
            np.testing.assert_allclose(a[ti], b[ji], rtol=1e-5, atol=1e-7)


async def test_spec_decode_offloads_only_accepted_kv_as_the_reference(models):
    """test_spec_decode.py:266: rejected drafts' KV lies past kv_written, so
    the blocks offloaded at completion round-trip: the second stream,
    onboarded, equals a no-spec engine's."""
    rep = [2, 40, 41, 2, 40, 41, 2, 40, 41]
    ref, _ = _pair(models, bm=False, max_batch=4)
    want = await _collect(ref, rep, 20)
    await ref.close()
    _, teng = _pair(models, nb=128, max_batch=4, chunk=16, spec_k=3, spec_min_coverage=0.0)
    first = await _collect(teng, rep, 20)
    assert teng.stats.num_accepted_tokens > 0
    await teng.drain_offloads()
    assert teng.block_manager.stats.host_blocks_used > 0
    second = await _collect(teng, rep, 20)
    assert first == second == want
    assert teng.stats.kv_onboarded_blocks > 0
    await teng.close()


# ------------------------------------------------------------------ factory

@pytest.mark.parametrize("kv,wire", [("bf16", "raw"), ("bf16", "int8"), ("int8", "raw")])
def test_factory_sizes_the_tiers_as_the_reference(monkeypatch, tmp_path, kv, wire):
    """``DYN_KV_HOST_OFFLOAD_GB`` / ``DYN_KV_DISK_*`` / ``DYN_KV_WIRE`` give
    the JAX factory's tiers (host and disk blocks, codec; an int8 cache
    forces int8 tiers) at the port's block size; unset, none."""
    from dynamo_tpu.engine.jax_engine.factory import _maybe_block_manager as j_maybe
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine

    cfg = tl.LlamaConfig.tiny(vocab_size=VOCAB)
    engine = build_torch_engine(cfg, device="cpu", kv_block_size=16, max_batch=2, num_blocks=32,
                                max_model_len=64, kv_dtype=kv)
    assert engine.block_manager is None
    monkeypatch.setenv("DYN_KV_HOST_OFFLOAD_GB", "0.0005")
    monkeypatch.setenv("DYN_KV_DISK_DIR", str(tmp_path / "disk"))
    monkeypatch.setenv("DYN_KV_DISK_GB", "0.001")
    monkeypatch.setenv("DYN_KV_WIRE", wire)
    monkeypatch.setenv("DYN_KV_DTYPE", kv)
    engine = build_torch_engine(cfg, device="cpu", kv_block_size=16, max_batch=2, num_blocks=32,
                                max_model_len=64, kv_dtype=kv, dtype=torch.bfloat16)
    ours = engine.block_manager
    ref = j_maybe(jl.LlamaConfig.tiny(vocab_size=VOCAB), 16)
    assert (ours.host_blocks, ours.disk_blocks, ours.disk_dir, ours.wire_codec) == (
        ref.host_blocks, ref.disk_blocks, ref.disk_dir, ref.wire_codec)
    assert ours.layout.dtype == "bfloat16" and ours.layout.page_size == 16
    assert not ours.pinned  # a CPU engine's arena is not pinned


async def test_int8_tiers_over_a_raw_cache_go_through_the_host_codec(models):
    """``DYN_KV_WIRE=int8`` over an f32 cache: the tiers' form differs from
    the cache's, so blocks move through ``extract_blocks`` / ``store_blocks``
    (quantized on the host) and ``load_blocks`` / ``inject_blocks``; the
    repeated prompt onboards its prefix and streams the reference's tokens
    with the same tiers."""
    jcfg = models[0]
    jeng, teng = _pair(models, bm=False)
    jeng.block_manager = JManager(_layout(JLayout, jcfg, "float32"), 64, wire_codec="int8")
    teng.block_manager = TieredBlockManager(_layout(LayoutConfig, jcfg, "float32"), 64,
                                            wire_codec="int8")
    teng._offload_queue, jeng._offload_queue = OffloadQueue(), JQueue()
    assert not teng._tier_on_device()
    prompt = list(range(2, 19))
    got = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        first = await _collect(eng, prompt, 8)
        await _settle(eng, lambda e=eng: e.block_manager.stats.offloaded_g2 >= 6)
        second = await _collect(eng, prompt, 8)
        got[name] = (first, second, eng.block_manager.stats.onboarded)
        await eng.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][2] >= 4 and teng.stats.kv_onboard_errors == 0
