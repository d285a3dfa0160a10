"""The port's fabric (``dynamo_tpu_torch/fabric/``) against the JAX package's.

- The stdlib codec (``fabric/mpack.py``) against ``msgpack``: the same bytes
  as ``packb(x, use_bin_type=True)`` and the same values as
  ``unpackb(b, raw=False)`` on a hypothesis grid and at every size boundary;
  the refusals (other types, non-str map keys, truncated, trailing or
  unknown bytes).
- ``wire.pack`` byte-identical to the JAX ``wire.pack``.
- ``FabricState`` against the JAX ``FabricState`` on seeded random op
  sequences under a fake clock: equal results, equal watch events, equal
  deliveries and snapshots.
- Twins of ``tests/test_fabric.py``, the five non-slow cases of
  ``tests/test_fabric_ha.py`` and ``tests/test_wire_negotiation.py``.
- Interop over TCP: the port's client against the JAX server and the JAX
  client against the port's server.
"""

import asyncio
import math
import random
import struct

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.fabric import FabricClient as JFabricClient
from dynamo_tpu.fabric import FabricServer as JFabricServer
from dynamo_tpu.fabric import state as j_state
from dynamo_tpu.fabric import wire as j_wire
from dynamo_tpu.runtime import clock as j_clock
from dynamo_tpu_torch.fabric import FabricClient, FabricServer, mpack, wire
from dynamo_tpu_torch.fabric import client as t_client
from dynamo_tpu_torch.fabric import state as t_state
from dynamo_tpu_torch.fabric.state import FabricState, subject_matches
from dynamo_tpu_torch.runtime import clock as t_clock


@pytest.fixture(autouse=True)
def _fresh_port_fabric():
    """Each test gets a clean process-shared in-memory fabric of the port
    (the suite's conftest resets the JAX package's)."""
    t_client.reset_shared_state()
    yield
    t_client.reset_shared_state()


def ref_pack(x) -> bytes:
    return msgpack.packb(x, use_bin_type=True)


def ref_unpack(b: bytes):
    return msgpack.unpackb(b, raw=False)


# ------------------------------------------------------------------- codec

_leaves = (
    st.none() | st.booleans()
    | st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
    | st.floats(allow_nan=False)
    | st.text(max_size=300) | st.binary(max_size=300)
)
_values = st.recursive(
    _leaves,
    lambda inner: (
        st.lists(inner, max_size=20)
        | st.lists(inner, max_size=20).map(tuple)
        | st.dictionaries(st.text(max_size=40) | st.binary(max_size=8), inner, max_size=20)
    ),
    max_leaves=60,
)


@settings(max_examples=400, deadline=None)
@given(_values)
def test_codec_matches_msgpack_on_a_hypothesis_grid(x):
    b = ref_pack(x)
    assert mpack.packb(x) == b
    assert mpack.unpackb(b) == ref_unpack(b)


INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63, 2 ** 64 - 1,
             -1, -31, -32, -33, -127, -128, -129, -32767, -32768, -32769,
             -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)]
SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("kind", ["int", "float", "str", "bytes", "list", "tuple", "dict", "nested"])
def test_codec_matches_msgpack_at_every_boundary(kind):
    if kind == "int":
        values = INT_EDGES + [True, False, None]
    elif kind == "float":
        values = [0.0, -0.0, 1.5, -2.25e300, float("inf"), float("-inf"), 5e-324]
    elif kind == "str":
        values = ["a" * n for n in SIZES] + ["é" * 16, "日本" * 64, "\x00￿"]
    elif kind == "bytes":
        values = [b"\x00" * n for n in SIZES] + [bytearray(b"ab" * 200), memoryview(b"xyz")]
    elif kind == "list":
        values = [list(range(n)) for n in SIZES]
    elif kind == "tuple":
        values = [tuple([None] * n) for n in SIZES]
    elif kind == "dict":
        values = [{f"k{i}": i for i in range(n)} for n in SIZES] + [{b"k": 1, "s": [b"v"]}]
    else:
        values = [{"a": [1, {"b": (2, b"c", [None, True])}], "d": {"e": {"f": [[[]]]}}},
                  [7, "push", 3, {"type": "put", "value": b"\x01"}]]
    for v in values:
        b = ref_pack(v)
        assert mpack.packb(v) == b, (kind, v if not isinstance(v, (str, bytes, list)) or len(v) < 40 else len(v))
        got, want = mpack.unpackb(b), ref_unpack(b)
        assert got == want and type(got) is type(want)


def test_codec_decodes_what_it_never_writes():
    # float32 (msgpack's use_single_float), and NaN survives as NaN
    b = msgpack.packb(1.25, use_single_float=True)
    assert b[0] == 0xCA and mpack.unpackb(b) == 1.25
    assert math.isnan(mpack.unpackb(mpack.packb(float("nan"))))
    assert mpack.packb(float("nan")) == ref_pack(float("nan"))
    # non-minimal forms another writer may use
    assert mpack.unpackb(b"\xcd\x00\x05") == 5
    assert mpack.unpackb(b"\xdc\x00\x01\x01") == [1]
    assert mpack.unpackb(b"\xdf\x00\x00\x00\x01\xa1a\x02") == {"a": 2}
    assert mpack.unpackb(bytearray(b"\x91\xc0")) == [None]


def test_codec_refusals():
    for bad in ({1, 2}, object(), 1j, frozenset()):
        with pytest.raises(TypeError):
            mpack.packb(bad)
        with pytest.raises(TypeError):
            ref_pack(bad)
    for big in (2 ** 64, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            mpack.packb(big)
    # a non-str / bytes map key is refused, as msgpack 1.x's strict_map_key
    for key in (1, None, 1.5, True):
        b = ref_pack({key: 1})
        with pytest.raises(ValueError):
            ref_unpack(b)
        with pytest.raises(ValueError):
            mpack.unpackb(b)
    # every strict prefix of a frame is truncated, never a partial value
    whole = ref_pack({"id": 7, "data": [b"x" * 300, "y" * 40, 2 ** 40, -5, 1.5, None]})
    for n in range(len(whole)):
        with pytest.raises(ValueError):
            mpack.unpackb(whole[:n])
    with pytest.raises(ValueError):
        mpack.unpackb(whole + b"\x00")
    for garbage in (b"\xc1", b"\xd4\x01\x02", b"\xc7\x01\x05a", b"\xa2\xff\xfe"):
        with pytest.raises(ValueError):
            mpack.unpackb(garbage)
    with pytest.raises(TypeError):
        mpack.unpackb("not bytes")


# -------------------------------------------------------------------- wire


WIRE_MSGS = [
    [1, "hello", {"min": 2, "max": 3}],
    [5, "kv_put", {"key": "instances/ns/c/e:1f", "value": b"\x00" * 300, "lease_id": 31}],
    [0, "push", 9, {"type": "put", "key": "models/m:1", "value": b"{}", "lease_id": 2, "rev": 70000}],
    [7, "ok", [3, [{"type": "put", "key": "k", "value": b"v", "lease_id": 0, "rev": 1}]]],
    [{"t": "data"}, ref_pack({"data": {"token_ids": [128000, 5], "index": 0, "stamp": {"iid": 2 ** 40, "ep": 2 ** 40}}})],
    [8, "err", "ValueError: unknown op 'x'"],
]


@pytest.mark.parametrize("version", [2, 3])
def test_wire_pack_is_byte_identical_to_the_jax_package(version):
    for msg in WIRE_MSGS:
        assert wire.pack(msg, version=version) == j_wire.pack(msg, version=version)
    assert (wire.WIRE_MIN, wire.WIRE_MAX, wire.WIRE_VERSION, wire.MAX_FRAME) == (
        j_wire.WIRE_MIN, j_wire.WIRE_MAX, j_wire.WIRE_VERSION, j_wire.MAX_FRAME)

    async def run():
        reader = asyncio.StreamReader()
        for msg in WIRE_MSGS:
            reader.feed_data(j_wire.pack(msg, version=version))
        for msg in WIRE_MSGS:
            assert await wire.read_frame(reader) == ref_unpack(ref_pack(msg))

    asyncio.run(run())


# ------------------------------------------------ FabricState vs the JAX one


class FakeClock:
    def __init__(self) -> None:
        self.t = 1000.0

    def now(self) -> float:
        return self.t

    def wall(self) -> float:
        return self.t


def _jax_expire_due(state, now: float) -> None:
    """The JAX janitor's pass (dynamo_tpu/fabric/state.py `_janitor_loop`),
    which the port factors out as `FabricState.expire_due`."""
    for lease in [l for l in state.leases.values() if l.deadline < now]:
        state.lease_expire(lease.id)
    for q in state.queues.values():
        for mid in [mid for mid, (_, dl) in q.inflight.items() if dl < now]:
            msg, _ = q.inflight.pop(mid)
            q.ready.appendleft(msg)
            state._wake_queue(q)


def _norm(x):
    if isinstance(x, (j_state.KVEntry, t_state.KVEntry)):
        return ("entry", x.value, x.lease_id, x.create_rev, x.mod_rev)
    if hasattr(x, "payload") and hasattr(x, "id"):
        return ("msg", x.id, x.payload)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _random_ops(seed: int, n: int = 300) -> list:
    rng = random.Random(seed)
    keys = [f"{p}/{i}" for p in ("instances/ns", "models", "fence", "x") for i in range(4)]
    ops = []
    for _ in range(n):
        kind = rng.choice(["grant", "keepalive", "revoke", "put", "put", "create", "get", "prefix",
                           "delete", "delete_prefix", "qput", "qpop", "qack", "qdepth", "obj_put",
                           "obj_get", "obj_delete", "obj_list", "sub", "unsub", "pub", "advance",
                           "advance", "watch", "unwatch"])
        ops.append((kind, rng.random(), rng.choice(keys), rng.randrange(1 << 16), rng.random()))
    return ops


async def _drive(mod, expire, ops, clock) -> tuple:
    s = mod.FabricState()
    results, watch_events, deliveries = [], [], []
    watches = [s.watch_create("")]  # (wid, snapshot, queue)
    subs = []
    for kind, r, key, n, r2 in ops:
        leases = sorted(s.leases)
        lease = leases[int(r2 * len(leases))] if leases and r2 < 0.7 else (n % 5)
        try:
            if kind == "grant":
                res = s.lease_grant(1.0 + 4 * r)
            elif kind == "keepalive":
                res = s.lease_keepalive(lease)
            elif kind == "revoke":
                res = s.lease_revoke(lease)
            elif kind == "put":
                res = s.kv_put(key, bytes([n & 0xFF]), lease if r < 0.5 else 0)
            elif kind == "create":
                res = s.kv_create(key, bytes([n & 3]), lease if r < 0.5 else 0)
            elif kind == "get":
                res = s.kv_get(key)
            elif kind == "prefix":
                res = s.kv_get_prefix(key.split("/")[0])
            elif kind == "delete":
                res = s.kv_delete(key)
            elif kind == "delete_prefix":
                res = s.kv_delete_prefix(key[: 1 + n % len(key)])
            elif kind == "qput":
                res = s.queue_put(f"q{n % 2}", bytes([n & 0xFF]))
            elif kind == "qpop":
                res = await s.queue_pop(f"q{n % 2}", timeout=0)
            elif kind == "qack":
                inflight = sorted(s._queue(f"q{n % 2}").inflight)
                res = s.queue_ack(f"q{n % 2}", inflight[0] if inflight and r < 0.8 else n)
            elif kind == "qdepth":
                res = s.queue_depth(f"q{n % 2}")
            elif kind == "obj_put":
                res = s.obj_put(f"b{n % 2}", key, bytes([n & 0xFF]))
            elif kind == "obj_get":
                res = s.obj_get(f"b{n % 2}", key)
            elif kind == "obj_delete":
                res = s.obj_delete(f"b{n % 2}", key)
            elif kind == "obj_list":
                res = s.obj_list(f"b{n % 2}")
            elif kind == "sub":
                subs.append(s.subscribe(["ev.a", "ev.*", "ev.>", "ev.a.b"][n % 4], "g" if r < 0.4 else ""))
                res = subs[-1][0]
            elif kind == "unsub":
                res = None
                if subs:
                    sid, _ = subs.pop(n % len(subs))
                    s.unsubscribe(sid)
            elif kind == "pub":
                res = s.publish(["ev.a", "ev.b", "ev.a.b"][n % 3], bytes([n & 0xFF]))
            elif kind == "advance":
                clock.t += 3 * r
                expire(s, clock.t)
                res = clock.t
            elif kind == "watch":
                w = s.watch_create(key.split("/")[0])
                watches.append(w)
                res = [w[0], [e.to_wire() for e in w[1]]]
            else:  # unwatch
                res = None
                if len(watches) > 1:
                    wid, _, q = watches.pop(1 + n % (len(watches) - 1))
                    s.watch_cancel(wid)
            results.append((kind, _norm(res)))
        except Exception as e:  # noqa: BLE001 — compared like a result
            results.append((kind, "raised", type(e).__name__))
    for wid, _, q in watches:
        while not q.empty():
            ev = q.get_nowait()
            watch_events.append((wid, None if ev is None else ev.to_wire()))
    for sid, q in subs:
        while not q.empty():
            deliveries.append((sid, q.get_nowait()))
    return results, watch_events, deliveries, _norm(s.snapshot())


@pytest.mark.parametrize("seed", range(6))
async def test_fabric_state_matches_the_jax_state_on_random_ops(seed):
    ops = _random_ops(seed)
    jc, tc = FakeClock(), FakeClock()
    prev_j, prev_t = j_clock.set_clock(jc), t_clock.set_clock(tc)
    try:
        want = await _drive(j_state, _jax_expire_due, ops, jc)
        got = await _drive(t_state, lambda s, now: s.expire_due(now), ops, tc)
    finally:
        j_clock.set_clock(prev_j)
        t_clock.set_clock(prev_t)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    assert got[3] == want[3]
    assert any(k == "advance" for k, *_ in got[0]) and got[1]


# ------------------------------------------------ twins of tests/test_fabric.py


def test_subject_matching():
    assert subject_matches("a.b.c", "a.b.c")
    assert subject_matches("a.*.c", "a.b.c")
    assert subject_matches("a.>", "a.b.c")
    assert subject_matches(">", "anything.at.all")
    assert not subject_matches("a.>", "a")  # '>' needs >=1 token (NATS)
    assert not subject_matches("a.b", "a.b.c")
    assert not subject_matches("a.b.c", "a.b")
    assert not subject_matches("a.*.x", "a.b.c")


async def test_kv_put_get_delete_prefix():
    c = FabricClient.in_process(FabricState())
    await c.kv_put("instances/ns/a/ep:1", b"one")
    await c.kv_put("instances/ns/a/ep:2", b"two")
    await c.kv_put("other/key", b"x")
    assert await c.kv_get("instances/ns/a/ep:1") == b"one"
    assert await c.kv_get("missing") is None
    pfx = await c.kv_get_prefix("instances/ns/a/")
    assert set(pfx) == {"instances/ns/a/ep:1", "instances/ns/a/ep:2"}
    assert await c.kv_delete("instances/ns/a/ep:1")
    assert not await c.kv_delete("instances/ns/a/ep:1")
    assert await c.kv_delete_prefix("instances/") == 1


async def test_kv_create_cas():
    c = FabricClient.in_process(FabricState())
    assert await c.kv_create("k", b"v1")
    assert await c.kv_create("k", b"v1")  # same value validates
    assert not await c.kv_create("k", b"v2")  # different value fails


async def test_lease_expiry_removes_keys_and_notifies_watch():
    c = FabricClient.in_process(FabricState())
    lease = await c.lease_grant(0.6)
    await c.kv_put("instances/x", b"v", lease_id=lease)
    watch = await c.watch_prefix("instances/")
    assert [ev.key for ev in watch.initial] == ["instances/x"]
    # no keepalive -> janitor expires the lease and deletes the key
    ev = await asyncio.wait_for(watch.__anext__(), timeout=3.0)
    assert ev.type == "delete" and ev.key == "instances/x"
    await watch.cancel()


async def test_lease_keepalive_keeps_key():
    c = FabricClient.in_process(FabricState())
    lease = await c.lease_grant(0.6)
    await c.kv_put("k", b"v", lease_id=lease)
    for _ in range(4):
        await asyncio.sleep(0.3)
        assert await c.lease_keepalive(lease)
    assert await c.kv_get("k") == b"v"
    await c.lease_revoke(lease)
    assert await c.kv_get("k") is None


async def test_watch_streams_puts_and_deletes():
    c = FabricClient.in_process(FabricState())
    watch = await c.watch_prefix("p/")
    await c.kv_put("p/a", b"1")
    await c.kv_put("q/b", b"2")  # outside prefix: not delivered
    await c.kv_delete("p/a")
    ev1 = await asyncio.wait_for(watch.__anext__(), 1)
    ev2 = await asyncio.wait_for(watch.__anext__(), 1)
    assert (ev1.type, ev1.key, ev1.value) == ("put", "p/a", b"1")
    assert (ev2.type, ev2.key) == ("delete", "p/a")
    await watch.cancel()


async def test_pubsub_broadcast_and_queue_group():
    c = FabricClient.in_process(FabricState())
    b1 = await c.subscribe("evt.x")
    b2 = await c.subscribe("evt.>")
    g1 = await c.subscribe("evt.x", group="g")
    g2 = await c.subscribe("evt.x", group="g")
    n = await c.publish("evt.x", b"m1")
    assert n == 3  # two broadcasts + one group member
    assert (await b1.next(1))[1] == b"m1"
    assert (await b2.next(1))[1] == b"m1"
    # group delivery round-robins between members
    await c.publish("evt.x", b"m2")
    got = []
    for sub in (g1, g2):
        item = await sub.next(0.2)
        if item:
            got.append(item[1])
    assert sorted(got) == [b"m1", b"m2"]


async def test_work_queue_ack_and_redeliver():
    state = FabricState()
    c = FabricClient.in_process(state)
    state._queue("q").redeliver_after = 0.6  # fast redelivery for the test
    await c.queue_put("q", b"job1")
    assert await c.queue_depth("q") == 1
    msg = await c.queue_pop("q", timeout=1)
    assert msg is not None and msg[1] == b"job1"
    # unacked -> redelivered after timeout
    again = await c.queue_pop("q", timeout=3)
    assert again is not None and again[1] == b"job1"
    assert await c.queue_ack("q", again[0])
    assert await c.queue_depth("q") == 0
    assert await c.queue_pop("q", timeout=0.1) is None


async def test_object_store():
    c = FabricClient.in_process(FabricState())
    await c.obj_put("models", "card.json", b"{}")
    assert await c.obj_get("models", "card.json") == b"{}"
    assert await c.obj_list("models") == ["card.json"]
    assert await c.obj_delete("models", "card.json")
    assert await c.obj_get("models", "card.json") is None


async def test_remote_fabric_over_tcp():
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    try:
        c1 = await FabricClient.connect(server.addr)
        c2 = await FabricClient.connect(server.addr)
        # kv visible across clients
        await c1.kv_put("shared/k", b"v")
        assert await c2.kv_get("shared/k") == b"v"
        # watch across clients
        watch = await c2.watch_prefix("shared/")
        assert len(watch.initial) == 1
        await c1.kv_put("shared/k2", b"v2")
        ev = await asyncio.wait_for(watch.__anext__(), 2)
        assert ev.key == "shared/k2" and ev.value == b"v2"
        await watch.cancel()
        # pub/sub across clients
        sub = await c2.subscribe("topic.a")
        await asyncio.sleep(0.05)
        assert await c1.publish("topic.a", b"hello") == 1
        item = await sub.next(2)
        assert item == ("topic.a", b"hello")
        await sub.unsubscribe()
        # queue across clients
        await c1.queue_put("wq", b"task")
        msg = await c2.queue_pop("wq", timeout=2)
        assert msg is not None and msg[1] == b"task"
        assert await c2.queue_ack("wq", msg[0])
        # leases
        lease = await c1.lease_grant(5.0)
        await c1.kv_put("leased", b"x", lease_id=lease)
        assert await c1.lease_keepalive(lease)
        await c1.lease_revoke(lease)
        assert await c2.kv_get("leased") is None
        await c1.close()
        await c2.close()
    finally:
        await server.close()


# ------------------------------ twins of tests/test_fabric_ha.py (non-slow)


def _fold_queues(snap):
    return {name: sorted((m[0], m[1]) for m in q["ready"]) for name, q in snap["queues"].items()}


def _comparable(snap):
    return (
        snap["revision"], snap["next_id"], snap["kv"],
        sorted((l[0], l[1], sorted(l[3])) for l in snap["leases"]),
        _fold_queues(snap), snap["objects"],
    )


async def test_snapshot_restore_roundtrip():
    a = FabricState()
    lid = a.lease_grant(5.0)
    a.kv_put("instances/ns/w/ep-1", b"addr", lid)
    a.kv_put("models/m1", b"card")
    a.obj_put("cards", "m1", b"blob")
    a.queue_put("prefill", b"req-1")
    a.queue_put("prefill", b"req-2")
    msg = await a.queue_pop("prefill")  # goes in flight
    assert msg is not None
    b = FabricState()
    b.restore(a.snapshot(), lease_grace=30.0)
    assert b.kv_get("models/m1").value == b"card"
    assert b.kv_get("instances/ns/w/ep-1").lease_id == lid
    assert lid in b.leases
    assert b.obj_get("cards", "m1") == b"blob"
    # the in-flight message folded back into ready: at-least-once
    assert b.queue_depth("prefill") == 2
    # ids minted after restore never collide with pre-snapshot ids
    assert b.lease_grant(5.0) > lid
    # the snapshot is wire-able both ways: it crosses to a JAX standby
    snap = mpack.unpackb(mpack.packb(a.snapshot()))
    j = j_state.FabricState()
    j.restore(snap, lease_grace=30.0)
    assert j.kv_get("models/m1").value == b"card" and j.queue_depth("prefill") == 2


async def test_journal_replay_converges():
    primary = FabricState()
    replica = FabricState()
    primary.on_replicate = replica.apply_replicated

    l1 = primary.lease_grant(5.0)
    l2 = primary.lease_grant(9.0)
    primary.kv_put("a/x", b"1", l1)
    primary.kv_put("a/y", b"2", l2)
    primary.kv_create("cfg", b"v0")
    assert not primary.kv_create("cfg", b"DIFFERENT")  # CAS failure
    primary.kv_put("a/x", b"1b", l1)
    primary.kv_delete("a/y")
    m1 = primary.queue_put("q", b"j1")
    primary.queue_put("q", b"j2")
    popped = await primary.queue_pop("q")
    assert popped.id == m1
    primary.queue_ack("q", m1)  # replica must drop it from READY
    primary.obj_put("b", "o", b"data")
    primary.lease_revoke(l2)

    assert _comparable(primary.snapshot()) == _comparable(replica.snapshot())
    assert replica.queue_depth("q") == 1  # j2 only; j1 acked
    assert l2 not in replica.leases


async def test_promotion_mid_mutation_redelivers_inflight_queue():
    primary = FabricState()
    replica = FabricState()
    primary.on_replicate = replica.apply_replicated
    m1 = primary.queue_put("q", b"job-1")
    primary.queue_put("q", b"job-2")
    primary.queue_put("q", b"job-3")
    popped = await primary.queue_pop("q")
    assert popped.id == m1
    primary.queue_ack("q", m1)
    popped2 = await primary.queue_pop("q")  # in flight, NEVER acked
    assert popped2 is not None
    assert replica.queue_depth("q") == 2
    got = set()
    for _ in range(2):
        msg = await replica.queue_pop("q")
        assert msg is not None
        got.add(msg.payload)
    assert got == {b"job-2", b"job-3"}


async def test_watch_synthesizes_deletes_for_keys_missing_from_snapshot():
    from dynamo_tpu_torch.fabric.client import Watch
    from dynamo_tpu_torch.fabric.state import WatchEvent

    initial = [
        WatchEvent("put", "instances/a", b"1"),
        WatchEvent("put", "instances/b", b"2"),
        WatchEvent("put", "instances/c", b"3"),
    ]
    watch = Watch(initial, cancel_fn=lambda: None)
    assert watch.known == {"instances/a", "instances/b", "instances/c"}
    fresh = {"instances/a", "instances/c"}
    for key in sorted(watch.known - fresh):
        watch._feed(WatchEvent("delete", key))
    for key in sorted(fresh):
        watch._feed(WatchEvent("put", key, b"v"))
    events = [watch._queue.get_nowait() for _ in range(3)]
    assert (events[0].type, events[0].key) == ("delete", "instances/b")
    assert {e.key for e in events[1:]} == fresh
    assert watch.known == fresh


async def test_replica_ids_never_collide_after_promotion():
    primary = FabricState()
    replica = FabricState()
    primary.on_replicate = replica.apply_replicated
    ids = [primary.lease_grant(5.0) for _ in range(5)]
    ids.append(primary.queue_put("q", b"x"))
    fresh = replica.lease_grant(5.0)
    assert fresh > max(ids)


async def _kill(server) -> None:
    """A primary's death as its standby sees it: the listener and every
    connection gone. (The JAX package's ``FabricServer.close`` waits on the
    listener before it severs the connections, which on Python 3.12 hangs
    while one stays open; the port's severs them first.)"""
    server._server.close()
    for w in list(server._conn_writers):
        w.close()
    await server.state.close()


async def test_standby_follows_and_promotes_across_packages():
    """A port standby follows a JAX primary over the journal (and the
    reverse), then promotes when its primary goes away."""
    for primary_cls, standby_cls in ((JFabricServer, FabricServer), (FabricServer, JFabricServer)):
        primary = primary_cls("127.0.0.1", 0)
        await primary.start()
        standby = standby_cls("127.0.0.1", 0, replica_of=primary.addr)
        standby.RESYNC_ATTEMPTS = 1
        await standby.start()
        try:
            lid = primary.state.lease_grant(30.0)
            primary.state.kv_put("instances/a", b"1", lid)
            for _ in range(100):
                if standby.state.kv_get("instances/a") is not None:
                    break
                await asyncio.sleep(0.02)
            primary.state.kv_put("models/m", b"card")
            primary.state.queue_put("q", b"job")
            for _ in range(100):
                if standby.state.queue_depth("q"):
                    break
                await asyncio.sleep(0.02)
            assert _comparable(standby.state.snapshot()) == _comparable(primary.state.snapshot())
            await _kill(primary)
            await asyncio.wait_for(standby.promoted.wait(), 10)
            assert standby.role == "primary" and lid in standby.state.leases
        finally:
            await standby.close()
            await primary.close()


# -------------------------------- twins of tests/test_wire_negotiation.py


def _pack_at(version: int, msg) -> bytes:
    body = ref_pack(msg)
    return bytes([version]) + len(body).to_bytes(4, "big") + body


async def _read_raw(reader: asyncio.StreamReader):
    header = await reader.readexactly(5)
    length = int.from_bytes(header[1:], "big")
    body = await reader.readexactly(length)
    return header[0], ref_unpack(body)


async def _close(writer) -> None:
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, OSError):
        pass


class _FakeLegacyServer:
    """A pre-negotiation (v2-only) fabric server: hard-rejects any frame
    whose version byte != 2 and answers `hello` with the unknown-op error."""

    def __init__(self) -> None:
        self.addr = ""
        self.seen_versions: list[int] = []
        self._server = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        host, port = self._server.sockets[0].getsockname()[:2]
        self.addr = f"{host}:{port}"

    async def close(self) -> None:
        self._server.close()
        await self._server.wait_closed()

    async def _handle(self, reader, writer) -> None:
        kv: dict = {}
        try:
            while True:
                version, msg = await _read_raw(reader)
                self.seen_versions.append(version)
                if version != 2:
                    break
                req_id, op, a = msg
                if op == "ping":
                    reply = [req_id, "ok", "pong"]
                elif op == "kv_put":
                    kv[a["key"]] = a["value"]
                    reply = [req_id, "ok", None]
                elif op == "kv_get":
                    reply = [req_id, "ok", kv.get(a["key"])]
                else:
                    reply = [req_id, "err", f"ValueError: unknown op {op!r}"]
                writer.write(_pack_at(2, reply))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            await _close(writer)


def test_negotiate_picks_highest_common():
    assert wire.negotiate(2, 3) == wire.WIRE_MAX
    assert wire.negotiate(2, 2) == 2
    assert wire.negotiate(2, 99) == wire.WIRE_MAX
    assert wire.negotiate(wire.WIRE_MAX, 99) == wire.WIRE_MAX


def test_negotiate_disjoint_raises_structured():
    with pytest.raises(wire.WireVersionError) as ei:
        wire.negotiate(wire.WIRE_MAX + 1, wire.WIRE_MAX + 3)
    assert isinstance(ei.value, ConnectionError)
    assert ei.value.got == wire.WIRE_MAX + 3
    with pytest.raises(wire.WireVersionError):
        wire.negotiate(0, wire.WIRE_MIN - 1)


def test_read_frame_accepts_whole_range_rejects_outside():
    async def run():
        for v in range(wire.WIRE_MIN, wire.WIRE_MAX + 1):
            reader = asyncio.StreamReader()
            reader.feed_data(_pack_at(v, ["x"]))
            assert await wire.read_frame(reader) == ["x"]
        for v in (wire.WIRE_MIN - 1, wire.WIRE_MAX + 1, 99):
            reader = asyncio.StreamReader()
            reader.feed_data(_pack_at(v, ["x"]))
            with pytest.raises(wire.WireVersionError) as ei:
                await wire.read_frame(reader)
            assert ei.value.got == v
        reader = asyncio.StreamReader()
        reader.feed_data(bytes([2]) + struct.pack(">I", wire.MAX_FRAME + 1))
        with pytest.raises(ValueError):
            await wire.read_frame(reader)

    asyncio.run(run())


async def test_hello_pins_highest_common_version():
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    try:
        c = await FabricClient.connect(server.addr)
        assert c.wire_version == wire.WIRE_MAX
        assert c.status()["wire_version"] == wire.WIRE_MAX
        await c.kv_put("neg/k", b"v")
        assert await c.kv_get("neg/k") == b"v"
        watch = await c.watch_prefix("neg/")
        await c.kv_put("neg/k2", b"v2")
        ev = await asyncio.wait_for(watch.__anext__(), 2)
        assert ev.key == "neg/k2"
        await watch.cancel()
        await c.close()
    finally:
        await server.close()


async def test_legacy_client_against_new_server_stays_at_floor():
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    try:
        host, _, port = server.addr.rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(_pack_at(2, [1, "ping", {}]))
        writer.write(_pack_at(2, [2, "kv_put", {"key": "a", "value": b"1"}]))
        writer.write(_pack_at(2, [3, "kv_get", {"key": "a"}]))
        await writer.drain()
        replies = {}
        for _ in range(3):
            version, msg = await _read_raw(reader)
            assert version == 2, "reply to an un-negotiated client left v2"
            replies[msg[0]] = msg[1:]
        assert replies[1] == ["ok", "pong"]
        assert replies[3] == ["ok", b"1"]
        await _close(writer)
    finally:
        await server.close()


async def test_new_client_against_legacy_server_pins_floor():
    fake = _FakeLegacyServer()
    await fake.start()
    try:
        c = await FabricClient.connect(fake.addr)
        assert c.wire_version == wire.WIRE_MIN
        await c.kv_put("legacy/k", b"old")
        assert await c.kv_get("legacy/k") == b"old"
        assert set(fake.seen_versions) == {2}
        await c.close()
    finally:
        await fake.close()


async def test_disjoint_range_fails_loudly_not_garbage():
    """A peer whose whole range is above ours must yield the structured
    WireVersionError from connect — not a framing parse error. (The JAX
    package's twin hangs on Python 3.12: its fake peer never closes its
    side, and ``Server.wait_closed`` waits for every connection to close.
    This fake peer closes its side; the client code under test is the
    same.)"""

    async def handle(reader, writer):
        try:
            _, msg = await _read_raw(reader)
            writer.write(_pack_at(2, [
                msg[0], "err",
                "WireVersionError: fabric wire protocol mismatch: peer "
                "speaks v3, this build supports v7..v9",
            ]))
            await writer.drain()
            await reader.read()  # until the client hangs up
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            await _close(writer)

    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    host, port = srv.sockets[0].getsockname()[:2]
    try:
        with pytest.raises(ConnectionError) as ei:
            await FabricClient.connect(f"{host}:{port}")
        assert "mismatch" in str(ei.value)
        assert isinstance(ei.value.__cause__ or ei.value, ConnectionError)
    finally:
        srv.close()
        await asyncio.wait_for(srv.wait_closed(), 10)


async def test_server_rejects_hello_from_disjoint_future_range():
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    try:
        host, _, port = server.addr.rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(_pack_at(2, [1, "hello", {"min": wire.WIRE_MAX + 4, "max": wire.WIRE_MAX + 6}]))
        await writer.drain()
        _, msg = await _read_raw(reader)
        assert msg[1] == "err" and "WireVersionError" in msg[2]
        await _close(writer)
    finally:
        await server.close()


async def test_server_ignores_unknown_trailing_request_fields():
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    try:
        host, _, port = server.addr.rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(_pack_at(2, [1, "ping", {}, {"future": "field"}, "more"]))
        await writer.drain()
        _, msg = await _read_raw(reader)
        assert msg[0] == 1 and msg[1] == "ok" and msg[2] == "pong"
        await _close(writer)
    finally:
        await server.close()


async def test_client_ignores_unknown_trailing_response_and_push_fields():
    """(As the disjoint-range case: this fake peer closes its side, so the
    listening server can close under Python 3.12.)"""

    async def handle(reader, writer):
        try:
            while True:
                _, msg = await _read_raw(reader)
                req_id, op = msg[0], msg[1]
                if op == "hello":
                    writer.write(_pack_at(2, [req_id, "ok", {"version": wire.WIRE_MAX}]))
                elif op == "watch_create":
                    writer.write(_pack_at(wire.WIRE_MAX, [req_id, "ok", [7, []], "extra"]))
                    writer.write(_pack_at(wire.WIRE_MAX, [
                        0, "push", 7,
                        {"type": "put", "key": "p/x", "value": b"1", "lease_id": 0},
                        {"future": True},
                    ]))
                else:
                    writer.write(_pack_at(wire.WIRE_MAX, [req_id, "ok", "pong", "extra"]))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            await _close(writer)

    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    host, port = srv.sockets[0].getsockname()[:2]
    try:
        c = await FabricClient.connect(f"{host}:{port}")
        assert c.wire_version == wire.WIRE_MAX
        assert await c.kv_get("anything") == "pong"
        watch = await c.watch_prefix("p/")
        ev = await asyncio.wait_for(watch.__anext__(), 2)
        assert ev.key == "p/x" and ev.value == b"1"
        await c.close()
    finally:
        srv.close()
        await asyncio.wait_for(srv.wait_closed(), 10)


async def test_mixed_version_clients_observe_identical_state():
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    try:
        new_c = await FabricClient.connect(server.addr)
        old_c = await FabricClient.connect(server.addr)
        old_c.wire_version = wire.WIRE_MIN
        assert new_c.wire_version == wire.WIRE_MAX

        async def drive(c, tag: str) -> list:
            out = []
            await c.kv_put(f"mix/{tag}", tag.encode())
            out.append(await c.kv_get(f"mix/{tag}"))
            out.append(sorted(await c.kv_get_prefix("mix/")))
            lease = await c.lease_grant(5.0)
            out.append(await c.lease_keepalive(lease))
            await c.lease_revoke(lease)
            sub = await c.subscribe("mix.topic")
            await asyncio.sleep(0.05)
            await c.publish("mix.topic", b"tok")
            out.append(await sub.next(2))
            await sub.unsubscribe()
            return out

        res_old = await drive(old_c, "a")
        res_new = await drive(new_c, "b")
        assert res_old[0] == b"a" and res_new[0] == b"b"
        assert res_old[2] == res_new[2] is True
        assert res_old[3] == ("mix.topic", b"tok")
        assert res_new[3] == ("mix.topic", b"tok")
        assert sorted(await old_c.kv_get_prefix("mix/")) == sorted(await new_c.kv_get_prefix("mix/"))
        await old_c.close()
        await new_c.close()
    finally:
        await server.close()


# -------------------------------------------------------- interop over TCP


async def _interop(server_cls, client_cls) -> None:
    server = server_cls("127.0.0.1", 0)
    await server.start()
    try:
        a = await client_cls.connect(server.addr)
        b = await client_cls.connect(server.addr)
        assert a.wire_version == b.wire_version == wire.WIRE_MAX
        # kv and CAS
        await a.kv_put("i/k", b"v" * 300)
        assert await b.kv_get("i/k") == b"v" * 300
        assert await b.kv_create("i/cas", b"1") and not await a.kv_create("i/cas", b"2")
        assert await a.kv_get_prefix("i/") == {"i/k": b"v" * 300, "i/cas": b"1"}
        # watch, then lease expiry deletes a leased key and notifies it
        watch = await b.watch_prefix("lease/")
        lease = await a.lease_grant(0.6)
        await a.kv_put("lease/x", b"x", lease_id=lease)
        ev = await asyncio.wait_for(watch.__anext__(), 3)
        assert (ev.type, ev.key, ev.value, ev.lease_id) == ("put", "lease/x", b"x", lease)
        ev = await asyncio.wait_for(watch.__anext__(), 5)
        assert (ev.type, ev.key) == ("delete", "lease/x")
        assert not await a.lease_keepalive(lease)
        # the expiry wrote the epoch's fence tombstone
        assert await a.kv_get(f"fence/{lease:x}") == b"lease_expired"
        await watch.cancel()
        # pub-sub with a queue group: one delivery per group, round robin
        g1 = await a.subscribe("ev.x", group="g")
        g2 = await b.subscribe("ev.x", group="g")
        wild = await b.subscribe("ev.>")
        await asyncio.sleep(0.05)
        assert await a.publish("ev.x", b"m1") == 2
        assert await b.publish("ev.x", b"m2") == 2
        got = sorted([(await g1.next(2))[1], (await g2.next(2))[1]])
        assert got == [b"m1", b"m2"]
        assert [(await wild.next(2))[1] for _ in range(2)] == [b"m1", b"m2"]
        # work queue: pop without ack, redelivered after the server's timer
        server.state._queue("wq").redeliver_after = 0.5
        mid = await a.queue_put("wq", b"job")
        popped = await b.queue_pop("wq", timeout=2)
        assert popped == (mid, b"job") and await a.queue_depth("wq") == 1
        again = await a.queue_pop("wq", timeout=5)
        assert again == (mid, b"job")
        assert await a.queue_ack("wq", mid) and await b.queue_depth("wq") == 0
        # the object store
        await a.obj_put("mdc", "m/card.json", b"{}")
        assert await b.obj_get("mdc", "m/card.json") == b"{}"
        assert await b.obj_list("mdc") == ["m/card.json"]
        assert await a.obj_delete("mdc", "m/card.json")
        assert await b.obj_get("mdc", "m/card.json") is None
        await a.close()
        await b.close()
    finally:
        await server.close()


async def test_port_client_against_the_jax_server():
    await _interop(JFabricServer, FabricClient)


async def test_jax_client_against_the_port_server():
    await _interop(FabricServer, JFabricClient)
