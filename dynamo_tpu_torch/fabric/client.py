"""Unified fabric client: identical async API in-process or over TCP.

The port's own copy of dynamo_tpu/fabric/client.py, whole: version
negotiation, degraded-mode buffering, failover and stream re-establishment,
the ``fabric:<op>`` wire spans of calls made under a request's span, and the
fault points of ``testing/faults.py`` (``fabric_blackout`` / ``fabric_flap``:
every store operation raises ConnectionError inside the window;
``zombie_partition``: keepalives swallowed; ``drop_fabric_conn``: the TCP
link severed once after N publishes).

In-process mode wraps a process-local FabricState (the reference's "static
mode" / in-memory KeyValueStore, lib/runtime/src/storage/key_value_store/mem.rs
+ distributed.rs:113); remote mode speaks the wire protocol to a FabricServer.
"""

from __future__ import annotations

import asyncio
import contextlib
import inspect
import itertools
import logging
import os
from collections import OrderedDict, deque
from typing import Any, Callable, Optional

from dynamo_tpu_torch.fabric import wire
from dynamo_tpu_torch.fabric.state import FabricState, WatchEvent
from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.testing import faults

logger = logging.getLogger("dynamo_tpu_torch.fabric.client")


def degraded_max_s_from_env(floor: float = 0.0) -> float:
    """Total control-plane blackout the data plane rides out before giving
    up (DYN_DEGRADED_MAX_S, default 45 s): the fabric client keeps hunting
    for a primary, frontends keep routing from their last-known tables,
    and workers keep serving with publishes buffered. Past the budget the
    client fails its streams (and workers self-fence) — serving forever on
    stale state would risk double-serving once the cluster moves work."""
    try:
        v = float(os.environ.get("DYN_DEGRADED_MAX_S", "45") or 45)
    except ValueError:
        v = 45.0
    return max(floor, v)


def _degraded_buffer_size() -> int:
    try:
        return max(8, int(os.environ.get("DYN_DEGRADED_BUFFER", "256") or 256))
    except ValueError:
        return 256

# Process-local fabric shared by all in-process clients, so that several
# DistributedRuntimes in one process (e.g. tests, single-process serving)
# discover each other without a server.
_SHARED_STATE: Optional[FabricState] = None


def shared_state() -> FabricState:
    global _SHARED_STATE
    if _SHARED_STATE is None:
        _SHARED_STATE = FabricState()
    return _SHARED_STATE


def reset_shared_state() -> None:
    global _SHARED_STATE
    _SHARED_STATE = None


class Watch:
    """Async iterator of WatchEvents for a key prefix, with initial snapshot.

    Tracks the currently-known key set so a failover can replay the new
    primary's snapshot as puts and synthesize deletes for keys that
    vanished during the outage — consumers stay level-consistent without
    knowing a failover happened."""

    def __init__(self, initial: list[WatchEvent], cancel_fn) -> None:
        self.initial = initial
        self._queue: asyncio.Queue = asyncio.Queue()
        self._cancel_fn = cancel_fn
        self._done = False
        self.known: set[str] = {ev.key for ev in initial}
        self._prefix = ""  # failover re-establishment
        self._stream_id = 0

    def _feed(self, ev: Optional[WatchEvent]) -> None:
        if ev is not None:
            if ev.type == "put":
                self.known.add(ev.key)
            else:
                self.known.discard(ev.key)
        self._queue.put_nowait(ev)

    def __aiter__(self) -> "Watch":
        return self

    async def __anext__(self) -> WatchEvent:
        if self._done:
            raise StopAsyncIteration
        ev = await self._queue.get()
        if ev is None:
            self._done = True
            raise StopAsyncIteration
        return ev

    async def cancel(self) -> None:
        if not self._done:
            await self._cancel_fn()
            self._feed(None)


class Subscription:
    """Async iterator of (subject, payload) messages."""

    def __init__(self, cancel_fn) -> None:
        self._queue: asyncio.Queue = asyncio.Queue()
        self._cancel_fn = cancel_fn
        self._done = False
        self._subject = ""  # failover re-establishment
        self._group = ""
        self._stream_id = 0

    def _feed(self, item: Optional[tuple[str, bytes]]) -> None:
        self._queue.put_nowait(item)

    def __aiter__(self) -> "Subscription":
        return self

    async def __anext__(self) -> tuple[str, bytes]:
        if self._done:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is None:
            self._done = True
            raise StopAsyncIteration
        return item

    async def next(self, timeout: Optional[float] = None) -> Optional[tuple[str, bytes]]:
        try:
            return await asyncio.wait_for(self.__anext__(), timeout)
        except (asyncio.TimeoutError, StopAsyncIteration):
            return None

    async def unsubscribe(self) -> None:
        if not self._done:
            await self._cancel_fn()
            self._feed(None)


class FabricClient:
    """Async fabric API. Construct via `in_process()` or `connect(addr)`."""

    def __init__(self) -> None:
        self._state: Optional[FabricState] = None  # in-process mode
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: dict[int, asyncio.Future] = {}
        self._streams: dict[int, Any] = {}  # stream_id -> Watch|Subscription
        self._stream_kind: dict[int, str] = {}
        # live targets independent of stream ids: the failover source of
        # truth (stream ids change per connection; a partially-failed
        # re-establish must never lose track of a consumer's stream)
        self._stream_targets: dict[Any, str] = {}
        # pushes that raced ahead of the watch/subscribe response: the server
        # may emit an event for a stream before our coroutine has registered
        # it in _streams; buffer instead of dropping
        self._early_pushes: dict[int, list[Any]] = {}
        self._req_ids = itertools.count(1)
        self._read_task: Optional[asyncio.Task] = None
        self._pump_tasks: set[asyncio.Task] = set()
        self._inproc_watches: set[int] = set()
        self._inproc_subs: set[int] = set()
        self._write_lock = asyncio.Lock()
        self._conn_lost = False
        self.addr: str = ""
        # per-connection negotiated wire version (hello handshake); reset
        # to the floor on every fresh connection so the hello itself — and
        # everything sent to a legacy peer that never negotiates — is
        # parseable by any server in our supported range
        self.wire_version = wire.WIRE_VERSION
        # HA failover: all known fabric addresses (comma-separated in
        # DYN_FABRIC_ADDR); on connection loss the client hunts for the
        # promoted primary and transparently re-establishes watches/subs
        self._addrs: list[str] = []
        self._failover_s = 15.0
        self._degraded_max_s = degraded_max_s_from_env()
        self._closed = False
        self._conn_ready = asyncio.Event()
        self._failover_task: Optional[asyncio.Task] = None
        # ---- degraded mode (control-plane blackout tolerance) ----
        # `degraded_since` is set the moment the store becomes unreachable
        # (TCP loss) and cleared on
        # heal; while set, event-plane publishes and stats kv-puts land in
        # bounded rings instead of being dropped, and flush on reconnect.
        self.degraded_since: Optional[float] = None
        self.degraded_seconds_total = 0.0
        self.blackouts_total = 0
        self.buffered_publishes = 0
        self.flushed_publishes = 0
        self.dropped_publishes = 0
        size = _degraded_buffer_size()
        self._pub_ring: deque[tuple[str, bytes]] = deque(maxlen=size)
        self._kv_ring: "OrderedDict[str, tuple[bytes, int]]" = OrderedDict()
        self._kv_ring_max = size
        # zero-arg callables (sync or async) fired after a heal — the
        # reconcile-on-heal hook (re-register instances/models, re-put
        # stats keys) consumers register via DistributedRuntime
        self._reconnect_cbs: list[Callable] = []
        # set when the degraded budget was exhausted and streams were
        # closed: consumers holding for a heal must stop waiting
        self.failed_permanently = False

    # ------------------------------------------------------- construction

    @classmethod
    def in_process(cls, state: Optional[FabricState] = None) -> "FabricClient":
        c = cls()
        c._state = state if state is not None else shared_state()
        return c

    @classmethod
    async def connect(
        cls, addr: str, failover_s: Optional[float] = None
    ) -> "FabricClient":
        """`addr` may list several servers ("h1:p1,h2:p2" — primary +
        standbys, any order); the client connects to whichever reports the
        primary role and fails over to the survivor when it dies."""
        import os

        c = cls()
        c._addrs = [a.strip() for a in addr.split(",") if a.strip()]
        c._failover_s = (
            failover_s
            if failover_s is not None
            else float(os.environ.get("DYN_FABRIC_FAILOVER_S", "15"))
        )
        last_err: Optional[Exception] = None
        for a in c._addrs:
            try:
                await c._connect_to(a)
                return c
            except (OSError, RuntimeError, ConnectionError) as e:
                last_err = e
        raise ConnectionError(
            f"no reachable primary among {c._addrs}: {last_err}"
        )

    async def _connect_to(self, addr: str) -> None:
        """Open one address; reject standbys (they serve only probes).

        _conn_ready is set only AFTER the role probe passes — callers
        parked on the failover gate must never wake into a standby."""
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        self._reader, self._writer = reader, writer
        self.addr = addr
        self._conn_lost = False
        self.wire_version = wire.WIRE_VERSION  # hello goes at the floor
        self._read_task = asyncio.get_running_loop().create_task(
            self._read_loop()
        )
        await self._negotiate_version(addr, writer)
        if len(self._addrs) > 1:
            try:
                role = await self._call_raw("role")
            except Exception:
                role = "unreachable"
            if role != "primary":
                self._read_task.cancel()
                with contextlib.suppress(Exception):
                    writer.close()
                    await writer.wait_closed()
                raise ConnectionError(f"{addr} is a {role}, not the primary")
        self._conn_ready.set()

    async def _negotiate_version(
        self, addr: str, writer: asyncio.StreamWriter
    ) -> None:
        """Hello handshake: offer [WIRE_MIN, WIRE_MAX], pin the highest
        common version. A legacy server answers `unknown op` — pin the
        floor and proceed (that IS the legacy protocol). Disjoint ranges
        surface the server's structured WireVersionError: close the
        connection and fail loudly rather than mis-framing."""
        try:
            resp = await self._call_raw(
                "hello", min=wire.WIRE_MIN, max=wire.WIRE_MAX
            )
        except RuntimeError as e:
            if "unknown op" in str(e):
                self.wire_version = wire.WIRE_MIN
                return
            if self._read_task is not None:
                self._read_task.cancel()
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()
            if "WireVersionError" in str(e):
                raise wire.WireVersionError(wire.WIRE_MAX) from e
            raise ConnectionError(f"hello to {addr} failed: {e}") from e
        self.wire_version = int(resp["version"]) if resp else wire.WIRE_MIN

    @property
    def is_remote(self) -> bool:
        return self._state is None

    def _track_pump(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._pump_tasks.add(task)
        task.add_done_callback(self._pump_tasks.discard)

    def _deliver_push(self, stream_id: int, target: Any, payload: Any) -> None:
        kind = self._stream_kind.get(stream_id, "watch")
        if payload is None:
            target._feed(None)
            self._streams.pop(stream_id, None)
            self._stream_kind.pop(stream_id, None)
            self._stream_targets.pop(target, None)
        elif kind == "watch":
            target._feed(WatchEvent.from_wire(payload))
        else:
            target._feed((payload[0], payload[1]))

    def _register_stream(self, stream_id: int, target: Any, kind: str) -> None:
        self._streams[stream_id] = target
        self._stream_kind[stream_id] = kind
        self._stream_targets[target] = kind
        for payload in self._early_pushes.pop(stream_id, []):
            self._deliver_push(stream_id, target, payload)

    def _ensure_started(self) -> None:
        if self._state is not None:
            self._state.start()

    # -------------------------------------------- degraded mode (blackout)

    @property
    def connected(self) -> bool:
        """Is the store reachable right now (remote mode: a live primary
        connection)?"""
        if self.degraded_since is not None:
            return False
        return self._state is not None or self._conn_ready.is_set()

    @property
    def in_degraded_mode(self) -> bool:
        return self.degraded_since is not None

    def status(self) -> dict:
        """Control-plane health snapshot for the metrics plane
        (`dyn_fabric_connected` / `dyn_llm_degraded_*` families)."""
        dark = self.degraded_since
        extra = dclock.now() - dark if dark is not None else 0.0
        return {
            "connected": self.connected,
            "degraded": dark is not None,
            "degraded_seconds_total": self.degraded_seconds_total + extra,
            "blackouts_total": self.blackouts_total,
            "buffered_publishes": self.buffered_publishes,
            "flushed_publishes": self.flushed_publishes,
            "dropped_publishes": self.dropped_publishes,
            "wire_version": self.wire_version,
        }

    def on_reconnect(self, cb: Callable) -> None:
        """Register a zero-arg callable (sync or async) fired once per
        heal, AFTER watches/subscriptions are re-established and buffered
        publishes flushed — the reconcile-on-heal hook."""
        self._reconnect_cbs.append(cb)

    async def wait_connected(self, timeout: float) -> bool:
        """Block until the store is reachable again (or timeout). Used by
        callers that would otherwise burn retry budgets against a dark
        control plane (e.g. migration replays)."""
        end = dclock.now() + max(0.0, timeout)
        while True:
            with contextlib.suppress(ConnectionError):
                self._outage_check()
                if self.connected:
                    return True
            remaining = end - dclock.now()
            if remaining <= 0:
                return False
            if self._state is None:
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(
                        self._conn_ready.wait(), min(remaining, 0.1)
                    )
            else:
                await asyncio.sleep(min(remaining, 0.05))

    def _outage_check(self) -> None:
        """Injected-blackout fault point and heal detection, consulted at
        every store operation. Raises ConnectionError while the window is
        open; on the first call after it closed with the connection still
        up, flush the degraded buffers and fire the reconnect callbacks
        (remote natural losses heal through the failover hunt instead)."""
        if faults.active():
            inj = faults.get_injector()
            if inj is not None and inj.fabric_unreachable():
                self._note_lost("injected blackout")
                raise ConnectionError("fabric blackout (injected)")
        if self.degraded_since is not None and (
            self._state is not None or self._conn_ready.is_set()
        ):
            # fault window closed (the TCP connection never actually
            # dropped, or we're in-process): heal here
            self._note_healed("blackout window closed")

    def _note_lost(self, cause: str) -> None:
        if self.degraded_since is not None:
            return
        self.degraded_since = dclock.now()
        self.blackouts_total += 1
        logger.warning(
            "fabric unreachable (%s): DEGRADED mode — serving from "
            "last-known tables, buffering event publishes (budget %.0fs)",
            cause, self._degraded_max_s,
        )

    def _note_healed(self, how: str) -> None:
        dark = self.degraded_since
        if dark is None:
            return
        self.degraded_since = None
        elapsed = dclock.now() - dark
        self.degraded_seconds_total += elapsed
        logger.info(
            "fabric healed after %.1fs degraded (%s); flushing %d buffered "
            "publish(es) + %d stats key(s)",
            elapsed, how, len(self._pub_ring), len(self._kv_ring),
        )
        self._flush_buffers()
        self._fire_reconnect()

    @staticmethod
    def _bufferable(subject: str) -> bool:
        """Event-plane subjects (`{ns}.events.*`: KV adverts, trace
        exports, slo/brownout status) are fire-and-forget and safe to
        buffer through a blackout; request/reply subjects are not — their
        callers need the failure NOW to fall back or migrate."""
        return ".events." in subject

    def _buffer_publish(self, subject: str, payload: bytes) -> None:
        if len(self._pub_ring) == self._pub_ring.maxlen:
            self.dropped_publishes += 1
        self._pub_ring.append((subject, payload))
        self.buffered_publishes += 1

    def _buffer_kv_put(self, key: str, value: bytes, lease_id: int) -> None:
        # watch-channel semantics: the latest snapshot per key wins, so a
        # blackout's worth of metrics ticks costs one slot, not hundreds
        if key in self._kv_ring:
            self._kv_ring.pop(key)
        elif len(self._kv_ring) >= self._kv_ring_max:
            self._kv_ring.popitem(last=False)
            self.dropped_publishes += 1
        self._kv_ring[key] = (value, lease_id)
        self.buffered_publishes += 1

    def _flush_buffers(self) -> None:
        kv_items = list(self._kv_ring.items())
        self._kv_ring.clear()
        pubs = list(self._pub_ring)
        self._pub_ring.clear()
        if not kv_items and not pubs:
            return
        if self._state is not None:
            for key, (value, lease_id) in kv_items:
                if lease_id and lease_id not in self._state.leases:
                    continue  # lease died during the blackout: stale stats
                with contextlib.suppress(Exception):
                    self._state.kv_put(key, value, lease_id)
                    self.flushed_publishes += 1
            for subject, payload in pubs:
                with contextlib.suppress(Exception):
                    self._state.publish(subject, payload)
                    self.flushed_publishes += 1
            return

        async def flush_remote() -> None:
            for key, (value, lease_id) in kv_items:
                # a lease that died during the blackout makes the put
                # fail server-side; the stale snapshot is dropped
                with contextlib.suppress(Exception):
                    await self._call_raw(
                        "kv_put", key=key, value=value, lease_id=lease_id
                    )
                    self.flushed_publishes += 1
            for subject, payload in pubs:
                with contextlib.suppress(Exception):
                    await self._call_raw(
                        "publish", subject=subject, payload=payload
                    )
                    self.flushed_publishes += 1

        self._track_pump(flush_remote())

    def _fire_reconnect(self) -> None:
        for cb in list(self._reconnect_cbs):
            try:
                result = cb()
                if inspect.iscoroutine(result):
                    self._track_pump(result)
            except Exception:  # noqa: BLE001 — reconcile is best-effort
                logger.exception("fabric reconnect callback failed")

    async def close(self) -> None:
        self._closed = True
        if self._failover_task is not None:
            self._failover_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._failover_task
        if self._read_task:
            self._read_task.cancel()
        if self.is_remote:
            # terminate every consumer stream (the cancelled read loop no
            # longer does it, and a failover-in-progress holds targets
            # that are in no id map at all)
            self._fail_streams()
        if self._state is not None:
            # Unregister in-process watches/subs from the (possibly shared)
            # FabricState so its event queues don't accumulate forever. Do it
            # BEFORE touching pump tasks: cancellation feeds a terminating
            # None through the state queue, and the pumps must still be alive
            # to deliver it to iterating consumers (or they'd hang).
            for wid in list(self._inproc_watches):
                self._state.watch_cancel(wid)
            for sid in list(self._inproc_subs):
                self._state.unsubscribe(sid)
            self._inproc_watches.clear()
            self._inproc_subs.clear()
            if self._pump_tasks:
                await asyncio.wait(list(self._pump_tasks), timeout=1.0)
        for t in list(self._pump_tasks):
            t.cancel()
        if self._writer:
            with contextlib.suppress(Exception):
                self._writer.close()
                await self._writer.wait_closed()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("fabric client closed"))
        self._pending.clear()

    # ------------------------------------------------------------- remote

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                msg = await wire.read_frame(self._reader)
                # ignore-unknown-trailing-fields contract: a newer server
                # may append fields to response/push bodies
                req_id = msg[0]
                if req_id == 0:  # push
                    stream_id, payload = msg[2], msg[3]
                    target = self._streams.get(stream_id)
                    if target is None:
                        self._early_pushes.setdefault(stream_id, []).append(
                            payload
                        )
                        continue
                    self._deliver_push(stream_id, target, payload)
                else:
                    fut = self._pending.pop(req_id, None)
                    if fut is None or fut.done():
                        continue
                    if msg[1] == "ok":
                        fut.set_result(msg[2])
                    else:
                        fut.set_exception(RuntimeError(msg[2]))
        except asyncio.CancelledError:
            # deliberate cancellation (close(), or a rejected standby
            # probe connection) — never a reason to fail over; the
            # canceller owns the cleanup
            return
        except wire.WireVersionError as e:
            # version-skewed fabric peer: hunting other addresses would
            # hit the same skew — fail fast and loudly with the
            # structured mismatch so the operator sees the real cause
            logger.error("fabric connection rejected: %s", e)
            self._conn_ready.clear()
            self._conn_lost = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(e)
            self._pending.clear()
            self._fail_streams()
        except (asyncio.IncompleteReadError, ConnectionError):
            self._conn_ready.clear()
            self._conn_lost = True
            self._note_lost("connection lost")
            # in-flight calls cannot be replayed safely (their outcome on
            # the dead primary is unknown — etcd gives the same answer);
            # callers see the error and retry through the failed-over conn
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("fabric connection lost"))
            self._pending.clear()
            # hunt even with a SINGLE address: the common deployment is
            # one stable fabric endpoint whose server restarts in place
            # (supervisor/k8s) — reconnect-and-reconcile beats dying
            if self._addrs and not self._closed:
                if self._failover_task is None or self._failover_task.done():
                    self._failover_task = (
                        asyncio.get_running_loop().create_task(
                            self._failover()
                        )
                    )
            else:
                self._fail_streams()

    def _fail_streams(self) -> None:
        # terminate from the target registry, not the id map — a failover
        # that died mid-re-establish has targets missing from _streams
        for target in list(self._stream_targets):
            target._feed(None)
        self._stream_targets.clear()
        self._streams.clear()
        self._stream_kind.clear()

    async def _failover(self) -> None:
        """Hunt for the promoted primary and resume: same leases (they
        were replicated), watches replayed level-consistently, pub/sub
        re-subscribed (messages during the gap are lost — core-NATS
        at-most-once semantics, same as the reference).

        Two nested windows: within `DYN_FABRIC_FAILOVER_S` callers park on
        the connection gate (HA failover — a promoted standby is expected
        momentarily); past it the client enters DEGRADED mode — calls fail
        fast, event publishes buffer, consumers serve from their
        last-known tables — and keeps hunting with capped full-jitter
        backoff until `DYN_DEGRADED_MAX_S`. Only then do streams close
        (total blackout outlived the budget: the supervisor restarts us)."""
        from dynamo_tpu_torch.runtime.backoff import Backoff

        self._note_lost("connection lost")
        budget = max(self._degraded_max_s, self._failover_s)
        logger.warning(
            "fabric connection lost; hunting among %s (failover gate "
            "%.0fs, degraded budget %.0fs)",
            self._addrs, self._failover_s, budget,
        )
        # shared retry policy (runtime/backoff.py): exp + full jitter from
        # 100 ms up to 2 s, budgeted by the whole degraded window —
        # replaces the old flat 250 ms spin that synchronized every
        # client's hunt
        backoff = Backoff(base_s=0.1, cap_s=2.0, budget_s=budget)
        t0 = self.degraded_since if self.degraded_since is not None else (
            dclock.now()
        )
        gate_logged = False
        while not self._closed:
            for a in self._addrs:
                try:
                    await self._connect_to(a)
                    await self._reestablish_streams()
                    logger.info("fabric failover complete: now on %s", a)
                    self._note_healed(f"reconnected to {a}")
                    return
                except (OSError, RuntimeError, ConnectionError):
                    continue
            if (
                not gate_logged
                and dclock.now() - t0 > self._failover_s
            ):
                gate_logged = True
                logger.warning(
                    "failover gate (%.0fs) exhausted with no primary; "
                    "DEGRADED data plane continues on last-known tables "
                    "while hunting (budget %.0fs)",
                    self._failover_s, budget,
                )
            if not await backoff.sleep():
                break
        logger.error(
            "fabric unreachable past the %.0fs degraded budget; "
            "streams closed", budget,
        )
        self.failed_permanently = True
        self._fail_streams()

    async def _reestablish_streams(self) -> None:
        """Re-create every live watch/subscription on the new primary.
        Driven off the persistent target registry, so a failure partway
        through (new primary flaps) leaves every target re-creatable on
        the next attempt — never silently dropped."""
        self._streams.clear()
        self._stream_kind.clear()
        for target in list(self._stream_targets):
            if isinstance(target, Watch):
                wid, snapshot_wire = await self._call_raw(
                    "watch_create", prefix=target._prefix
                )
                snapshot = [WatchEvent.from_wire(d) for d in snapshot_wire]
                # keys that died with the old primary (or during the gap)
                # get synthesized deletes; current keys replay as puts —
                # consumers converge without noticing the failover
                fresh = {ev.key for ev in snapshot}
                for key in sorted(target.known - fresh):
                    target._feed(WatchEvent("delete", key))
                for ev in snapshot:
                    target._feed(ev)
                target._stream_id = wid
                self._register_stream(wid, target, "watch")
            else:
                sid = await self._call_raw(
                    "subscribe", subject=target._subject, group=target._group
                )
                target._stream_id = sid
                self._register_stream(sid, target, "sub")

    async def _call_raw(self, op: str, **kwargs: Any) -> Any:
        """Issue one call on the CURRENT connection (no failover gate —
        used by connect/role probes and stream re-establishment)."""
        assert self._writer is not None, "client not connected"
        req_id = next(self._req_ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        async with self._write_lock:
            self._writer.write(
                wire.pack([req_id, op, kwargs], version=self.wire_version)
            )
            await self._writer.drain()
        return await fut

    async def _call(
        self, op: str, *, wait_budget: Optional[float] = None, **kwargs: Any
    ) -> Any:
        # fail fast once the read loop has died: a write into the dead
        # socket often "succeeds" (kernel buffer), and with no reader the
        # pending future would hang forever. With standby addresses the
        # call WAITS for the failover to land and proceeds on the new
        # primary — but only within the failover gate: once the client is
        # past it (degraded mode, hunting on backoff), calls fail fast so
        # callers can fall back / buffer instead of stalling streams.
        # `wait_budget` clamps the gate wait further (a request with 2 s
        # of deadline left must not park on a 15 s failover gate).
        # Single-address clients hunt too (same address: the server may
        # restart in place behind a stable endpoint).
        self._outage_check()
        if not self._conn_ready.is_set():
            if self._addrs and not self._closed:
                gate = self._failover_s + 1.0
                if self.degraded_since is not None:
                    gate -= dclock.now() - self.degraded_since
                if wait_budget is not None:
                    gate = min(gate, max(0.0, wait_budget))
                if gate <= 0:
                    raise ConnectionError(
                        "fabric unreachable (degraded mode)"
                    )
                try:
                    await asyncio.wait_for(self._conn_ready.wait(), gate)
                except asyncio.TimeoutError:
                    raise ConnectionError("fabric failover timed out")
            else:
                raise ConnectionError("fabric connection lost")
        if self._conn_lost and self._read_task and self._read_task.done():
            raise ConnectionError("fabric connection lost")
        if not dtrace.enabled():
            return await self._call_raw(op, **kwargs)
        # pulls and publishes issued while a request span is active on this
        # task show up as wire hops on its timeline; background fabric
        # traffic (leases, watches) records nothing
        with dtrace.wire_span("fabric:" + op):
            return await self._call_raw(op, **kwargs)

    # ------------------------------------------------------------- leases

    async def lease_grant(self, ttl: float) -> int:
        self._outage_check()
        if self._state is not None:
            self._ensure_started()
            return self._state.lease_grant(ttl)
        return await self._call("lease_grant", ttl=ttl)

    async def lease_keepalive(self, lease_id: int) -> bool:
        if faults.active():
            inj = faults.get_injector()
            if inj is not None and inj.keepalive_swallowed(lease_id):
                # zombie_partition fault: the refresh is silently lost, and
                # True keeps the worker oblivious while the fabric's janitor
                # expires the lease and fences the epoch
                return True
        # a blackout raises ConnectionError here — STORE-UNREACHABLE, which
        # the keepalive loop treats as "keep serving, retry" (bounded by
        # the degraded budget), distinct from alive=False = LEASE-DEAD
        # which self-fences immediately
        self._outage_check()
        if self._state is not None:
            return self._state.lease_keepalive(lease_id)
        return await self._call("lease_keepalive", lease_id=lease_id)

    async def lease_revoke(self, lease_id: int) -> None:
        if self._state is not None:
            self._state.lease_revoke(lease_id)
            return
        await self._call("lease_revoke", lease_id=lease_id)

    # ----------------------------------------------------------------- kv

    async def kv_put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        try:
            self._outage_check()
            if self._state is not None:
                return self._state.kv_put(key, value, lease_id)
            return await self._call(
                "kv_put", key=key, value=value, lease_id=lease_id
            )
        except ConnectionError:
            if key.startswith("stats/"):
                # load-metrics snapshots are watch-channel state (last
                # wins): buffer the newest per key, re-put on heal
                self._buffer_kv_put(key, value, lease_id)
                return 0
            raise

    async def kv_create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        self._outage_check()
        if self._state is not None:
            return self._state.kv_create(key, value, lease_id)
        return await self._call("kv_create", key=key, value=value, lease_id=lease_id)

    async def kv_get(self, key: str) -> Optional[bytes]:
        self._outage_check()
        if self._state is not None:
            e = self._state.kv_get(key)
            return None if e is None else e.value
        return await self._call("kv_get", key=key)

    async def kv_get_prefix(self, prefix: str) -> dict[str, bytes]:
        self._outage_check()
        if self._state is not None:
            return {
                k: e.value for k, e in self._state.kv_get_prefix(prefix).items()
            }
        return await self._call("kv_get_prefix", prefix=prefix)

    async def kv_delete(self, key: str) -> bool:
        if self._state is not None:
            return self._state.kv_delete(key)
        return await self._call("kv_delete", key=key)

    async def kv_delete_prefix(self, prefix: str) -> int:
        if self._state is not None:
            return self._state.kv_delete_prefix(prefix)
        return await self._call("kv_delete_prefix", prefix=prefix)

    # -------------------------------------------------------------- watch

    async def watch_prefix(self, prefix: str) -> Watch:
        self._outage_check()
        if self._state is not None:
            self._ensure_started()
            wid, snapshot, q = self._state.watch_create(prefix)
            self._inproc_watches.add(wid)

            async def cancel() -> None:
                self._inproc_watches.discard(wid)
                self._state.watch_cancel(wid)

            watch = Watch(snapshot, cancel)

            async def pump() -> None:
                with contextlib.suppress(asyncio.CancelledError):
                    while True:
                        ev = await q.get()
                        watch._feed(ev)
                        if ev is None:
                            self._inproc_watches.discard(wid)
                            return

            self._track_pump(pump())
            return watch

        wid, snapshot_wire = await self._call("watch_create", prefix=prefix)

        async def cancel_remote() -> None:
            # _stream_id may have been remapped by a failover
            cur = watch._stream_id
            self._streams.pop(cur, None)
            self._stream_kind.pop(cur, None)
            self._stream_targets.pop(watch, None)
            with contextlib.suppress(Exception):
                await self._call("watch_cancel", watch_id=cur)

        watch = Watch([WatchEvent.from_wire(d) for d in snapshot_wire], cancel_remote)
        watch._prefix = prefix
        watch._stream_id = wid
        self._register_stream(wid, watch, "watch")
        return watch

    # ------------------------------------------------------------ pub/sub

    async def subscribe(self, subject: str, group: str = "") -> Subscription:
        self._outage_check()
        if self._state is not None:
            self._ensure_started()
            sid, q = self._state.subscribe(subject, group)
            self._inproc_subs.add(sid)

            async def cancel() -> None:
                self._inproc_subs.discard(sid)
                self._state.unsubscribe(sid)

            sub = Subscription(cancel)

            async def pump() -> None:
                with contextlib.suppress(asyncio.CancelledError):
                    while True:
                        item = await q.get()
                        sub._feed(item)
                        if item is None:
                            self._inproc_subs.discard(sid)
                            return

            self._track_pump(pump())
            return sub

        sid = await self._call("subscribe", subject=subject, group=group)

        async def cancel_remote() -> None:
            cur = sub._stream_id
            self._streams.pop(cur, None)
            self._stream_kind.pop(cur, None)
            self._stream_targets.pop(sub, None)
            with contextlib.suppress(Exception):
                await self._call("unsubscribe", sub_id=cur)

        sub = Subscription(cancel_remote)
        sub._subject = subject
        sub._group = group
        sub._stream_id = sid
        self._register_stream(sid, sub, "sub")
        return sub

    async def publish(
        self, subject: str, payload: bytes, timeout: Optional[float] = None
    ) -> int:
        """Publish one message. `timeout` clamps how long the call may
        park on a failover gate (request-scoped callers pass their
        remaining deadline budget). While the store is unreachable,
        event-plane subjects buffer in a bounded ring (flushed on heal);
        anything else raises so the caller can fall back or migrate."""
        try:
            self._outage_check()
            if self._state is not None:
                return self._state.publish(subject, payload)
        except ConnectionError:
            if self._bufferable(subject):
                self._buffer_publish(subject, payload)
                return 0
            raise
        if faults.active():
            inj = faults.get_injector()
            if inj is not None and inj.should_drop_fabric() and self._writer is not None:
                # injected connection drop: sever the TCP link so the
                # failover path (connection loss -> hunt the primary ->
                # re-establish watches and subscriptions) runs
                self._writer.close()
        try:
            return await self._call(
                "publish", subject=subject, payload=payload,
                wait_budget=timeout,
            )
        except ConnectionError:
            if self._bufferable(subject):
                self._buffer_publish(subject, payload)
                return 0
            raise

    # ------------------------------------------------------------- queues

    async def queue_put(
        self, name: str, payload: bytes, timeout: Optional[float] = None
    ) -> int:
        """Enqueue one work item; raises ConnectionError FAST when the
        queue plane is dark (degraded mode) so disagg callers fall back to
        local prefill instead of wedging. `timeout` additionally clamps
        the failover-gate wait to the request's remaining budget."""
        self._outage_check()
        if self._state is not None:
            self._ensure_started()
            return self._state.queue_put(name, payload)
        return await self._call(
            "queue_put", name=name, payload=payload, wait_budget=timeout
        )

    async def queue_pop(
        self, name: str, timeout: Optional[float] = None
    ) -> Optional[tuple[int, bytes]]:
        self._outage_check()
        if self._state is not None:
            msg = await self._state.queue_pop(name, timeout)
            return None if msg is None else (msg.id, msg.payload)
        res = await self._call(
            "queue_pop", name=name, timeout=timeout, wait_budget=timeout
        )
        return None if res is None else (res[0], res[1])

    async def queue_ack(self, name: str, msg_id: int) -> bool:
        if self._state is not None:
            return self._state.queue_ack(name, msg_id)
        return await self._call("queue_ack", name=name, msg_id=msg_id)

    async def queue_depth(self, name: str) -> int:
        if self._state is not None:
            return self._state.queue_depth(name)
        return await self._call("queue_depth", name=name)

    # ------------------------------------------------------------ objects

    async def obj_put(self, bucket: str, name: str, data: bytes) -> None:
        if self._state is not None:
            self._state.obj_put(bucket, name, data)
            return
        await self._call("obj_put", bucket=bucket, name=name, data=data)

    async def obj_get(self, bucket: str, name: str) -> Optional[bytes]:
        if self._state is not None:
            return self._state.obj_get(bucket, name)
        return await self._call("obj_get", bucket=bucket, name=name)

    async def obj_delete(self, bucket: str, name: str) -> bool:
        if self._state is not None:
            return self._state.obj_delete(bucket, name)
        return await self._call("obj_delete", bucket=bucket, name=name)

    async def obj_list(self, bucket: str) -> list[str]:
        if self._state is not None:
            return self._state.obj_list(bucket)
        return await self._call("obj_list", bucket=bucket)
