"""In-memory fabric state machine: kv+lease+watch, pub/sub, queues, objects.

The port's own copy of dynamo_tpu/fabric/state.py, whole but for the
fault-injection hook of the janitor (a blackout that freezes it); the
janitor's pass is ``expire_due``.

Single-writer semantics: all mutations happen on one asyncio event loop (either
the fabric server's loop, or the process's own loop in in-process mode), so no
locks are needed — mirroring the reference's actor-ish single-threaded-behind-
a-channel designs (e.g. lib/llm/src/kv_router/indexer.rs:518-690).

Capability map to the reference:
  kv_put/kv_get/kv_get_prefix/kv_delete/kv_create (CAS)/watch_prefix/leases
      -> transports/etcd.rs:103-404 (kv_create_or_validate :203, watch :312)
  publish/subscribe(+queue groups)
      -> transports/nats.rs service groups / core pub-sub
  queue_put/queue_pop (ack/redeliver)
      -> transports/nats.rs:345-480 NatsQueue (JetStream work queue)
  obj_put/obj_get
      -> transports/nats.rs:123-196 object store (model-card upload)
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from dynamo_tpu_torch.runtime import clock as dclock

logger = logging.getLogger("dynamo_tpu_torch.fabric")


@dataclass
class KVEntry:
    value: bytes
    lease_id: int = 0
    create_rev: int = 0
    mod_rev: int = 0


@dataclass
class WatchEvent:
    type: str  # "put" | "delete"
    key: str
    value: bytes = b""
    lease_id: int = 0
    rev: int = 0

    def to_wire(self) -> dict:
        return {
            "type": self.type,
            "key": self.key,
            "value": self.value,
            "lease_id": self.lease_id,
            "rev": self.rev,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "WatchEvent":
        return cls(
            type=d["type"],
            key=d["key"],
            value=d.get("value", b""),
            lease_id=d.get("lease_id", 0),
            rev=d.get("rev", 0),
        )


@dataclass
class _Lease:
    id: int
    ttl: float
    deadline: float
    keys: set[str] = field(default_factory=set)


@dataclass
class _Watcher:
    id: int
    prefix: str
    queue: "asyncio.Queue[Optional[WatchEvent]]"


@dataclass
class _Subscription:
    id: int
    subject: str  # may end with ".>" wildcard
    group: str  # "" = broadcast subscriber
    queue: "asyncio.Queue[Optional[tuple[str, bytes]]]"  # (subject, payload)


@dataclass
class _QueueMsg:
    id: int
    payload: bytes


class _WorkQueue:
    """Pull-based at-least-once work queue with ack + timed redelivery."""

    def __init__(self, name: str, redeliver_after: float = 30.0) -> None:
        self.name = name
        self.ready: deque[_QueueMsg] = deque()
        self.inflight: dict[int, tuple[_QueueMsg, float]] = {}
        self.redeliver_after = redeliver_after
        self.waiters: deque[asyncio.Future] = deque()

    def depth(self) -> int:
        return len(self.ready) + len(self.inflight)


def _replicated(fn):
    """Journal a successful mutation to `on_replicate` (primary->standby
    stream). Hooked at the STATE layer, not the server dispatch, so
    internally-driven mutations — the janitor expiring a lease — replicate
    too. Nested mutators (kv_create -> kv_put, lease_revoke -> deletes)
    journal only the outermost call; replicas replay it whole."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        self._mut_depth += 1
        try:
            result = fn(self, *args, **kwargs)
        finally:
            self._mut_depth -= 1
        if self._mut_depth == 0 and self.on_replicate is not None:
            bound = sig.bind(self, *args, **kwargs)
            bound.apply_defaults()
            a = {k: v for k, v in bound.arguments.items() if k != "self"}
            self.on_replicate(fn.__name__, a, result)
        return result

    return wrapper


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style: tokens split on '.', '*' matches one token, '>' the rest."""
    if pattern == subject:
        return True
    pt = pattern.split(".")
    st = subject.split(".")
    for i, tok in enumerate(pt):
        if tok == ">":
            return i < len(st)  # '>' matches one or more remaining tokens
        if i >= len(st):
            return False
        if tok != "*" and tok != st[i]:
            return False
    return len(pt) == len(st)


class FabricState:
    """The complete control-plane state. All methods are loop-affine."""

    def __init__(self) -> None:
        self.kv: dict[str, KVEntry] = {}
        self.revision = 0
        self.leases: dict[int, _Lease] = {}
        self.watchers: dict[int, _Watcher] = {}
        self.subs: dict[int, _Subscription] = {}
        self.queues: dict[str, _WorkQueue] = {}
        self.objects: dict[str, dict[str, bytes]] = {}
        # plain int (not itertools.count) so a standby can pin its counter
        # past ids minted by the primary (see apply_replicated)
        self._next_id = 1
        self._group_rr: dict[tuple[str, str], int] = {}
        self._janitor: Optional[asyncio.Task] = None
        # HA journal hook: (op, kwargs, result) per outermost mutation
        self.on_replicate: Optional[Callable[[str, dict, Any], None]] = None
        self._mut_depth = 0

    def next_id(self) -> int:
        n = self._next_id
        self._next_id += 1
        return n

    def _pin_id(self, used: int) -> None:
        """Ensure future next_id() calls never re-mint `used` (replication:
        ids assigned by the primary must stay unique after promotion)."""
        if used >= self._next_id:
            self._next_id = used + 1

    def start(self) -> None:
        if self._janitor is None or self._janitor.done():
            self._janitor = asyncio.get_running_loop().create_task(
                self._janitor_loop()
            )

    async def close(self) -> None:
        if self._janitor is not None:
            self._janitor.cancel()
            self._janitor = None

    async def _janitor_loop(self) -> None:
        """Expire dead leases and redeliver unacked queue messages."""
        try:
            while True:
                await asyncio.sleep(0.5)
                self.expire_due(dclock.now())
        except asyncio.CancelledError:
            pass

    def expire_due(self, now: float) -> None:
        """One janitor pass at ``now``: fence and revoke every lease past its
        deadline, put every in-flight queue message past its redelivery
        time back at the head of its queue."""
        for lease in [l for l in self.leases.values() if l.deadline < now]:
            logger.info("lease %d expired; fencing + revoking", lease.id)
            self.lease_expire(lease.id)
        for q in self.queues.values():
            expired = [mid for mid, (_, dl) in q.inflight.items() if dl < now]
            for mid in expired:
                msg, _ = q.inflight.pop(mid)
                q.ready.appendleft(msg)
                self._wake_queue(q)

    # ------------------------------------------------------------- leases

    @_replicated
    def lease_grant(self, ttl: float) -> int:
        lease_id = self.next_id()
        self.leases[lease_id] = _Lease(
            id=lease_id, ttl=ttl, deadline=dclock.now() + ttl
        )
        return lease_id

    @_replicated
    def lease_keepalive(self, lease_id: int) -> bool:
        lease = self.leases.get(lease_id)
        if lease is None:
            return False
        lease.deadline = dclock.now() + lease.ttl
        return True

    @_replicated
    def lease_revoke(self, lease_id: int) -> None:
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        for key in list(lease.keys):
            self._delete_key(key)

    @_replicated
    def lease_expire(self, lease_id: int) -> None:
        """Expiry (as opposed to graceful revoke) is the cluster's
        declaration that the holder is DEAD: write a permanent fencing
        tombstone under ``fence/{lease:x}`` before revoking, so every
        consumer watching the fence prefix rejects data-plane frames the
        (possibly partitioned, still-running) holder keeps emitting —
        the role etcd lease fencing plays for the reference
        (transports/etcd.rs:51-166). Tombstones are unleased and never
        deleted: un-fencing an epoch would reopen the zombie window."""
        from dynamo_tpu_torch.runtime.fencing import fence_key

        if lease_id in self.leases:
            self.kv_put(fence_key(lease_id), b"lease_expired")
        self.lease_revoke(lease_id)

    # ----------------------------------------------------------------- kv

    def _notify(self, ev: WatchEvent) -> None:
        for w in self.watchers.values():
            if ev.key.startswith(w.prefix):
                w.queue.put_nowait(ev)

    @_replicated
    def kv_put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        if lease_id and lease_id not in self.leases:
            raise KeyError(f"unknown lease {lease_id}")
        self.revision += 1
        prev = self.kv.get(key)
        entry = KVEntry(
            value=value,
            lease_id=lease_id,
            create_rev=prev.create_rev if prev else self.revision,
            mod_rev=self.revision,
        )
        if prev and prev.lease_id and prev.lease_id != lease_id:
            old = self.leases.get(prev.lease_id)
            if old:
                old.keys.discard(key)
        self.kv[key] = entry
        if lease_id:
            self.leases[lease_id].keys.add(key)
        self._notify(
            WatchEvent("put", key, value, lease_id=lease_id, rev=self.revision)
        )
        return self.revision

    @_replicated
    def kv_create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        """CAS create: fails if the key exists with a different value
        (reference etcd.rs:203 kv_create_or_validate). On a matching value
        the key is re-bound to the caller's lease, so a process restarting
        within its old lease's grace period owns the key again."""
        existing = self.kv.get(key)
        if existing is not None:
            if existing.value != value:
                return False
            if existing.lease_id != lease_id:
                self.kv_put(key, value, lease_id)  # re-bind lease
            return True
        self.kv_put(key, value, lease_id)
        return True

    def kv_get(self, key: str) -> Optional[KVEntry]:
        return self.kv.get(key)

    def kv_get_prefix(self, prefix: str) -> dict[str, KVEntry]:
        return {k: v for k, v in self.kv.items() if k.startswith(prefix)}

    def _delete_key(self, key: str) -> bool:
        entry = self.kv.pop(key, None)
        if entry is None:
            return False
        if entry.lease_id:
            lease = self.leases.get(entry.lease_id)
            if lease:
                lease.keys.discard(key)
        self.revision += 1
        self._notify(WatchEvent("delete", key, rev=self.revision))
        return True

    @_replicated
    def kv_delete(self, key: str) -> bool:
        return self._delete_key(key)

    @_replicated
    def kv_delete_prefix(self, prefix: str) -> int:
        keys = [k for k in self.kv if k.startswith(prefix)]
        for k in keys:
            self._delete_key(k)
        return len(keys)

    # -------------------------------------------------------------- watch

    def watch_create(self, prefix: str) -> tuple[int, list[WatchEvent], asyncio.Queue]:
        """Returns (watch_id, initial snapshot as synthetic puts, event queue)."""
        wid = self.next_id()
        q: asyncio.Queue = asyncio.Queue()
        self.watchers[wid] = _Watcher(id=wid, prefix=prefix, queue=q)
        snapshot = [
            WatchEvent("put", k, e.value, lease_id=e.lease_id, rev=e.mod_rev)
            for k, e in sorted(self.kv_get_prefix(prefix).items())
        ]
        return wid, snapshot, q

    def watch_cancel(self, watch_id: int) -> None:
        w = self.watchers.pop(watch_id, None)
        if w is not None:
            w.queue.put_nowait(None)

    # ------------------------------------------------------------ pub/sub

    def subscribe(self, subject: str, group: str = "") -> tuple[int, asyncio.Queue]:
        sid = self.next_id()
        q: asyncio.Queue = asyncio.Queue()
        self.subs[sid] = _Subscription(id=sid, subject=subject, group=group, queue=q)
        return sid, q

    def unsubscribe(self, sub_id: int) -> None:
        sub = self.subs.pop(sub_id, None)
        if sub is not None:
            sub.queue.put_nowait(None)

    def publish(self, subject: str, payload: bytes) -> int:
        """Deliver to all broadcast subscribers + one member per queue group.
        Returns the number of deliveries."""
        delivered = 0
        groups: dict[tuple[str, str], list[_Subscription]] = {}
        for sub in self.subs.values():
            if not subject_matches(sub.subject, subject):
                continue
            if sub.group:
                groups.setdefault((sub.subject, sub.group), []).append(sub)
            else:
                sub.queue.put_nowait((subject, payload))
                delivered += 1
        for key, members in groups.items():
            members.sort(key=lambda s: s.id)
            idx = self._group_rr.get(key, 0) % len(members)
            self._group_rr[key] = idx + 1
            members[idx].queue.put_nowait((subject, payload))
            delivered += 1
        return delivered

    # ------------------------------------------------------------- queues

    def _queue(self, name: str) -> _WorkQueue:
        q = self.queues.get(name)
        if q is None:
            q = self.queues[name] = _WorkQueue(name)
        return q

    def _wake_queue(self, q: _WorkQueue) -> None:
        while q.waiters and q.ready:
            fut = q.waiters.popleft()
            if fut.done():
                continue
            msg = q.ready.popleft()
            q.inflight[msg.id] = (msg, dclock.now() + q.redeliver_after)
            fut.set_result(msg)

    @_replicated
    def queue_put(self, name: str, payload: bytes) -> int:
        q = self._queue(name)
        msg = _QueueMsg(id=self.next_id(), payload=payload)
        q.ready.append(msg)
        self._wake_queue(q)
        return msg.id

    async def queue_pop(
        self, name: str, timeout: Optional[float] = None
    ) -> Optional[_QueueMsg]:
        """Pop one message; it stays in-flight until acked or redelivery."""
        q = self._queue(name)
        if q.ready:
            msg = q.ready.popleft()
            q.inflight[msg.id] = (msg, dclock.now() + q.redeliver_after)
            return msg
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        q.waiters.append(fut)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            if not fut.done():
                fut.cancel()
            return None
        except asyncio.CancelledError:
            # A message may have been assigned to us concurrently; requeue it
            # so it isn't lost, then propagate the cancellation.
            if fut.done() and not fut.cancelled():
                msg = fut.result()
                q.inflight.pop(msg.id, None)
                q.ready.appendleft(msg)
                self._wake_queue(q)
            else:
                fut.cancel()
            raise

    @_replicated
    def queue_ack(self, name: str, msg_id: int) -> bool:
        q = self._queue(name)
        return q.inflight.pop(msg_id, None) is not None

    def queue_depth(self, name: str) -> int:
        return self._queue(name).depth()

    # ------------------------------------------------------------ objects

    @_replicated
    def obj_put(self, bucket: str, name: str, data: bytes) -> None:
        self.objects.setdefault(bucket, {})[name] = data

    def obj_get(self, bucket: str, name: str) -> Optional[bytes]:
        return self.objects.get(bucket, {}).get(name)

    @_replicated
    def obj_delete(self, bucket: str, name: str) -> bool:
        b = self.objects.get(bucket)
        if b is None:
            return False
        return b.pop(name, None) is not None

    def obj_list(self, bucket: str) -> list[str]:
        return sorted(self.objects.get(bucket, {}).keys())

    # ------------------------------------------------- replication (HA)
    # The reference's availability story is raft etcd + clustered NATS;
    # ours is primary/standby: the primary journals every successful
    # mutating op (op, kwargs, result) to standbys, which apply it with
    # apply_replicated — deterministic because the only nondeterminism,
    # id assignment, is pinned from the primary's result. queue POPS are
    # deliberately not replicated: a standby keeps messages ready, so
    # promotion redelivers anything the dead primary had in flight
    # (at-least-once, the same contract as the 30 s redelivery timer).

    def snapshot(self) -> dict:
        """Full durable state as a msgpack-able dict (watches and subs are
        connection-local and die with their connections)."""
        now = dclock.now()
        return {
            "revision": self.revision,
            "next_id": self._next_id,
            "kv": {
                k: [e.value, e.lease_id, e.create_rev, e.mod_rev]
                for k, e in self.kv.items()
            },
            "leases": [
                [l.id, l.ttl, max(0.0, l.deadline - now), sorted(l.keys)]
                for l in self.leases.values()
            ],
            "queues": {
                name: {
                    "redeliver_after": q.redeliver_after,
                    # in-flight joins ready: the importer redelivers
                    "ready": [
                        [m.id, m.payload]
                        for m in list(q.ready)
                        + [m for m, _ in q.inflight.values()]
                    ],
                }
                for name, q in self.queues.items()
            },
            "objects": {
                b: dict(items) for b, items in self.objects.items()
            },
        }

    def restore(self, snap: dict, lease_grace: float = 0.0) -> None:
        """Replace state from a snapshot. `lease_grace` widens every lease
        deadline (promotion: clients need time to fail over before their
        instances vanish)."""
        now = dclock.now()
        self.kv = {
            k: KVEntry(value=v[0], lease_id=v[1], create_rev=v[2], mod_rev=v[3])
            for k, v in snap["kv"].items()
        }
        self.revision = snap["revision"]
        self._next_id = snap["next_id"]
        self.leases = {
            lid: _Lease(
                id=lid, ttl=ttl,
                deadline=now + max(remaining, lease_grace),
                keys=set(keys),
            )
            for lid, ttl, remaining, keys in snap["leases"]
        }
        self.queues = {}
        for name, qd in snap["queues"].items():
            q = _WorkQueue(name, redeliver_after=qd["redeliver_after"])
            q.ready.extend(_QueueMsg(id=m[0], payload=m[1]) for m in qd["ready"])
            self.queues[name] = q
        self.objects = {
            b: dict(items) for b, items in snap["objects"].items()
        }

    def grace_all_leases(self, grace: float) -> None:
        """Extend every lease to at least now+grace (promotion time: the
        fleet must get a failover window before instances expire)."""
        floor = dclock.now() + grace
        for lease in self.leases.values():
            lease.deadline = max(lease.deadline, floor)

    def apply_replicated(self, op: str, a: dict, result) -> None:
        """Apply one journaled mutation from the primary."""
        if op == "lease_grant":
            self._pin_id(result)
            self.leases[result] = _Lease(
                id=result, ttl=a["ttl"],
                deadline=dclock.now() + a["ttl"],
            )
        elif op == "lease_keepalive":
            self.lease_keepalive(a["lease_id"])
        elif op == "lease_revoke":
            self.lease_revoke(a["lease_id"])
        elif op == "lease_expire":
            self.lease_expire(a["lease_id"])
        elif op == "kv_put":
            # pin the revision so replica mod_revs match the primary's
            self.revision = result - 1
            self.kv_put(a["key"], a["value"], a.get("lease_id", 0))
        elif op == "kv_create":
            if result:
                self.kv_create(a["key"], a["value"], a.get("lease_id", 0))
        elif op == "kv_delete":
            self.kv_delete(a["key"])
        elif op == "kv_delete_prefix":
            self.kv_delete_prefix(a["prefix"])
        elif op == "queue_put":
            self._pin_id(result)
            q = self._queue(a["name"])
            q.ready.append(_QueueMsg(id=result, payload=a["payload"]))
            self._wake_queue(q)
        elif op == "queue_ack":
            q = self._queue(a["name"])
            if q.inflight.pop(a["msg_id"], None) is None:
                # pops are not replicated, so the acked message is still
                # sitting in this replica's ready deque — drop it there
                for i, m in enumerate(q.ready):
                    if m.id == a["msg_id"]:
                        del q.ready[i]
                        break
        elif op == "obj_put":
            self.obj_put(a["bucket"], a["name"], a["data"])
        elif op == "obj_delete":
            self.obj_delete(a["bucket"], a["name"])
        else:
            logger.warning("unknown replicated op %r ignored", op)
