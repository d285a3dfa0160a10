"""Fabric TCP server: exposes a FabricState over the msgpack wire protocol.

The port's own copy of dynamo_tpu/fabric/server.py, whole: the same ops,
the hot standby (journal, peer boot, follow, promote) and the CLI. Its
frames are byte-identical to the JAX package's, so a client of either
package talks to a server of either.

The external infrastructure process of a dynamo_tpu cluster, playing the
role that the etcd + NATS server pair plays for the reference
(deploy/metrics/docker-compose.yml runs both; we run one).

    python -m dynamo_tpu_torch.fabric.server --host 0.0.0.0 --port 6650

High availability (the reference's raft-etcd + clustered-NATS role):
a standby replicates the primary and promotes itself when the primary
dies; clients carry both addresses and fail over.

    python -m dynamo_tpu_torch.fabric.server --port 6651 --replica-of host:6650

The primary journals every successful mutation (state.py @_replicated)
to standby connections in order; the standby applies them to an identical
state machine. Queue pops and watches/subscriptions are connection-local
and deliberately not replicated: promotion redelivers in-flight queue
messages (at-least-once, same as the redelivery timer) and failover
clients re-establish their watches against the new primary's snapshot.
On promotion every lease gets a grace window so the fleet can reconnect
before its instances expire.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import logging
from typing import Any, Optional

from dynamo_tpu_torch.fabric import wire
from dynamo_tpu_torch.fabric.state import FabricState

logger = logging.getLogger("dynamo_tpu_torch.fabric.server")

PROMOTION_LEASE_GRACE_S = 10.0


class _Conn:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.watch_tasks: dict[int, asyncio.Task] = {}
        self.sub_tasks: dict[int, asyncio.Task] = {}
        self.leases: set[int] = set()
        self.write_lock = asyncio.Lock()
        # pinned by the hello handshake; stays at the floor for clients
        # too old to negotiate (they never send hello)
        self.version = wire.WIRE_VERSION

    async def send(self, msg: Any) -> None:
        async with self.write_lock:
            self.writer.write(wire.pack(msg, version=self.version))
            await self.writer.drain()


class FabricServer:
    """One HA member. Three start modes:

    * plain primary (no replica_of/peer) — the classic single server.
    * `replica_of=addr` — explicit standby: syncs from that primary
      (retrying forever until the FIRST sync — a standby that has never
      seen the primary must not promote an empty state) and promotes
      when an established primary stays dead past the resync window.
    * `peer=addr, advertise=own` — symmetric auto-role for supervised
      deployments (k8s restarts a pod with its original args, so roles
      cannot be baked into the command line): probe the peer at boot;
      follow it if it is primary, else the lexically-smaller advertise
      address claims primacy and the other follows. A restarted member
      therefore rejoins as standby of the survivor instead of booting
      as a second empty primary.
    """

    RESYNC_ATTEMPTS = 4  # established-primary blips tolerated (1s apart)

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6650,
        replica_of: Optional[str] = None,
        peer: Optional[str] = None,
        advertise: Optional[str] = None,
    ) -> None:
        if replica_of and peer:
            raise ValueError("--replica-of and --peer are exclusive")
        if peer and not advertise:
            raise ValueError("--peer requires --advertise")
        self.host = host
        self.port = port
        self.state = FabricState()
        self.role = "standby" if (replica_of or peer) else "primary"
        self.replica_of = replica_of
        self.peer = peer
        self.advertise = advertise
        self._server: Optional[asyncio.base_events.Server] = None
        # standby connections fed by the journal hook; each has an
        # ordered queue + pump task (order is the replication contract)
        self._replicas: dict[int, tuple[asyncio.Queue, asyncio.Task]] = {}
        self._replica_ids = 0
        self._repl_task: Optional[asyncio.Task] = None
        self.promoted = asyncio.Event()
        # live client connections, severed on close() so clients notice
        # the death immediately (instead of waiting on a silent socket)
        self._conn_writers: set[asyncio.StreamWriter] = set()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        if self.role == "primary":
            self.state.start()
            self.state.on_replicate = self._journal
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logger.info(
            "fabric server (%s) listening on %s:%d",
            self.role, self.host, self.port,
        )
        if self.role == "standby":
            self._repl_task = asyncio.get_running_loop().create_task(
                self._peer_boot() if self.peer else self._follow_primary()
            )

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._repl_task is not None:
            self._repl_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._repl_task
        for q, t in self._replicas.values():
            t.cancel()
        self._replicas.clear()
        if self._server is not None:
            self._server.close()
        # sever the client connections BEFORE waiting on the listener: since
        # Python 3.12 ``Server.wait_closed`` waits for every connection to
        # close, so the other order hangs while a client stays connected
        for w in list(self._conn_writers):
            with contextlib.suppress(Exception):
                w.close()
        self._conn_writers.clear()
        if self._server is not None:
            await self._server.wait_closed()
        await self.state.close()

    # -------------------------------------------------------- replication

    def _journal(self, op: str, kwargs: dict, result: Any) -> None:
        """State-layer hook: fan one mutation out to every standby, in
        order (the enqueue happens synchronously on the mutating loop)."""
        for q, _ in self._replicas.values():
            q.put_nowait([op, kwargs, result])

    async def _pump_replica(self, conn: _Conn, rid: int, q: asyncio.Queue) -> None:
        try:
            while True:
                entry = await q.get()
                await conn.send([0, "repl", rid, entry])
        except (ConnectionError, asyncio.CancelledError):
            self._replicas.pop(rid, None)

    async def _peer_boot(self) -> None:
        """Symmetric auto-role: follow the peer if it is primary, else
        claim primacy iff our advertise address sorts first. The
        designated secondary waits for its peer instead of self-promoting
        with empty state — a two-member pair has no quorum, so 'peer
        unreachable at cold boot' must not mint a second primary."""
        assert self.peer is not None and self.advertise is not None
        waits = 0
        while True:
            role = await self._probe_role(self.peer)
            if role == "primary":
                self.replica_of = self.peer
                await self._follow_primary()
                return
            if self.advertise < self.peer:
                logger.info(
                    "peer %s is %s; claiming primary (tie-break %s < %s)",
                    self.peer, role or "unreachable",
                    self.advertise, self.peer,
                )
                self._promote()
                return
            waits += 1
            if waits % 10 == 1:
                logger.warning(
                    "designated secondary waiting for peer %s (%s so far)",
                    self.peer, role or "unreachable",
                )
            await asyncio.sleep(1.0)

    @staticmethod
    async def _probe_role(addr: str) -> Optional[str]:
        host, _, port = addr.rpartition(":")
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), 2.0
            )
            try:
                writer.write(wire.pack([1, "role", {}]))
                await writer.drain()
                msg = await asyncio.wait_for(wire.read_frame(reader), 2.0)
                return msg[2] if msg[1] == "ok" else None
            finally:
                writer.close()
                with contextlib.suppress(Exception):
                    await writer.wait_closed()
        except (OSError, asyncio.TimeoutError, ValueError):
            return None

    async def _follow_primary(self) -> None:
        """Standby: stream the primary's journal; promote when an
        ESTABLISHED primary stays dead past the resync window. Before the
        first successful sync there is nothing safe to promote, so the
        initial connect retries forever (a standby booting ahead of its
        primary must not become a second, empty primary)."""
        assert self.replica_of is not None
        host, _, port = self.replica_of.rpartition(":")
        synced_once = False
        failures = 0
        while True:
            try:
                reader, writer = await asyncio.open_connection(
                    host, int(port)
                )
                try:
                    writer.write(wire.pack([1, "repl_subscribe", {}]))
                    await writer.drain()
                    msg = await wire.read_frame(reader)
                    if msg[1] != "ok":
                        raise RuntimeError(f"repl_subscribe failed: {msg[2]}")
                    self.state.restore(msg[2])
                    synced_once = True
                    failures = 0
                    logger.info(
                        "standby synced: %d keys, %d leases (following %s)",
                        len(self.state.kv), len(self.state.leases),
                        self.replica_of,
                    )
                    while True:
                        msg = await wire.read_frame(reader)
                        if msg[0] == 0 and msg[1] == "repl":
                            op, kwargs, result = msg[3]
                            self.state.apply_replicated(op, kwargs, result)
                finally:
                    writer.close()
                    with contextlib.suppress(Exception):
                        await writer.wait_closed()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — classify below
                failures += 1
                if synced_once and failures >= self.RESYNC_ATTEMPTS:
                    logger.warning(
                        "primary lost (%s, %d attempts); promoting",
                        e, failures,
                    )
                    self._promote()
                    return
                if not synced_once and failures % 15 == 1:
                    logger.warning(
                        "standby waiting for primary %s (%s)",
                        self.replica_of, e,
                    )
                await asyncio.sleep(1.0)

    def _promote(self) -> None:
        self.role = "primary"
        self.state.grace_all_leases(PROMOTION_LEASE_GRACE_S)
        self.state.start()  # janitor: expiry + redelivery begin here
        self.state.on_replicate = self._journal
        self.promoted.set()
        logger.info(
            "promoted: %d keys, %d leases under %.0fs grace",
            len(self.state.kv), len(self.state.leases),
            PROMOTION_LEASE_GRACE_S,
        )

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = _Conn(reader, writer)
        self._conn_writers.add(writer)
        # Each request runs as its own task so a blocking op (queue_pop with
        # no timeout) cannot stall other multiplexed requests — in particular
        # lease keepalives — on the same connection.
        req_tasks: set[asyncio.Task] = set()

        async def run_one(req_id: int, op: str, kwargs: dict) -> None:
            try:
                result = await self._dispatch(conn, op, kwargs or {})
                await conn.send([req_id, "ok", result])
            except ConnectionError:
                pass
            except Exception as e:  # noqa: BLE001 — report to client
                with contextlib.suppress(ConnectionError):
                    await conn.send([req_id, "err", f"{type(e).__name__}: {e}"])

        try:
            while True:
                try:
                    msg = await wire.read_frame(reader)
                    # ignore-unknown-trailing-fields contract: a newer
                    # client may append fields to the request body
                    req_id, op, kwargs = msg[0], msg[1], msg[2]
                except wire.WireVersionError as e:
                    # peer outside our whole negotiable range: fail loudly
                    # with the structured mismatch rather than mis-parsing
                    # its framing as garbage lengths
                    logger.error("rejecting version-skewed peer: %s", e)
                    break
                except (
                    asyncio.IncompleteReadError,
                    ConnectionResetError,
                    ValueError,
                ):
                    break
                except Exception:  # malformed frame: drop connection quietly
                    logger.warning("malformed frame; closing connection")
                    break
                task = asyncio.get_running_loop().create_task(
                    run_one(req_id, op, kwargs)
                )
                req_tasks.add(task)
                task.add_done_callback(req_tasks.discard)
        finally:
            for t in list(req_tasks):
                t.cancel()
            for t in list(conn.watch_tasks.values()):
                t.cancel()
            for t in list(conn.sub_tasks.values()):
                t.cancel()
            for wid in list(conn.watch_tasks):
                self.state.watch_cancel(wid)
            for sid in list(conn.sub_tasks):
                self.state.unsubscribe(sid)
            # Leases are NOT revoked on disconnect: they expire by TTL, which
            # gives a reconnecting process its grace period (etcd semantics).
            self._conn_writers.discard(writer)
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _dispatch(self, conn: _Conn, op: str, a: dict) -> Any:
        st = self.state
        if op == "ping":
            return "pong"
        if op == "hello":
            # wire-version negotiation (sent packed at the floor so any
            # server in the peer's range can parse it): pin this
            # connection to the highest common version. Disjoint ranges
            # raise WireVersionError -> structured "err" reply. Answered
            # even on a standby so probing clients negotiate too.
            try:
                conn.version = wire.negotiate(
                    a.get("min", wire.WIRE_MIN), a.get("max", wire.WIRE_MIN)
                )
            except wire.WireVersionError as e:
                # re-raise outside the ConnectionError hierarchy so the
                # structured mismatch is REPLIED to the peer (run_one
                # treats ConnectionError as "peer already gone")
                raise RuntimeError(f"WireVersionError: {e}") from e
            return {"version": conn.version}
        if op == "role":
            return self.role
        if op == "repl_subscribe":
            rid = self._replica_ids = self._replica_ids + 1
            q: asyncio.Queue = asyncio.Queue()
            task = asyncio.get_running_loop().create_task(
                self._pump_replica(conn, rid, q)
            )
            self._replicas[rid] = (q, task)
            conn.watch_tasks[-rid] = task  # cancelled with the connection
            return self.state.snapshot()
        if self.role != "primary":
            # a standby answers ping/role (so clients can probe) and the
            # replication handshake; everything else must go to the primary
            raise RuntimeError("standby: not serving client operations")
        if op == "lease_grant":
            lease_id = st.lease_grant(a["ttl"])
            conn.leases.add(lease_id)
            return lease_id
        if op == "lease_keepalive":
            return st.lease_keepalive(a["lease_id"])
        if op == "lease_revoke":
            st.lease_revoke(a["lease_id"])
            return True
        if op == "kv_put":
            return st.kv_put(a["key"], a["value"], a.get("lease_id", 0))
        if op == "kv_create":
            return st.kv_create(a["key"], a["value"], a.get("lease_id", 0))
        if op == "kv_get":
            e = st.kv_get(a["key"])
            return None if e is None else e.value
        if op == "kv_get_prefix":
            return {k: e.value for k, e in st.kv_get_prefix(a["prefix"]).items()}
        if op == "kv_delete":
            return st.kv_delete(a["key"])
        if op == "kv_delete_prefix":
            return st.kv_delete_prefix(a["prefix"])
        if op == "watch_create":
            wid, snapshot, q = st.watch_create(a["prefix"])
            conn.watch_tasks[wid] = asyncio.get_running_loop().create_task(
                self._pump_watch(conn, wid, q)
            )
            return [wid, [ev.to_wire() for ev in snapshot]]
        if op == "watch_cancel":
            st.watch_cancel(a["watch_id"])
            t = conn.watch_tasks.pop(a["watch_id"], None)
            if t:
                t.cancel()
            return True
        if op == "subscribe":
            sid, q = st.subscribe(a["subject"], a.get("group", ""))
            conn.sub_tasks[sid] = asyncio.get_running_loop().create_task(
                self._pump_sub(conn, sid, q)
            )
            return sid
        if op == "unsubscribe":
            st.unsubscribe(a["sub_id"])
            t = conn.sub_tasks.pop(a["sub_id"], None)
            if t:
                t.cancel()
            return True
        if op == "publish":
            return st.publish(a["subject"], a["payload"])
        if op == "queue_put":
            return st.queue_put(a["name"], a["payload"])
        if op == "queue_pop":
            msg = await st.queue_pop(a["name"], a.get("timeout"))
            return None if msg is None else [msg.id, msg.payload]
        if op == "queue_ack":
            return st.queue_ack(a["name"], a["msg_id"])
        if op == "queue_depth":
            return st.queue_depth(a["name"])
        if op == "obj_put":
            st.obj_put(a["bucket"], a["name"], a["data"])
            return True
        if op == "obj_get":
            return st.obj_get(a["bucket"], a["name"])
        if op == "obj_delete":
            return st.obj_delete(a["bucket"], a["name"])
        if op == "obj_list":
            return st.obj_list(a["bucket"])
        raise ValueError(f"unknown op {op!r}")

    async def _pump_watch(self, conn: _Conn, wid: int, q: asyncio.Queue) -> None:
        with contextlib.suppress(asyncio.CancelledError, ConnectionError):
            while True:
                ev = await q.get()
                payload = None if ev is None else ev.to_wire()
                await conn.send([0, "push", wid, payload])
                if ev is None:
                    return

    async def _pump_sub(self, conn: _Conn, sid: int, q: asyncio.Queue) -> None:
        with contextlib.suppress(asyncio.CancelledError, ConnectionError):
            while True:
                item = await q.get()
                payload = None if item is None else [item[0], item[1]]
                await conn.send([0, "push", sid, payload])
                if item is None:
                    return


def main() -> None:
    parser = argparse.ArgumentParser(description="dynamo_tpu_torch fabric server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6650)
    parser.add_argument(
        "--replica-of", default=None, metavar="HOST:PORT",
        help="start as a hot standby of this primary; promotes itself "
        "when the primary dies (control-plane HA)",
    )
    parser.add_argument(
        "--peer", default=None, metavar="HOST:PORT",
        help="symmetric HA member: probe the peer at boot and follow it "
        "if primary, else the smaller --advertise address claims primacy "
        "(restart-safe under supervisors that replay original args)",
    )
    parser.add_argument(
        "--advertise", default=None, metavar="HOST:PORT",
        help="this member's address as the peer sees it (tie-break key)",
    )
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    async def run() -> None:
        server = FabricServer(
            args.host, args.port,
            replica_of=args.replica_of,
            peer=args.peer, advertise=args.advertise,
        )
        await server.start()
        await server.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
