"""G4-lite: pull KV blocks from a peer worker's host tier over the fabric.

The port's own copy of dynamo_tpu/block_manager/peer.py. A worker that misses
a prefix in its own tiers finds which peer's host or disk tier holds it and
pulls the blocks instead of recomputing the prefill:

  * ``PeerBlockService``: each worker publishes its block-hash inventory
    under ``kvbm/adverts/{namespace}/{instance_id}`` in the fabric's kv store
    (bound to its primary lease, so a dead worker's advert goes with it;
    fence-stamped) and serves pulls on a ``kvbm.pull`` endpoint;
  * ``PeerBlockClient``: finds the peer whose advert holds the longest
    prefix (the router's plan, when one rides the request, names it), pulls
    the blocks and lands them in the LOCAL tier (G4 -> G2), from which the
    engine's onboarding injects them into device blocks (G2 -> G1).

A reply is one ``KvBlockPayload`` (the disagg data plane's codec container:
``DYN_KV_WIRE=int8`` halves the bytes, the integrity header is verified
before landing) on the runtime's TCP response plane. Every outcome is
counted in blocks under ``PULL_OUTCOMES``; any failure leaves the prefix to
be recomputed.

A reply that would not fit in one fabric frame (``fabric/wire.MAX_FRAME``,
512 MiB: 256 blocks of Llama-3.1-8B in bf16) breaks the reference's
response connection: the puller gets a disconnect, counts the span
``fallback_miss`` and recomputes all of it, after the peer has loaded and
encoded every block. The port's service caps a reply at the blocks one
frame holds (counted in ``capped_replies``); the puller lands them and
recomputes the rest.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Any, Optional

from dynamo_tpu_torch import integrity
from dynamo_tpu_torch.fabric import mpack, wire
from dynamo_tpu_torch.kv_router.protocols import PULL_OUTCOMES  # noqa: F401 (re-exported)
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.testing import faults

logger = logging.getLogger("dynamo_tpu_torch.block_manager.peer")

_ADVERT_PREFIX = "kvbm/adverts"
# room in a reply's frame for everything but the K/V bytes: the hash list,
# the payload's header and the stamp
_FRAME_SLACK = 1 << 20



def _advert_key(namespace: str, instance_id: int) -> str:
    return f"{_ADVERT_PREFIX}/{namespace}/{instance_id}"


def _blocks_per_frame(layout: Any, codec: str) -> int:
    """The most blocks one reply carries within the fabric's frame limit
    (a block's K + V wire bytes under ``codec``: int8 mantissas and an f32
    scale per layer and head, or the raw dtype)."""
    if codec == "int8":
        nbytes = 2 * layout.block_numel + 2 * 4 * layout.num_layers * layout.num_kv_heads
    else:
        nbytes = layout.block_nbytes
    return max(0, (wire.MAX_FRAME - _FRAME_SLACK) // nbytes)


class PeerBlockService:
    """Serve this worker's cached blocks to peers and advertise the set."""

    def __init__(
        self,
        drt: Any,
        namespace: str,
        manager: Any,  # TieredBlockManager
        publish_interval_s: float = 1.0,
        worker_id: Optional[int] = None,
    ) -> None:
        self.drt = drt
        self.namespace = namespace
        self.manager = manager
        self.publish_interval_s = publish_interval_s
        # the generate endpoint's instance id (the router's id space), tagged
        # into the advert so a plan's ``src`` resolves to this service
        self.worker_id = worker_id
        self.endpoint = drt.namespace(namespace).component("kvbm").endpoint("pull")
        self._service = None
        self._publish_task: Optional[asyncio.Task] = None
        self._last_advert: Optional[bytes] = None
        self.capped_replies = 0  # replies cut to what one frame holds

    @property
    def instance_id(self) -> int:
        assert self._service is not None
        return self._service.instance_id

    async def start(self) -> None:
        self._service = await self.endpoint.serve_endpoint(self._handler)
        self._publish_task = asyncio.get_running_loop().create_task(self._publish_loop())

    async def close(self) -> None:
        if self._publish_task is not None:
            self._publish_task.cancel()
            try:
                await self._publish_task
            except asyncio.CancelledError:
                pass
        if self._service is not None:
            await self._service.stop()
        await self.drt.fabric.kv_delete(_advert_key(self.namespace, self.instance_id))

    def _inventory(self) -> list[int]:
        m = self.manager
        with m._lock:
            return list(m._host.keys()) + list(m._disk.keys())

    def _stamp(self) -> dict:
        from dynamo_tpu_torch.runtime.fencing import make_stamp

        return make_stamp(self.instance_id, self.drt.fencing_epoch)

    async def _publish_loop(self) -> None:
        while True:
            try:
                advert_d: dict = {"stamp": self._stamp(), "h": self._inventory()}
                if self.worker_id is not None:
                    advert_d["wid"] = self.worker_id
                advert = mpack.packb(advert_d)
                if advert != self._last_advert:
                    await self.drt.fabric.kv_put(
                        _advert_key(self.namespace, self.instance_id), advert,
                        lease_id=self.drt.primary_lease,
                    )
                    self._last_advert = advert
            except Exception:  # noqa: BLE001 - advertising is best-effort
                logger.exception("block advert publish failed")
            await asyncio.sleep(self.publish_interval_s)

    async def _handler(self, request: dict, ctx: Context):
        from dynamo_tpu_torch.disagg.protocols import KvBlockPayload, wire_codec_from_env

        hashes = [int(h) for h in request.get("hashes", [])]
        found = [h for h in hashes if h in self.manager]
        codec = wire_codec_from_env()
        fit = _blocks_per_frame(self.manager.layout, codec)
        if len(found) > fit:
            self.capped_replies += 1
            logger.warning("pull of %d blocks capped at %d: one reply must fit in a %d-byte "
                           "frame", len(found), fit, wire.MAX_FRAME)
            found = found[:fit]
        if not found:
            yield {"hashes": [], "payload": None}
            return
        loop = asyncio.get_running_loop()
        k, v = await loop.run_in_executor(None, self.manager.load_blocks, found)
        # the disagg data plane's container: the integrity header rides
        # along, so the puller verifies before landing
        payload = KvBlockPayload.encode(k, v, codec, dtype=self.manager.layout.dtype)
        wire_d = payload.to_wire()
        if faults.active():
            inj = faults.get_injector()
            if inj is not None:
                bad = inj.corrupt_bytes(wire_d["k"])
                if bad is not None:
                    wire_d["k"] = bad
        yield {"hashes": found, "payload": wire_d, "stamp": self._stamp()}


class PeerBlockClient:
    """Pull missing prefix blocks from whichever peer holds them."""

    def __init__(self, drt: Any, namespace: str, manager: Any) -> None:
        self.drt = drt
        self.namespace = namespace
        self.manager = manager
        self.endpoint = drt.namespace(namespace).component("kvbm").endpoint("pull")
        self._client = None
        self.own_instance_id: Optional[int] = None  # skip self-pulls
        self.fetched_blocks = 0
        self.fetched_bytes = 0  # wire bytes pulled (after the codec)
        # per-outcome block counts (PULL_OUTCOMES keys), monotonic
        self.pull_outcomes: dict[str, int] = {k: 0 for k in PULL_OUTCOMES}

    def _note(self, outcome: str, blocks: int) -> None:
        if blocks > 0:
            self.pull_outcomes[outcome] = self.pull_outcomes.get(outcome, 0) + blocks

    async def _ensure_client(self):
        if self._client is None:
            self._client = await self.endpoint.client()
        return self._client

    async def _fences(self):
        fences_fn = getattr(self.drt, "fences", None)
        if fences_fn is None:
            return None
        try:
            return await fences_fn()
        except Exception:  # noqa: BLE001 - fencing is an upgrade, not a gate
            return None

    async def _adverts(self) -> tuple[list[tuple[int, set, Optional[int]]], set]:
        """The live adverts [(instance_id, held hashes, worker_id)], and the
        worker ids whose adverts carry a fenced stamp (a zombie incarnation:
        a directed pull from one falls back)."""
        adverts = await self.drt.fabric.kv_get_prefix(f"{_ADVERT_PREFIX}/{self.namespace}/")
        fences = await self._fences()
        entries: list[tuple[int, set, Optional[int]]] = []
        fenced_wids: set = set()
        for key, raw in adverts.items():
            iid = int(key.rsplit("/", 1)[1])
            if iid == self.own_instance_id:
                continue
            try:
                d = mpack.unpackb(raw)
                wid = None
                if isinstance(d, dict):
                    wid = d.get("wid")
                    if fences is not None and fences.check_stamp(d.get("stamp"), "peer"):
                        if wid is not None:
                            fenced_wids.add(wid)
                        continue
                    held = set(d.get("h", []))
                else:
                    held = set(d)  # a plain-list advert
            except Exception:  # noqa: BLE001 - skip a malformed advert
                continue
            entries.append((iid, held, wid))
        return entries, fenced_wids

    @staticmethod
    def _prefix_len(seq_hashes: list[int], held: set) -> int:
        n = 0
        for h in seq_hashes:
            if h in held:
                n += 1
            else:
                break
        return n

    async def lookup(self, seq_hashes: list[int]) -> tuple[Optional[int], int]:
        """(best peer instance, longest advertised prefix length)."""
        entries, _ = await self._adverts()
        best, best_n = None, 0
        for iid, held, _wid in entries:
            n = self._prefix_len(seq_hashes, held)
            if n > best_n:
                best, best_n = iid, n
        return best, best_n

    async def fetch_remote_prefix(self, seq_hashes: list[int], plan: Optional[dict] = None) -> int:
        """Pull the longest remotely held prefix into the LOCAL manager;
        returns the number of blocks landed (0 on a miss or a failure).

        With a router's ``plan`` ({"src": worker_id, "blocks": n, "hashes":
        [...], "avoid": [...]}) the pull is directed: the planned source's
        advert (its "wid" tag) is tried first, and the avoid-listed workers
        are never pulled from. The plan is advisory: every failure falls
        back to a local prefill, its blocks counted by outcome in
        ``pull_outcomes``."""
        planned = int(plan.get("blocks", 0)) if plan else 0
        missing_from = self.manager.lookup_prefix(seq_hashes)
        want = seq_hashes[missing_from:]
        if not want:
            return 0
        entries, fenced_wids = await self._adverts()
        avoid = set(plan.get("avoid", [])) if plan else set()
        peer, n = None, 0
        if plan is not None:
            src = plan.get("src")
            if src in fenced_wids:
                self._note("fallback_fenced", planned)
                return 0
            for iid, held, wid in entries:
                if wid is not None and wid == src:
                    peer, n = iid, self._prefix_len(seq_hashes, held)
                    break
        if peer is None or n <= missing_from:
            # undirected scan: no plan, or the planned source's advert is
            # gone or stale; avoid-listed workers stay skipped
            best, best_n = None, 0
            for iid, held, wid in entries:
                if wid is not None and wid in avoid:
                    continue
                m = self._prefix_len(seq_hashes, held)
                if m > best_n:
                    best, best_n = iid, m
            peer, n = best, best_n
        if peer is None or n <= missing_from:
            self._note("fallback_miss", planned)
            return 0
        pull = seq_hashes[missing_from:n]
        # never pull a quarantined hash back in: the span ends before the
        # first one (store_blocks would refuse it anyway)
        is_q = getattr(self.manager, "is_quarantined", None)
        if is_q is not None:
            for i, h in enumerate(pull):
                if is_q(h):
                    pull = pull[:i]
                    break
        if not pull:
            return 0
        try:
            client = await self._ensure_client()
            timeout = float(os.environ.get("DYN_PULL_TIMEOUT_S", "5.0"))
            try:
                reply = await asyncio.wait_for(self._pull_from(client, pull, peer), timeout)
            except asyncio.TimeoutError:
                self._note("fallback_timeout", len(pull))
                logger.warning("peer block pull timed out after %.1fs; recomputing", timeout)
                return 0
            data = reply.data if hasattr(reply, "data") else reply
            if not data or not data.get("hashes") or not data.get("payload"):
                self._note("fallback_miss", len(pull))
                return 0
            fences = await self._fences()
            if fences is not None and fences.check_stamp(data.get("stamp"), "peer"):
                self._note("fallback_fenced", len(pull))
                return 0  # pulled from a zombie: refused, recomputed
            from dynamo_tpu_torch.disagg.protocols import KvBlockPayload

            payload = KvBlockPayload.from_wire(data["payload"])
            self.fetched_bytes += payload.wire_nbytes
            # decode verifies the integrity header (a corrupt pull raises and
            # is recomputed) and dequantizes an int8 pull; the local manager
            # re-encodes to its own tier codec
            try:
                k, v = payload.decode()
            except integrity.IntegrityError as e:
                integrity.COUNTERS.integrity_failure("peer_pull", str(e))
                self._note("fallback_integrity", len(pull))
                return 0
            loop = asyncio.get_running_loop()
            stored = await loop.run_in_executor(
                None, self.manager.store_blocks, list(data["hashes"]), k, v)
            self.fetched_blocks += stored
            self._note("pulled", stored)
            return stored
        except Exception as e:  # noqa: BLE001 - fall back to recompute
            self._note("fallback_error", len(pull))
            logger.warning("peer block fetch failed (%s); recomputing", e)
            return 0

    async def _pull_from(self, client, hashes: list[int], peer: int):
        stream = await client.direct({"hashes": hashes}, peer, Context())
        reply = None
        async for item in stream:
            reply = item
        return reply
