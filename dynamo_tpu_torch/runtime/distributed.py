"""DistributedRuntime: the per-process handle to the cluster.

The port's own copy of dynamo_tpu/runtime/distributed.py.

Role-equivalent of the reference's DistributedRuntime
(lib/runtime/src/distributed.rs:34-197): owns the fabric client (etcd+NATS
analogue), the primary lease with its keep-alive task, the lazy TCP response
server, the local endpoint registry (for in-process short-circuit calls), and
the root cancellation token whose cascade tears everything down.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import TYPE_CHECKING, Callable, Optional

from dynamo_tpu_torch.fabric.client import FabricClient
from dynamo_tpu_torch.fabric.state import FabricState
from dynamo_tpu_torch.pipeline.tcp import TcpResponseServer
from dynamo_tpu_torch.runtime.cancellation import CancellationToken
from dynamo_tpu_torch.runtime.config import RuntimeConfig

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.component import Namespace
    from dynamo_tpu_torch.runtime.fencing import FenceRegistry

logger = logging.getLogger("dynamo_tpu_torch.runtime")


class DistributedRuntime:
    def __init__(
        self,
        fabric: FabricClient,
        config: Optional[RuntimeConfig] = None,
    ) -> None:
        self.fabric = fabric
        self.config = config or RuntimeConfig()
        self.token = CancellationToken()
        self.tcp_server = TcpResponseServer(
            self.config.tcp_host, self.config.tcp_port
        )
        # (subject) -> handler for same-process short-circuit dispatch
        self.local_endpoints: dict[str, Callable] = {}
        self.primary_lease: int = 0
        self._keepalive_task: Optional[asyncio.Task] = None
        self._extra_leases: list[int] = []
        self._closed = False
        # graceful-drain registry: serving surfaces (http frontends,
        # endpoint workers) register async callbacks run on SIGTERM —
        # stop admission, finish in-flight work, deregister from discovery
        self._drain_cbs: list[Callable] = []
        # self-fence registry: fired (once, synchronously) the moment the
        # primary lease is discovered lost — BEFORE the whole-process
        # cancel — so engines can fail their lanes with a structured
        # `worker_fenced` error between dispatches instead of their
        # consumers watching streams die with the teardown
        self.fenced = False
        self._fence_cbs: list[Callable] = []
        self._fences: Optional["FenceRegistry"] = None

    def on_drain(self, cb: Callable) -> None:
        """Register an async zero-arg drain callback (run once, in
        registration order, bounded by the caller's drain timeout)."""
        self._drain_cbs.append(cb)

    def on_reconnect(self, cb: Callable) -> None:
        """Register a zero-arg callable (sync or async) fired every time
        the fabric heals from a blackout/failover — the reconcile-on-heal
        hook: re-register instances/models idempotently, re-put stats
        keys, republish adverts. Runs AFTER watches are re-established and
        buffered publishes flushed."""
        self.fabric.on_reconnect(cb)

    @property
    def degraded_budget_s(self) -> float:
        """How long this process keeps serving through a control-plane
        blackout before self-fencing (DYN_DEGRADED_MAX_S). The no-double-
        serve argument: during a TOTAL blackout no janitor runs, so no
        lease can expire and no work can be re-routed — serving on is
        safe for ANY budget. On heal (promotion/restart) every lease gets
        the server's promotion grace (>= 10 s) and our blackout keepalive
        retry cadence is <= 1 s, so a worker still within budget refreshes
        its lease well inside the grace — it is never expired+fenced while
        also serving. A worker partitioned ALONE (store up for everyone
        else) has its lease expired at TTL and its epoch fenced:
        consumers reject its frames, so its bounded continued serving
        cannot double-serve either; the budget caps the wasted compute."""
        return max(self.config.lease_ttl_s / 3.0, self.config.degraded_max_s)

    # ---------------------------------------------------------- fencing

    @property
    def fencing_epoch(self) -> int:
        """This process incarnation's fencing epoch: derived from the
        primary lease, so the cluster-side death certificate (the
        ``fence/{epoch:x}`` tombstone the fabric writes on lease EXPIRY)
        names exactly this incarnation. Stamped onto every worker-
        originated frame (runtime/fencing.py)."""
        return self.primary_lease

    def on_fence(self, cb: Callable[[str], None]) -> None:
        """Register a sync callback fired once when this runtime
        discovers its primary lease is gone (worker self-fence).
        `cb(reason)` runs BEFORE the root token is cancelled."""
        self._fence_cbs.append(cb)

    def _fire_fence(self, reason: str) -> None:
        if self.fenced:
            return
        self.fenced = True
        cbs, self._fence_cbs = self._fence_cbs, []
        for cb in cbs:
            try:
                cb(reason)
            except Exception:  # noqa: BLE001 — fencing must not be stopped
                logger.exception("fence callback failed")

    async def fences(self) -> "FenceRegistry":
        """The runtime's fenced-epoch registry (lazily started watch over
        the fabric's ``fence/`` tombstones)."""
        from dynamo_tpu_torch.runtime.fencing import FenceRegistry

        if self._fences is None:
            self._fences = FenceRegistry(self.fabric)
        await self._fences.start()
        return self._fences

    async def drain(self, timeout_s: float = 10.0) -> None:
        """Run every registered drain callback, each bounded by the
        remaining share of timeout_s. Errors are logged, never raised —
        drain must always hand control back so the process can exit."""
        cbs, self._drain_cbs = self._drain_cbs, []
        if not cbs:
            return
        deadline = asyncio.get_running_loop().time() + timeout_s
        for cb in cbs:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                logger.warning("drain budget exhausted; skipping callbacks")
                return
            try:
                await asyncio.wait_for(cb(), remaining)
            except asyncio.TimeoutError:
                logger.warning("drain callback timed out after %.1fs", remaining)
            except Exception:  # noqa: BLE001 — drain is best-effort
                logger.exception("drain callback failed")

    # ----------------------------------------------------- constructors

    @classmethod
    async def from_settings(
        cls, config: Optional[RuntimeConfig] = None
    ) -> "DistributedRuntime":
        """Connect per config: remote fabric if DYN_FABRIC_ADDR set, else the
        process-shared in-memory fabric."""
        cfg = config or RuntimeConfig.from_settings()
        if cfg.fabric_addr:
            fabric = await FabricClient.connect(cfg.fabric_addr)
        else:
            fabric = FabricClient.in_process()
        drt = cls(fabric, cfg)
        await drt._start_primary_lease()
        return drt

    @classmethod
    async def detached(
        cls,
        config: Optional[RuntimeConfig] = None,
        state: Optional[FabricState] = None,
    ) -> "DistributedRuntime":
        """Static mode: process-local fabric, no external dependencies
        (reference distributed.rs:113 from_settings_without_discovery)."""
        drt = cls(FabricClient.in_process(state), config)
        await drt._start_primary_lease()
        return drt

    # ----------------------------------------------------------- leases

    async def _start_primary_lease(self) -> None:
        ttl = self.config.lease_ttl_s
        self.primary_lease = await self.fabric.lease_grant(ttl)
        self._keepalive_task = asyncio.get_running_loop().create_task(
            self._keepalive_loop(self.primary_lease, ttl)
        )

    async def _keepalive_loop(self, lease_id: int, ttl: float) -> None:
        """Refresh the lease at ttl/3 cadence, distinguishing two very
        different failures:

        * **store-unreachable** (ConnectionError — a control-plane
          blackout, or an HA failover in progress): the cluster has NOT
          declared us dead, it simply can't hear us. Keep serving,
          retrying on a fast cadence (<= 1 s) so the heal is noticed
          within the post-promotion lease grace, bounded by the degraded
          budget (`DYN_DEGRADED_MAX_S`). Past the budget the conservative
          rule applies: self-fence rather than risk serving fenced.
        * **lease-reported-dead** (alive=False): the cluster already
          considers us gone (expired during a partition) — self-fence
          immediately, exactly as before (reference etcd.rs:51-166)."""
        blackout_t0: Optional[float] = None
        budget = self.degraded_budget_s
        loop = asyncio.get_running_loop()
        interval = ttl / 3.0
        try:
            while not self.token.is_cancelled():
                await asyncio.sleep(
                    interval if blackout_t0 is None
                    else min(interval, 1.0)
                )
                try:
                    alive = await self.fabric.lease_keepalive(lease_id)
                except ConnectionError as e:
                    now = loop.time()
                    if blackout_t0 is None:
                        blackout_t0 = now
                        logger.warning(
                            "fabric unreachable during keepalive (%s): "
                            "store-unreachable, NOT lease-dead — serving "
                            "degraded for up to %.0fs", e, budget,
                        )
                    if now - blackout_t0 < budget:
                        continue
                    logger.error(
                        "control-plane blackout outlived the %.0fs "
                        "degraded budget; conservatively self-fencing",
                        budget,
                    )
                    alive = False
                else:
                    if blackout_t0 is not None:
                        logger.info(
                            "control plane healed after %.1fs; lease %d %s",
                            loop.time() - blackout_t0, lease_id,
                            "alive" if alive else "DEAD",
                        )
                        blackout_t0 = None
                if not alive:
                    # self-fence FIRST (sync: engines fail lanes with a
                    # structured worker_fenced between dispatches), then
                    # best-effort write our own death certificate (the
                    # fabric may be reachable even though the LEASE died —
                    # e.g. a partition that healed after expiry), then the
                    # whole-process cancel as before
                    logger.error(
                        "primary lease %d lost; self-fencing + cancelling "
                        "runtime", lease_id,
                    )
                    self._fire_fence(f"primary lease {lease_id:x} lost")
                    from dynamo_tpu_torch.runtime.fencing import fence_key

                    with contextlib.suppress(Exception):
                        await self.fabric.kv_put(
                            fence_key(lease_id), b"self_fenced"
                        )
                    self.token.cancel()
                    return
        except asyncio.CancelledError:
            pass

    async def create_lease(self, ttl: Optional[float] = None) -> int:
        lease_id = await self.fabric.lease_grant(ttl or self.config.lease_ttl_s)
        self._extra_leases.append(lease_id)
        return lease_id

    # -------------------------------------------------------- hierarchy

    def namespace(self, name: Optional[str] = None) -> "Namespace":
        from dynamo_tpu_torch.runtime.component import Namespace

        return Namespace(self, name or self.config.namespace)

    def child_token(self) -> CancellationToken:
        return self.token.child_token()

    # --------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        self.token.cancel()

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.token.cancel()
        if self._fences is not None:
            await self._fences.close()
            self._fences = None
        if self._keepalive_task:
            self._keepalive_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._keepalive_task
        with contextlib.suppress(Exception):
            if self.primary_lease:
                await self.fabric.lease_revoke(self.primary_lease)
            for lease in self._extra_leases:
                await self.fabric.lease_revoke(lease)
        await self.tcp_server.close()
        await self.fabric.close()
