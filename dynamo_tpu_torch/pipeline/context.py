"""Request-scoped context: id, metadata, cancellation, deadlines — propagated
across process boundaries in the request header.

The port's own copy of dynamo_tpu/pipeline/context.py: ``Context`` and
the ``DecisionCarrier`` over its metadata (the QoS class, the KV router's
prefix-pull plan and fleet prefix coverage, under the reference's wire
keys).

Role-equivalent of the reference's Context<T>/Controller
(lib/runtime/src/pipeline/context.rs:33,324) and AsyncEngineContext
(lib/runtime/src/engine.rs:124-160: id / stop_generating / kill / stopped).

Deadlines are wall-clock epoch seconds so they survive the wire hop to the
worker (same-host or NTP-synced fleet; the enforcement granularity is tens
of milliseconds, far above realistic skew). Two budgets ride along:

- ``deadline``      — the whole request must finish by this instant; expiry
  anywhere (frontend admission, router queue, engine loop) cancels via the
  CancellationToken cascade and surfaces a structured error.
- ``ttft_deadline`` — the first token must be produced by this instant;
  enforced while the request is still queued (a request that can no longer
  meet its TTFT budget is shed before it wastes prefill compute).
"""

from __future__ import annotations

import uuid
from typing import Any, Optional

from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.runtime.cancellation import CancellationToken


class Context:
    """Carries a request id, arbitrary metadata, deadlines, and a
    stop/kill controller."""

    __slots__ = ("id", "metadata", "deadline", "ttft_deadline", "_stop", "_kill")

    def __init__(
        self,
        id: Optional[str] = None,
        metadata: Optional[dict[str, Any]] = None,
        parent: Optional["Context"] = None,
        deadline: Optional[float] = None,
        ttft_deadline: Optional[float] = None,
    ) -> None:
        self.id: str = id or uuid.uuid4().hex
        self.metadata: dict[str, Any] = dict(metadata or {})
        self.deadline: Optional[float] = deadline
        self.ttft_deadline: Optional[float] = ttft_deadline
        if parent is not None:
            self._stop = parent._stop.child_token()
            self._kill = parent._kill.child_token()
            if deadline is None:
                self.deadline = parent.deadline
            if ttft_deadline is None:
                self.ttft_deadline = parent.ttft_deadline
        else:
            self._stop = CancellationToken()
            self._kill = CancellationToken()

    # --- controller surface (engine.rs AsyncEngineContext semantics) ---

    def stop_generating(self) -> None:
        """Graceful: stop producing new tokens, let in-flight output drain."""
        self._stop.cancel()

    def kill(self) -> None:
        """Hard: abandon the request entirely (client disconnected)."""
        self._stop.cancel()
        self._kill.cancel()

    def is_stopped(self) -> bool:
        return self._stop.is_cancelled()

    def is_killed(self) -> bool:
        return self._kill.is_cancelled()

    async def stopped(self) -> None:
        await self._stop.cancelled()

    async def killed(self) -> None:
        await self._kill.cancelled()

    @property
    def stop_token(self) -> CancellationToken:
        return self._stop

    # --- deadlines ---

    def set_deadline_ms(
        self, timeout_ms: Optional[float], ttft_ms: Optional[float] = None
    ) -> None:
        """Arm deadlines relative to now (None leaves a budget unset)."""
        now = dclock.wall()
        if timeout_ms is not None:
            self.deadline = now + timeout_ms / 1e3
        if ttft_ms is not None:
            self.ttft_deadline = now + ttft_ms / 1e3

    def remaining_s(self) -> Optional[float]:
        """Seconds until the request deadline; None when unbounded."""
        if self.deadline is None:
            return None
        return self.deadline - dclock.wall()

    def expired(self) -> bool:
        return self.deadline is not None and dclock.wall() > self.deadline

    def ttft_expired(self) -> bool:
        """True when the first-token budget has lapsed (callers only check
        this while no token has been produced yet)."""
        return self.ttft_deadline is not None and dclock.wall() > self.ttft_deadline

    # --- wire form ---

    def to_header(self) -> dict[str, Any]:
        h: dict[str, Any] = {"id": self.id, "metadata": self.metadata}
        if self.deadline is not None:
            h["deadline"] = self.deadline
        if self.ttft_deadline is not None:
            h["ttft_deadline"] = self.ttft_deadline
        return h

    @classmethod
    def from_header(cls, header: dict[str, Any]) -> "Context":
        return cls(
            id=header.get("id"),
            metadata=header.get("metadata") or {},
            deadline=header.get("deadline"),
            ttft_deadline=header.get("ttft_deadline"),
        )

    def child(self) -> "Context":
        return Context(id=self.id, metadata=self.metadata, parent=self)

    def decisions(self) -> "DecisionCarrier":
        """Typed view over the decision metadata riding this context."""
        return DecisionCarrier(self.metadata)


class DecisionCarrier:
    """Typed accessor for the per-request decision metadata that rides
    ``Context.metadata`` across wire hops: the resolved QoS class, the
    router's cross-worker prefix pull plan, and the fleet prefix-coverage
    fraction. The wire keys are the reference's, so headers stay
    compatible."""

    PRIORITY = "priority"
    PREFIX_PULL = "prefix_pull"
    KV_FLEET_FRAC = "kv_fleet_frac"

    __slots__ = ("_md",)

    def __init__(self, metadata: Optional[dict[str, Any]]) -> None:
        self._md: dict[str, Any] = metadata if metadata is not None else {}

    # --- QoS class -----------------------------------------------------

    @property
    def priority(self) -> Optional[str]:
        return self._md.get(self.PRIORITY)

    @priority.setter
    def priority(self, value: Optional[str]) -> None:
        if value is None:
            self._md.pop(self.PRIORITY, None)
        else:
            self._md[self.PRIORITY] = value

    # --- router prefix pull plan ---------------------------------------

    @property
    def pull_plan(self) -> Optional[dict[str, Any]]:
        return self._md.get(self.PREFIX_PULL)

    @pull_plan.setter
    def pull_plan(self, plan: Optional[dict[str, Any]]) -> None:
        if plan is None:
            self._md.pop(self.PREFIX_PULL, None)
        else:
            self._md[self.PREFIX_PULL] = plan

    def take_pull_plan(self) -> Optional[dict[str, Any]]:
        """Pop the pull plan (consumed exactly once, by the prefill edge)."""
        return self._md.pop(self.PREFIX_PULL, None)

    # --- fleet prefix coverage -----------------------------------------

    @property
    def kv_fleet_frac(self) -> Optional[float]:
        return self._md.get(self.KV_FLEET_FRAC)

    @kv_fleet_frac.setter
    def kv_fleet_frac(self, frac: Optional[float]) -> None:
        if frac is None:
            self._md.pop(self.KV_FLEET_FRAC, None)
        else:
            self._md[self.KV_FLEET_FRAC] = frac


def decisions_of(ctx: Any) -> DecisionCarrier:
    """Carrier for any Context-like object (None-safe: detached dict)."""
    return DecisionCarrier(getattr(ctx, "metadata", None))
