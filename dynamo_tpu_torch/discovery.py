"""Model discovery: workers register models; frontends watch and wire chains.

The port's own copy of dynamo_tpu/discovery.py: ``ModelEntry``,
``register_llm``, ``RemoteEngine`` with in-flight migration and fenced-frame
rejection, and ``ModelWatcher``. A worker publishes its ModelDeploymentCard
to the fabric object store and writes a lease-bound kv entry under
``models/``; every frontend's ModelWatcher sees the entry, downloads the
card, builds the preprocessor -> router -> remote engine chain, and
registers it with its ModelManager. Lease death removes the entry and (on
the last ref) the model.

In KV mode (``RouterMode.KV``) the watcher keeps one ``kv_router.KvRouter``
per worker endpoint, fed by the workers' KV events, and closes it when the
endpoint's last model goes. Left out (ROADMAP.md A10 part 2 and A12): hedged
first tokens and health scoring (``_hedged_first``, ``telemetry/health``),
the worker capacity poller, the ejection publisher, trace ingest and
provenance records.

Role-equivalent of lib/llm/src/discovery/{watcher,model_manager,model_entry}.rs
and the bindings' ``register_llm``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.http.service import ModelExecution, ModelManager
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.pipeline.router import PushRouter, RouterMode
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.backoff import full_jitter_delay
from dynamo_tpu_torch.runtime.component import Endpoint, NoInstancesError
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.protocols import MODEL_ROOT, EndpointId

logger = logging.getLogger("dynamo_tpu_torch.discovery")


@dataclass
class ModelEntry:
    """The kv record under models/ (reference discovery/model_entry.rs)."""

    name: str
    slug: str
    endpoint: str  # dyn://ns.comp.ep
    model_type: str = "both"

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ModelEntry":
        d = json.loads(raw)
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


async def register_llm(
    drt: DistributedRuntime,
    endpoint: Endpoint,
    mdc: ModelDeploymentCard,
    lease_id: Optional[int] = None,
) -> str:
    """Publish the model card + discovery entry for a serving worker.

    Returns the kv key (which dies with the lease)."""
    await mdc.publish(drt.fabric)
    lid = lease_id if lease_id is not None else drt.primary_lease
    entry = ModelEntry(
        name=mdc.name,
        slug=mdc.slug,
        endpoint=str(endpoint.id),
        model_type=mdc.model_type,
    )
    key = f"{MODEL_ROOT}{mdc.slug}:{lid:x}"
    await drt.fabric.kv_put(key, entry.to_bytes(), lease_id=lid)
    logger.info("registered model %s -> %s", mdc.name, entry.endpoint)
    return key


class RemoteEngine:
    """EngineFn adapter with in-flight migration: forwards
    PreprocessedRequests over a PushRouter; when the serving worker dies
    mid-stream (transport error frame, handshake timeout, or the response
    stream breaking without a finish_reason — the signatures of a killed
    decode worker or a lost discovery lease), the request is REPLAYED —
    prompt plus already-emitted tokens — onto another healthy worker via
    the engines' ``resume_prompt_len`` replay contract, under bounded
    retries with exponential backoff + full jitter (``DYN_MIGRATION_MAX_RETRIES``
    4, ``DYN_MIGRATION_BACKOFF_S`` 0.05, ``DYN_MIGRATION_DISPATCH_TIMEOUT_S``
    5). The resumed stream carries no duplicated and no dropped tokens:
    every engine counts the replayed tail as generated output, so budgets
    and per-token sampling counters continue exactly where the dead worker
    stopped. Frames stamped with a fenced epoch (a partitioned zombie still
    streaming after the cluster declared it dead) are refused and the
    request migrates. ``migrations`` counts the replays."""

    def __init__(
        self,
        router: PushRouter,
        on_migration: Optional[Callable[[], None]] = None,
        cancel_token: Optional[Any] = None,
        fences: Optional[Any] = None,  # runtime.fencing.FenceRegistry
        on_fenced_reject: Optional[Callable[[], None]] = None,
    ) -> None:
        self.router = router
        self.on_migration = on_migration
        # the hosting runtime's CancellationToken: when the frontend itself
        # is dying (fabric/lease loss), replays must abort IMMEDIATELY so
        # the structured error still reaches the client before teardown
        self.cancel_token = cancel_token
        self.fences = fences
        self.on_fenced_reject = on_fenced_reject
        self.migrations = 0
        self.max_retries = int(os.environ.get("DYN_MIGRATION_MAX_RETRIES", "4"))
        self.backoff_base_s = float(os.environ.get("DYN_MIGRATION_BACKOFF_S", "0.05"))
        self.dispatch_timeout_s = float(
            os.environ.get("DYN_MIGRATION_DISPATCH_TIMEOUT_S", "5")
        )

    def _runtime_dying(self) -> bool:
        return self.cancel_token is not None and self.cancel_token.is_cancelled()

    async def __call__(
        self, request: PreprocessedRequest, ctx: Context
    ) -> AsyncIterator[LLMEngineOutput]:
        prompt_len = len(request.token_ids)
        emitted: list[int] = []
        failures = 0  # consecutive failed attempts (reset on progress)
        exclude: set[int] = set()
        req_dict = request.to_dict()
        # vision requests carry side-channel embeddings keyed off the live
        # worker; a mid-stream replay cannot reproduce them faithfully
        can_replay = not any(
            k in request.extra for k in ("mm", "mm_images", "mm_videos")
        )
        while True:
            # per-attempt child context: closing a dead attempt's stream
            # kills only the child, not the request
            attempt_ctx = ctx.child()
            failure: Optional[str] = None
            progressed = False
            no_instances = False
            stream = None
            try:
                # bounded dispatch, raced against runtime shutdown: a dead
                # fabric's failover hunt must not hang the replay past the
                # frontend's own teardown
                dispatch = self.router.generate(
                    req_dict, attempt_ctx, exclude=exclude or None
                )
                if self.cancel_token is not None:
                    stream = await asyncio.wait_for(
                        self.cancel_token.run_until_cancelled(dispatch),
                        self.dispatch_timeout_s,
                    )
                    if stream is None:
                        failure = "frontend runtime shutting down"
                else:
                    stream = await asyncio.wait_for(dispatch, self.dispatch_timeout_s)
            except asyncio.TimeoutError:
                failure = f"dispatch timed out after {self.dispatch_timeout_s:.1f}s"
            except Exception as e:  # noqa: BLE001 — dispatch failure
                failure = f"dispatch failed: {type(e).__name__}: {e}"
                no_instances = isinstance(e, NoInstancesError)
            if stream is not None:
                finished = False
                try:
                    async for item in stream:
                        if item.is_error():
                            failure = item.error_message() or "worker stream error"
                            break
                        if item.data is None:
                            continue
                        stamp = item.data.get("stamp") if isinstance(item.data, dict) else None
                        if self.fences is not None and self.fences.check_stamp(stamp, "dispatch"):
                            # zombie worker: the cluster fenced its epoch —
                            # refuse the frame and migrate
                            failure = f"worker epoch {stamp.get('ep', 0):x} is fenced"
                            if self.on_fenced_reject is not None:
                                with contextlib.suppress(Exception):
                                    self.on_fenced_reject()
                            break
                        out = LLMEngineOutput.from_dict(item.data)
                        if out.token_ids:
                            emitted.extend(out.token_ids)
                            progressed = True
                        yield out
                        if out.finish_reason is not None:
                            finished = True
                            return
                except (ConnectionError, OSError) as e:
                    failure = f"stream broke: {e}"
                finally:
                    with contextlib.suppress(Exception):
                        await stream.close()
                if failure is None and not finished:
                    # EOF with no final: the response plane died
                    failure = "stream ended without a finish reason"
            # ---- the attempt failed; decide whether to migrate ----
            if ctx.is_killed() or ctx.is_stopped():
                yield LLMEngineOutput.final(FinishReason.CANCELLED)
                return
            if self._runtime_dying():
                # frontend is being torn down (fabric/lease loss): emit the
                # structured final NOW, while the response can still flush
                yield LLMEngineOutput.final_error(
                    ctx.id, "migration",
                    f"frontend runtime shutting down during worker failover ({failure})",
                    "worker_unavailable",
                )
                return
            if ctx.expired():
                yield LLMEngineOutput.final_error(
                    ctx.id, "migration", "deadline exceeded during worker failover",
                    "deadline_exceeded",
                )
                return
            fab = getattr(getattr(getattr(self.router, "client", None), "drt", None), "fabric", None)
            if (
                fab is not None
                and getattr(fab, "in_degraded_mode", False)
                and not getattr(fab, "failed_permanently", False)
            ):
                # control-plane blackout, not a worker failure: the fleet is
                # likely healthy, only the dispatch bus is dark. Hold the
                # replay (without burning its retry budget) until the fabric
                # heals — bounded by the kill checks above each pass and by
                # the client's own degraded budget.
                await fab.wait_connected(2.0)
                continue
            failures = 1 if progressed else failures + 1
            bad = attempt_ctx.metadata.get("worker_instance_id")
            if bad is not None:
                exclude.add(bad)
            if failures > self.max_retries or (emitted and not can_replay):
                yield LLMEngineOutput.final_error(
                    ctx.id, "migration",
                    f"request failed after {failures} attempt(s): {failure}",
                    "worker_failed",
                )
                return
            logger.warning(
                "request %s: worker %s failed mid-stream (%s) — replaying %d "
                "emitted token(s) onto another worker (attempt %d/%d)",
                ctx.id, bad, failure, len(emitted), failures, self.max_retries,
            )
            if emitted:
                req_dict = dict(req_dict)
                req_dict["token_ids"] = list(request.token_ids) + list(emitted)
                extra = dict(req_dict.get("extra") or {})
                extra["resume_prompt_len"] = prompt_len
                req_dict["extra"] = extra
            self.migrations += 1
            if self.on_migration is not None:
                with contextlib.suppress(Exception):
                    self.on_migration()
            if no_instances:
                # every worker unreachable (mass restart): pause until the
                # discovery watch applies a change instead of burning the
                # retry budget against a stale instance list
                waiter = getattr(self.router.client, "wait_instances_changed", None)
                if waiter is not None:
                    await waiter(2.0)
            await asyncio.sleep(full_jitter_delay(failures, self.backoff_base_s, cap_s=2.0))


class ModelWatcher:
    """Watches ``models/`` and keeps a ModelManager in sync
    (reference discovery/watcher.rs:69-346). ``migrations`` counts each
    model's in-flight migrations."""

    def __init__(
        self,
        drt: DistributedRuntime,
        manager: ModelManager,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        kv_router_config: Optional[Any] = None,  # kv_router.KvRouterConfig
    ) -> None:
        # refuse at start, not at the first worker's registration
        if router_mode is RouterMode.DIRECT:
            raise ValueError(
                "router mode 'direct' needs an instance id with every request, "
                "which a frontend does not pick: use round_robin or random"
            )
        self.drt = drt
        self.manager = manager
        self.router_mode = router_mode
        self.kv_router_config = kv_router_config
        self.migrations: dict[str, int] = {}
        self._task: Optional[asyncio.Task] = None
        self._watch = None
        self._clients: dict[str, Any] = {}  # endpoint str -> Client
        self._key_to_model: dict[str, str] = {}
        # KV mode: endpoint str -> KvRouter, and each model's endpoint
        self.kv_routers: dict[str, Any] = {}
        self._model_endpoint: dict[str, str] = {}

    async def start(self) -> None:
        self._watch = await self.drt.fabric.watch_prefix(MODEL_ROOT)
        for ev in self._watch.initial:
            await self._on_put(ev.key, ev.value)
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._watch is not None:
            await self._watch.cancel()
        if self._task is not None:
            self._task.cancel()
        # the routers stay listed (closed) for the frontend's exit stats
        for kv_router in self.kv_routers.values():
            await kv_router.close()
        for client in self._clients.values():
            await client.close()
        self._clients.clear()

    async def _loop(self) -> None:
        assert self._watch is not None
        with contextlib.suppress(asyncio.CancelledError):
            async for ev in self._watch:
                try:
                    if ev.type == "put":
                        await self._on_put(ev.key, ev.value)
                    else:
                        await self._on_delete(ev.key)
                except Exception:  # noqa: BLE001 — keep watching
                    logger.exception("model watcher failed applying %s", ev.key)

    async def _on_put(self, key: str, value: bytes) -> None:
        entry = ModelEntry.from_bytes(value)
        if self.manager.get(entry.name) is not None:
            self._key_to_model[key] = entry.name
            self.manager.add_model(entry.name, self.manager.get(entry.name), ref=key)  # type: ignore[arg-type]
            return
        mdc = await ModelDeploymentCard.download(self.drt.fabric, entry.slug)
        eid = EndpointId.parse(entry.endpoint)
        endpoint = (
            self.drt.namespace(eid.namespace).component(eid.component).endpoint(eid.name)
        )
        client = self._clients.get(entry.endpoint)
        if client is None:
            client = await endpoint.client()
            self._clients[entry.endpoint] = client
        if self.router_mode is RouterMode.KV:
            from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter

            kv_router = self.kv_routers.get(entry.endpoint)
            if kv_router is None:
                kv_router = KvRouter(endpoint.component, client, block_size=mdc.kv_block_size,
                                     config=self.kv_router_config)
                await kv_router.start()
                self.kv_routers[entry.endpoint] = kv_router
            router = PushRouter(client, RouterMode.KV, selector=KvPushRouter(kv_router))
        else:
            router = PushRouter(client, self.router_mode)
        # admin fan-out: POST /clear_kv_blocks on the frontend round-trips
        # every worker's clear_kv_blocks endpoint (ref clear_kv_blocks.rs:88)
        clear_endpoint = endpoint.component.endpoint("clear_kv_blocks")
        clear_client_box: dict[str, Any] = {}

        async def clear_fn() -> list[dict]:
            client_c = clear_client_box.get("c")
            if client_c is None:
                client_c = await clear_endpoint.client()
                clear_client_box["c"] = client_c
            results = []
            for iid in client_c.instance_ids():
                stream = None
                try:
                    stream = await client_c.direct({}, iid)
                    async for item in stream:
                        if item.data is not None:
                            results.append({"instance": iid, **dict(item.data)})
                            break
                except Exception as e:  # noqa: BLE001
                    results.append({"instance": iid, "error": str(e)})
                finally:
                    if stream is not None:
                        await stream.close()
            return results

        model_name = entry.name
        self.migrations.setdefault(model_name, 0)

        def on_migration() -> None:
            self.migrations[model_name] += 1

        # epoch fencing: the frontend's registry of cluster-declared-dead
        # epochs (fence/ tombstones) — dispatch frames from a fenced worker
        # are refused and the stream migrates
        fences = None
        with contextlib.suppress(Exception):
            fences = await self.drt.fences()
        execution = ModelExecution(
            mdc,
            RemoteEngine(router, on_migration=on_migration,
                         cancel_token=self.drt.token, fences=fences),
            clear_fn=clear_fn,
        )
        self.manager.add_model(entry.name, execution, ref=key)
        self._key_to_model[key] = entry.name
        self._model_endpoint[entry.name] = entry.endpoint
        logger.info("watcher wired model %s via %s", entry.name, entry.endpoint)

    async def _on_delete(self, key: str) -> None:
        model = self._key_to_model.pop(key, None)
        if model is None:
            return
        if self.manager.remove_ref(model, key):
            # the model is gone: close its endpoint's KV router unless
            # another model still routes through that endpoint
            ep = self._model_endpoint.pop(model, None)
            if ep is not None and ep not in self._model_endpoint.values():
                kv_router = self.kv_routers.pop(ep, None)
                if kv_router is not None:
                    await kv_router.close()
