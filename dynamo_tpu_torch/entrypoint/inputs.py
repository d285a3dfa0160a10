"""Input modes of the port's CLI: http server, interactive text, jsonl batch,
dyn:// worker.

The port's own copy of dynamo_tpu/entrypoint/inputs.py.
``EngineConfig.static_(engine, mdc)`` wires a local engine;
``EngineConfig.dynamic(router_mode, kv_router_config)`` serves whatever
workers register through discovery (``discovery.ModelWatcher``; in KV mode
routed by the KV-aware router). ``run_endpoint`` hosts a static engine as a
``dyn://ns.comp.ep`` worker: it serves the endpoint, registers the model
(``register_llm``), stamps every frame with its fencing epoch, publishes the
engine's KV events (``kv_router.KvEventPublisher``; the warm-restored
blocks too) and its load metrics every second
(``kv_router.WorkerMetricsPublisher`` over ``load_metrics(engine)``),
re-registers after a fabric heal, self-fences through ``engine.fence``,
deregisters and finishes its requests on a drain, then checkpoints the KV
tiers (``DYN_WARM_RESTART_DIR``). With ``DYN_TRACE=1`` a worker serves
each request under a ``worker_generate`` span on its own track and ships
the request's spans on the final frame (``make_engine_handler``).

The operating plane: ``run_http`` wires the frontend's admission capacity
(a static engine's ``max_batch``; discovery's capacity poller otherwise),
its SLO plane (transitions published on ``slo-status``, fleet
``slo-status`` events fed to its brownout ladder, ladder transitions
published on ``brownout-status``), the control-plane and engine metric
families, and chains a colocated engine's ``apply_brownout`` onto the
ladder. ``run_endpoint`` runs the worker's own ladder (inputs.py:714-780),
fed by fleet ``slo-status`` events and its local burn rates over the
engine's phase histograms, applies it through ``engine.apply_brownout``
and publishes its transitions on ``brownout-status``; with
``DYN_RUNTIME_HTTP_ENABLED=1`` it serves ``/health``, ``/live`` and
``/metrics`` on ``DYN_RUNTIME_HTTP_PORT`` (``runtime/http_server.py``).
A worker's load metrics carry the engine's decode-bandwidth gauges and its
goodput ledger (``load_metrics``); a colocated engine's ledger is on the
frontend's ``/metrics`` and ``GET /debug/goodput``, and a dynamic
frontend's ``GET /debug/fleet`` carries its health scorers. Left out: the
planner's status row on the frontend (ROADMAP.md A12.3).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import signal
import sys
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.http.service import HttpService, ModelExecution, ModelManager
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.router import RouterMode
from dynamo_tpu_torch.protocols.common import Context, PreprocessedRequest
from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest, ChatMessage
from dynamo_tpu_torch.telemetry import brownout as dbrownout
from dynamo_tpu_torch.telemetry import provenance as dprov
from dynamo_tpu_torch.telemetry import slo as dslo
from dynamo_tpu_torch.telemetry import trace as dtrace

logger = logging.getLogger("dynamo_tpu_torch.entrypoint")


def make_engine_handler(
    engine: Any,
    proc_label: Optional[str] = None,
    namespace: Any = None,
    stamp: Optional[dict] = None,
):
    """Worker-side request handler hosting an engine on a dyn:// endpoint
    (inputs.py:36-123). Every yielded frame carries the worker's
    epoch-fencing ``stamp`` (``(instance_id, epoch)``, runtime/fencing.py):
    the frontend's RemoteEngine rejects frames whose epoch the cluster has
    fenced, so a partitioned zombie's tokens never reach a client stream.

    With tracing on, the request is served under a ``worker_generate`` span
    on the worker's own process track (``proc_label``), and the request's
    completed spans (this worker's and any it ingested from a prefill
    worker) ride the stream's final frame, held until the span closed. When
    the consumer tears the stream down before that frame, the export is
    published on ``namespace``'s ``trace-export`` event subject instead,
    which the frontend's ModelWatcher subscribes to. The request's decision
    records (``telemetry/provenance.py``: preemptions, re-admissions) ride
    the same final frame or event."""

    async def handler(request: dict, ctx: Context) -> AsyncIterator[dict]:
        pre = PreprocessedRequest.from_dict(request)
        if not dtrace.enabled() and not dprov.enabled():
            async for out in engine.generate(pre, ctx):
                d = out.to_dict()
                if stamp is not None:
                    d["stamp"] = stamp
                yield d
            return
        label = proc_label or getattr(engine, "trace_proc", None)
        final_d: Optional[dict] = None
        shipped = False
        shipped_dec = False
        agen = engine.generate(pre, ctx)
        try:
            with dtrace.process_scope(label), dtrace.span(
                "worker_generate", ctx=ctx, attach=True, request_id=ctx.id
            ):
                async for out in agen:
                    d = out.to_dict()
                    if stamp is not None:
                        d["stamp"] = stamp
                    if out.finish_reason is not None:
                        # hold the final frame until the worker span has
                        # closed, so the shipped export includes it
                        final_d = d
                        break
                    yield d
            if final_d is not None:
                tid = dtrace.ctx_trace_id(ctx)
                if tid:
                    final_d["trace"] = dtrace.export_for_trace(tid)
                if dprov.enabled():
                    recs = dprov.export_for_request(ctx.id)
                    if recs:
                        final_d["decisions"] = recs
                yield final_d
                shipped = bool(final_d.get("trace"))
                shipped_dec = bool(final_d.get("decisions"))
        finally:
            with contextlib.suppress(Exception):
                await agen.aclose()
            if namespace is not None:
                payload: dict = {}
                if dtrace.enabled() and not shipped:
                    tid = dtrace.ctx_trace_id(ctx)
                    wire = dtrace.export_for_trace(tid) if tid else None
                    if wire:
                        payload["trace"] = wire
                if dprov.enabled() and not shipped_dec:
                    recs = dprov.export_for_request(ctx.id)
                    if recs:
                        payload["decisions"] = recs
                if payload:
                    # the stream is gone (or never reached its final
                    # frame): fire and forget the export onto the event plane
                    async def _publish(p=payload):
                        with contextlib.suppress(Exception):
                            await namespace.publish_event(dtrace.EXPORT_SUBJECT, p)

                    asyncio.get_running_loop().create_task(_publish())

    return handler


@dataclass
class EngineConfig:
    """Either a static local engine (anything with ``generate(request,
    context)``) and the model card its frontend serves it under, or dynamic:
    the models that workers register through discovery."""

    engine: Optional[Any] = None
    mdc: Optional[ModelDeploymentCard] = None
    router_mode: RouterMode = RouterMode.ROUND_ROBIN
    kv_router_config: Optional[Any] = None  # kv_router.KvRouterConfig when mode=KV
    request_template: Optional[Any] = None  # request_template.RequestTemplate

    @classmethod
    def static_(cls, engine: Any, mdc: ModelDeploymentCard) -> "EngineConfig":
        return cls(engine=engine, mdc=mdc)

    @classmethod
    def dynamic(
        cls, router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        kv_router_config: Optional[Any] = None,
    ) -> "EngineConfig":
        return cls(router_mode=router_mode, kv_router_config=kv_router_config)

    @property
    def is_static(self) -> bool:
        return self.engine is not None

    def execution(self) -> ModelExecution:
        """The static engine's execution (inputs.py:208-215, :798-806): a
        ``MultimodalEngine`` marks the card ``supports_images``, and an
        engine with ``embed`` serves ``/v1/embeddings``."""
        if getattr(self.engine, "supports_images", False):
            self.mdc.extra["supports_images"] = True
        return ModelExecution(self.mdc, self.engine.generate,
                              clear_fn=_local_clear_fn(self.engine),
                              embed_fn=getattr(self.engine, "embed", None))


def _local_clear_fn(engine: Any) -> Optional[Any]:
    """A local engine's ``clear_kv_blocks()`` (one dict) as the
    ``ModelExecution.clear_fn`` contract (a list of per-worker dicts), as
    dynamo_tpu/entrypoint/inputs.py:129-139; None when the engine has
    none."""
    inner = getattr(engine, "clear_kv_blocks", None)
    if inner is None:
        return None

    async def clear_fn() -> list[dict]:
        return [{"instance": "local", **await inner()}]

    return clear_fn


async def run_input(
    in_opt: str,
    config: EngineConfig,
    http_port: int = 8080,
    http_host: str = "0.0.0.0",
    drt: Optional[Any] = None,
) -> Optional[HttpService]:
    """Dispatch on the input flavor (``drt``: the process's
    ``runtime.distributed.DistributedRuntime``, which a dynamic config and
    a dyn:// input need). Returns the HTTP server, closed, after an
    ``http`` input."""
    if in_opt == "http":
        return await serve_http_forever(config, http_host, http_port, drt=drt)
    if in_opt in ("text", "stdin"):
        await run_text(config, drt=drt)
    elif in_opt.startswith("batch:"):
        await run_batch(config, in_opt[len("batch:"):], drt=drt)
    elif in_opt.startswith("dyn://") or "." in in_opt:
        await run_endpoint(drt, config, in_opt)
    else:
        raise ValueError(f"unknown input {in_opt!r} (http, text, batch:FILE or dyn://ns.comp.ep)")
    return None


# ------------------------------------------------------------------ http


async def run_http(
    config: EngineConfig, host: str = "0.0.0.0", port: int = 8080, drt: Optional[Any] = None
) -> HttpService:
    """The OpenAI server over a static engine, or (dynamic config) over a
    ``ModelWatcher`` of ``drt``'s fabric, whose workers it routes to with
    ``config.router_mode``; the watcher is ``service.watcher``. With a
    ``drt``, its drain (SIGTERM) drains the server: new requests 503,
    in-flight streams finish within ``DYN_DRAIN_TIMEOUT_S`` (10)."""
    manager = ModelManager()
    service = HttpService(manager, host=host, port=port, template=config.request_template)
    if config.is_static:
        manager.add_model(config.mdc.name, config.execution())
        _wire_local_engine(service, config)
    else:
        from dynamo_tpu_torch.discovery import ModelWatcher

        if drt is None:
            raise ValueError("a dynamic frontend (out=dyn) needs a DistributedRuntime")
        watcher = ModelWatcher(drt, manager, config.router_mode, config.kv_router_config,
                               metrics=service.metrics, admission=service.admission)
        await watcher.start()
        service.watcher = watcher
        # GET /debug/fleet's health feed: each worker endpoint's scorer
        service.fleet_sources["health"] = lambda: {
            ep: scorer.status() for ep, scorer in watcher.health.items()}
    if drt is not None:
        ns = drt.namespace(drt.config.namespace)
        # the SLO plane's transitions and the brownout ladder's go out on
        # the runtime namespace (inputs.py:266-298)
        service.slo_publisher = _event_publisher(ns, dslo.SLO_STATUS_SUBJECT)
        service.brownout_publisher = _event_publisher(ns, dbrownout.BROWNOUT_SUBJECT)
        # dyn_fabric_connected / dyn_llm_degraded_* off this process's client
        service.metrics.attach_control_plane(drt.fabric.status)
    await service.start()
    if drt is not None:
        # fleet slo-status events feed this frontend's ladder too
        service.add_background_task(asyncio.get_running_loop().create_task(
            _slo_events(ns, service.note_remote_slo)))
        drain_timeout = float(os.environ.get("DYN_DRAIN_TIMEOUT_S", "10"))
        drt.on_drain(lambda: service.drain(drain_timeout))
    return service


def _wire_local_engine(service: HttpService, config: EngineConfig) -> None:
    """A colocated engine's counters on the frontend's /metrics, its slots
    as the admission capacity, and its brownout rungs chained onto the
    frontend's ladder (inputs.py:211-257)."""
    engine = config.engine
    stats = getattr(engine, "stats", None)
    if stats is None:
        return
    if getattr(engine, "config", None) is not None and getattr(engine.config, "spec_k", 0):
        service.metrics.attach_spec_stats(stats)
    if hasattr(stats, "kv_wire_bytes_rx"):
        service.metrics.attach_kv_transfer_stats(stats)
    service.metrics.attach_engine_qos(stats)
    # the goodput ledger's families and GET /debug/goodput (a TorchEngine's
    # stats or a MockEngine's stats() dict)
    service.metrics.attach_goodput(stats)
    slots = getattr(getattr(engine, "config", None), "max_batch", None)
    if callable(stats):
        slots = stats().get("total_slots")
    if slots:
        service.admission.set_capacity_fn(config.mdc.name, lambda: slots)
    if hasattr(engine, "apply_brownout"):
        base_change = service.brownout.on_change

        def _chained_change(old: int, new: int, rung: str) -> None:
            if base_change is not None:
                base_change(old, new, rung)
            engine.apply_brownout(new)

        service.brownout.on_change = _chained_change


def _event_publisher(ns: Any, subject: str):
    """A fire-and-forget publisher of dict events on ``ns``'s ``subject``."""
    def publish(payload: dict) -> None:
        async def _send() -> None:
            with contextlib.suppress(Exception):
                await ns.publish_event(subject, payload)

        with contextlib.suppress(RuntimeError):  # no running loop
            asyncio.get_running_loop().create_task(_send())

    return publish


async def _slo_events(ns: Any, on_state) -> None:
    """Feed every ``slo-status`` event's new state to ``on_state``."""
    with contextlib.suppress(asyncio.CancelledError, Exception):
        sub = await ns.subscribe_event(dslo.SLO_STATUS_SUBJECT)
        async for _subject, payload in sub:
            try:
                data = mpack.unpackb(payload)
            except Exception:  # noqa: BLE001 — a malformed event
                continue
            on_state(data.get("new"))


async def serve_http_forever(
    config: EngineConfig, host: str, port: int, drt: Optional[Any] = None
) -> HttpService:
    """Serve until SIGINT / SIGTERM (the caller owns the engine). Without a
    runtime the server closes; with one, the runtime drains (the server
    among its drain callbacks) and shuts down."""
    service = await run_http(config, host, port, drt=drt)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    name = config.mdc.name if config.is_static else "discovered models"
    print(f"serving {name!r} on http://{host}:{service.port}", flush=True)
    try:
        await stop.wait()
        if drt is not None:
            await drt.drain(float(os.environ.get("DYN_DRAIN_TIMEOUT_S", "10")) + 5.0)
    finally:
        await service.close()
        if service.watcher is not None:
            await service.watcher.stop()
    return service


# ------------------------------------------------------------------ text


async def run_text(
    config: EngineConfig, prompt_once: Optional[str] = None, drt: Optional[Any] = None
) -> None:
    """Interactive chat REPL on stdin/stdout."""
    execution, model_name = await _resolve_execution(config, drt)
    messages: list[ChatMessage] = []
    loop = asyncio.get_running_loop()

    async def one_turn(user_text: str) -> None:
        messages.append(ChatMessage(role="user", content=user_text))
        req = ChatCompletionRequest(model=model_name, messages=messages, stream=True)
        reply_parts: list[str] = []
        async for item in execution.chat_stream(req, Context()):
            if item.is_error():
                print(f"\n[error] {item.error_message()}", flush=True)
                return
            if item.data:
                for choice in item.data.get("choices", []):
                    delta = choice.get("delta", {}).get("content")
                    if delta:
                        reply_parts.append(delta)
                        print(delta, end="", flush=True)
        print()
        messages.append(ChatMessage(role="assistant", content="".join(reply_parts)))

    if prompt_once is not None:
        await one_turn(prompt_once)
        return
    print(f"chatting with {model_name} — ctrl-d to exit", flush=True)
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line:
            return
        line = line.strip()
        if line:
            await one_turn(line)


# ----------------------------------------------------------------- batch


async def run_batch(
    config: EngineConfig,
    path: str,
    output_path: Optional[str] = None,
    concurrency: int = 8,
    drt: Optional[Any] = None,
) -> dict[str, Any]:
    """JSONL batch eval with TTFT/ITL stats: one chat request per line
    (``text`` or ``prompt``, optional ``max_tokens``); results go to
    ``output_path`` (default ``<path>.out.jsonl``), one JSON line each."""
    execution, model_name = await _resolve_execution(config, drt)
    with open(path) as f:
        requests = [json.loads(line) for line in f if line.strip()]
    sem = asyncio.Semaphore(concurrency)
    results: list[dict[str, Any]] = [None] * len(requests)  # type: ignore[list-item]

    async def run_one(i: int, spec: dict[str, Any]) -> None:
        async with sem:
            prompt = spec.get("text") or spec.get("prompt") or ""
            req = ChatCompletionRequest(
                model=model_name,
                messages=[ChatMessage(role="user", content=prompt)],
                stream=True,
                max_tokens=spec.get("max_tokens"),
            )
            start = time.monotonic()
            first: Optional[float] = None
            last = start
            parts: list[str] = []
            itls: list[float] = []
            async for item in execution.chat_stream(req, Context()):
                if item.data:
                    for choice in item.data.get("choices", []):
                        delta = choice.get("delta", {}).get("content")
                        if delta:
                            now = time.monotonic()
                            if first is None:
                                first = now
                            else:
                                itls.append(now - last)
                            last = now
                            parts.append(delta)
            results[i] = {
                "text": "".join(parts),
                "ttft_ms": (first - start) * 1e3 if first else None,
                "itl_ms_mean": (sum(itls) / len(itls) * 1e3) if itls else None,
                "elapsed_ms": (time.monotonic() - start) * 1e3,
            }

    await asyncio.gather(*(run_one(i, s) for i, s in enumerate(requests)))
    ttfts = [r["ttft_ms"] for r in results if r and r["ttft_ms"] is not None]
    summary = {
        "num_requests": len(requests),
        "ttft_ms_mean": sum(ttfts) / len(ttfts) if ttfts else None,
        "results": results,
    }
    out_path = output_path or (path + ".out.jsonl")
    with open(out_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    logger.info(
        "batch done: %d requests, mean TTFT %.1f ms",
        len(requests),
        summary["ttft_ms_mean"] or -1,
    )
    return summary


# -------------------------------------------------------------- endpoint


async def run_endpoint(drt: Any, config: EngineConfig, endpoint_str: str) -> None:
    """Host a static engine as a dyn:// worker and register its model
    (inputs.py:456-555; reference input/endpoint.rs:26-96 + bindings
    register_llm). Returns when the runtime drains or shuts down."""
    from dynamo_tpu_torch.discovery import register_llm
    from dynamo_tpu_torch.runtime.fencing import make_stamp
    from dynamo_tpu_torch.runtime.protocols import EndpointId

    if drt is None:
        raise ValueError("in=dyn:// needs a DistributedRuntime")
    if not config.is_static:
        raise ValueError("in=dyn:// requires a static engine (the worker owns it)")
    eid = EndpointId.parse(endpoint_str, drt.config.namespace)
    endpoint = drt.namespace(eid.namespace).component(eid.component).endpoint(eid.name)
    engine = config.engine
    # worker identity on trace timelines: a track per instance, so an
    # assembled cross-process trace shows which worker served which hop
    worker_label = f"{eid.component}:{drt.primary_lease & 0xFFFFFF:x}"
    with contextlib.suppress(Exception):
        engine.trace_proc = worker_label
    # epoch-fencing stamp: (instance_id, epoch) rides every reply frame so
    # frontends can reject a fenced incarnation's tokens
    stamp = make_stamp(drt.primary_lease, drt.fencing_epoch)
    service = await endpoint.serve_endpoint(make_engine_handler(
        engine, worker_label, namespace=endpoint.component.namespace, stamp=stamp))
    if getattr(engine, "supports_images", False):
        # rides the registered card, so remote frontends pass media parts
        config.mdc.extra["supports_images"] = True
    await register_llm(drt, endpoint, config.mdc)

    # reconcile-on-heal: when the fabric comes back from a blackout (or a
    # promoted standby's snapshot missed our registration), re-register the
    # instance + model entry idempotently under the still-valid lease. If
    # the lease died during the outage the puts fail and the keepalive loop
    # self-fences — the conservative rule.
    async def _reconcile_registration() -> None:
        with contextlib.suppress(Exception):
            await drt.fabric.kv_put(
                endpoint.id.instance_key(service.instance_id),
                service.instance.to_bytes(),
                lease_id=service.instance_id,
            )
            await register_llm(drt, endpoint, config.mdc)
            logger.info("reconciled %s registration after fabric heal", eid)

    drt.on_reconnect(_reconcile_registration)

    loop = asyncio.get_running_loop()
    # self-fence: the moment a keepalive reports the lease gone (the
    # cluster declared us dead), the engine fails every lane with a
    # structured `worker_fenced` error and the worker leaves discovery —
    # closing the window where a zombie would double-serve alongside its
    # migrated replacement
    if hasattr(engine, "fence"):
        def _on_fence(reason: str) -> None:
            engine.fence(reason)
            loop.create_task(service.stop(drain=False))

        drt.on_fence(_on_fence)

    # stuck-dispatch watchdog: a tripped engine pulls this worker out of
    # discovery at once (routers stop sending; the lease would take a TTL)
    if hasattr(engine, "on_watchdog_trip"):
        def _on_trip() -> None:
            logger.error("watchdog tripped: deregistering %s from discovery", eid)
            loop.create_task(service.stop(drain=False))

        engine.on_watchdog_trip = _on_trip

    # graceful drain (SIGTERM -> drt.drain): deregister from discovery and
    # finish in-flight requests; then checkpoint the KV tiers, their
    # completion offloads in, for a warm restart
    drt.on_drain(lambda: service.stop(drain=True))
    warm_dir = drt.config.warm_restart_dir
    if warm_dir and hasattr(engine, "checkpoint_tiers"):
        async def _warm_checkpoint() -> None:
            await loop.run_in_executor(None, engine.checkpoint_tiers, warm_dir)

        drt.on_drain(_warm_checkpoint)

    # KV-routing feeds: the engine's cache events and its load metrics, so
    # a KV-mode router can prefix-route to this worker
    from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher

    kv_pub = KvEventPublisher(endpoint.component, service.instance_id)
    if hasattr(engine, "on_blocks_stored"):
        engine.on_blocks_stored = kv_pub.on_blocks_stored
        engine.on_blocks_removed = kv_pub.on_blocks_removed
    if hasattr(engine, "on_cache_cleared"):
        engine.on_cache_cleared = kv_pub.publish_cleared
    # blocks restored from a warm-restart checkpoint are invisible to the
    # routers until advertised: republish their chains now
    bm = getattr(engine, "block_manager", None)
    if bm is not None and bm.stats.warm_restored:
        adverts = bm.advert_blocks()
        if adverts:
            kv_pub.on_blocks_stored(adverts)
            logger.info("republished %d warm-restored block advert(s)", len(adverts))
    metrics_pub = None
    if hasattr(engine, "allocator") or callable(getattr(engine, "stats", None)):
        metrics_pub = WorkerMetricsPublisher(endpoint.component, endpoint.id, service.instance_id,
                                             stamp=stamp)
        await metrics_pub.start(lambda: load_metrics(engine))

    background: list[asyncio.Task] = []
    controller = None
    ns = endpoint.component.namespace
    if hasattr(engine, "apply_brownout"):
        # the worker's own brownout ladder (inputs.py:714-780), fed by fleet
        # slo-status events and local burn rates over the engine's phase
        # histograms; rungs apply through engine.apply_brownout
        publish = _event_publisher(ns, dbrownout.BROWNOUT_SUBJECT)

        def _on_change(old: int, new: int, rung: str) -> None:
            engine.apply_brownout(new)
            publish({"scope": worker_label, "old_level": old, "level": new, "rung": rung,
                     **controller.actions()})

        controller = dbrownout.BrownoutController(scope=worker_label, on_change=_on_change)
        slo_states = {"remote": "ok", "local": "ok"}

        def _feed(source: str, state: Any) -> None:
            if state in dslo._SEVERITY:
                slo_states[source] = state
            controller.observe(max(slo_states.values(), key=lambda st: dslo._SEVERITY[st]))

        background.append(loop.create_task(_slo_events(ns, lambda st: _feed("remote", st))))
        slo_cfg = dslo.SloConfig.from_env(config.mdc.name)
        local_slo = (dslo.SloEngine(slo_cfg, model=config.mdc.name)
                     if slo_cfg.enabled and hasattr(engine, "stats") else None)
        tick_s = float(os.environ.get("DYN_SLO_TICK_S", "1.0"))

        async def _tick() -> None:
            # the local burn rates when the worker has an objective; without
            # one the tick still observes the last states, so the ladder
            # steps back down after the fleet's ok (the reference ticks only
            # with an objective: ROADMAP C11)
            with contextlib.suppress(asyncio.CancelledError):
                while True:
                    await asyncio.sleep(tick_s)
                    try:
                        state = None
                        if local_slo is not None:
                            st = engine.stats() if callable(engine.stats) else engine.stats
                            ph = st["phase_histograms"] if isinstance(st, dict) else st.phase_histograms
                            state = local_slo.observe(ph).get("state")
                        _feed("local", state)
                    except Exception:  # noqa: BLE001 — telemetry only
                        logger.exception("local SLO tick failed")

        background.append(loop.create_task(_tick()))

    status_server = None
    if drt.config.http_enabled:
        status_server = await _start_status_server(drt.config.http_port, engine, controller)

    # admin control plane: the frontend's POST /clear_kv_blocks fans out to
    # this per-worker endpoint (ref http/service/clear_kv_blocks.rs:23)
    clear_service = None
    if hasattr(engine, "clear_kv_blocks"):
        async def clear_handler(request: dict, ctx: Context):
            yield await engine.clear_kv_blocks()

        clear_service = await endpoint.component.endpoint("clear_kv_blocks").serve_endpoint(
            clear_handler)

    logger.info("worker serving %s (model %s) as instance %x", eid, config.mdc.name,
                service.instance_id)
    print(json.dumps({"worker": {"endpoint": str(eid), "instance_id": service.instance_id}}),
          flush=True)
    try:
        await service.wait()
    finally:
        for t in background:
            t.cancel()
        await asyncio.gather(*background, return_exceptions=True)
        if status_server is not None:
            await status_server.close()
        if metrics_pub is not None:
            await metrics_pub.stop()
        await kv_pub.drain()
        if clear_service is not None:
            await clear_service.stop(drain=False)


def _dict_load_metrics(d: dict):
    """A MockEngine's ``stats()`` dict as ``ForwardPassMetrics``
    (inputs.py:610-705, the reference's dict path)."""
    from dynamo_tpu_torch.integrity import COUNTERS
    from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics, KvStats, WorkerStats

    total = d.get("total_blocks", 1) or 1
    used = d.get("used_blocks", 0)
    ph = d.get("phase_histograms")
    gp = d.get("goodput")
    integ = COUNTERS.snapshot()
    return ForwardPassMetrics(
        worker_stats=WorkerStats(
            request_active_slots=d.get("active_slots", 0),
            request_total_slots=d.get("total_slots", 0),
            num_requests_waiting=d.get("waiting", 0),
            num_deadline_exceeded=d.get("deadline_exceeded", 0),
            num_watchdog_trips=d.get("watchdog_trips", 0),
            preemptions_by_class=dict(d.get("preemptions_by_class") or {}) or None,
            num_preempted_too_often=d.get("preempted_too_often", 0),
            num_shed_brownout=d.get("shed_brownout", 0),
            brownout_level=d.get("brownout_level", 0),
            integrity_failures_by_path=integ["integrity_failures_by_path"] or None,
            num_blocks_quarantined=integ["blocks_quarantined"],
            fenced_rejects_by_plane=integ["fenced_rejects_by_plane"] or None,
            kv_pulled_blocks_by_outcome=dict(d.get("kv_pull_outcomes") or {}) or None,
            decode_hbm_bytes_per_token=d.get("decode_hbm_bytes_per_token", 0.0),
            mfu_decode_est=d.get("mfu_decode_est", 0.0),
            tp_collective_bytes_per_step=d.get("tp_collective_bytes_per_step", 0.0),
        ),
        kv_stats=KvStats(kv_active_blocks=used, kv_total_blocks=total,
                         gpu_cache_usage_perc=used / total),
        phase_histograms=ph if ph is not None and ph.total_count() else None,
        goodput=gp if gp is not None and gp.total_events() else None,
    )


async def _start_status_server(port: int, engine: Any, controller: Any):
    """The worker's system status server (runtime/http_server.py):
    ``/health``, ``/live`` and ``/metrics`` with the process's families, the
    engine's QoS, spec and KV data-plane counters, its phase histograms,
    the integrity counters and the brownout ladder."""
    from dynamo_tpu_torch.http.metrics import PhaseCollector, ServiceMetrics
    from dynamo_tpu_torch.integrity import COUNTERS
    from dynamo_tpu_torch.runtime.http_server import SystemStatusServer

    server = SystemStatusServer(port=port)
    fams = ServiceMetrics(server.registry)
    stats = getattr(engine, "stats", None)
    if stats is not None:
        fams.attach_engine_qos(stats)
        if getattr(getattr(engine, "config", None), "spec_k", 0):
            fams.attach_spec_stats(stats)
        if hasattr(stats, "kv_wire_bytes_rx"):
            fams.attach_kv_transfer_stats(stats)
        if hasattr(stats, "phase_histograms"):
            server.registry.register(PhaseCollector(lambda: stats.phase_histograms))
    fams.attach_integrity(COUNTERS)
    if controller is not None:
        fams.attach_brownout(controller)
    await server.start()
    print(json.dumps({"status_server": {"port": server.port}}), flush=True)
    return server


def load_metrics(engine: Any):
    """A ``TorchEngine``'s load and counters as the reference's
    ``ForwardPassMetrics`` (dynamo_tpu/entrypoint/inputs.py:610-705, under
    its field names; the fields the port's engine does not keep stay at
    their defaults), with the decode-bandwidth gauges and the goodput
    ledger (shipped once it recorded anything)."""
    from dynamo_tpu_torch.integrity import COUNTERS
    from dynamo_tpu_torch.kv_router.protocols import (
        ForwardPassMetrics,
        KvStats,
        KvTransferStats,
        SpecDecodeStats,
        WorkerStats,
    )

    if callable(engine.stats):  # a MockEngine: its stats() dict
        return _dict_load_metrics(engine.stats())
    st, cfg = engine.stats, engine.config
    total = cfg.num_blocks - 1  # block 0 is the allocator's pad block
    used = total - engine.allocator.free_count
    spec = None
    if cfg.spec_k:
        spec = SpecDecodeStats(
            num_spec_tokens=cfg.spec_k, num_drafts=st.num_drafts,
            num_draft_tokens=st.num_draft_tokens, num_accepted_tokens=st.num_accepted_tokens,
            num_accepted_tokens_per_pos=list(st.accepted_per_pos) or None,
        )
    xfer = None
    if st.kv_frames_tx or st.kv_frames_rx or st.kv_wire_bytes_tx or st.kv_wire_bytes_rx:
        xfer = KvTransferStats(
            kv_frames_tx=st.kv_frames_tx, kv_frames_rx=st.kv_frames_rx,
            kv_wire_bytes_tx=st.kv_wire_bytes_tx, kv_wire_bytes_rx=st.kv_wire_bytes_rx,
            kv_bytes_overlapped=st.kv_bytes_overlapped,
        )
    integ = COUNTERS.snapshot()
    return ForwardPassMetrics(
        worker_stats=WorkerStats(
            request_active_slots=sum(s is not None for s in engine.slots),
            request_total_slots=cfg.max_batch,
            num_requests_waiting=len(engine.waiting),
            num_deadline_exceeded=st.deadline_exceeded,
            num_watchdog_trips=st.watchdog_trips,
            preemptions_by_class=dict(st.preemptions_by_class) or None,
            num_preempted_too_often=st.preempted_too_often,
            num_shed_brownout=st.shed_brownout,
            brownout_level=st.brownout_level,
            integrity_failures_by_path=integ["integrity_failures_by_path"] or None,
            num_blocks_quarantined=integ["blocks_quarantined"],
            fenced_rejects_by_plane=integ["fenced_rejects_by_plane"] or None,
            # the peer tier's pulled blocks by outcome
            kv_pulled_blocks_by_outcome=dict(st.kv_pull_outcomes) or None,
            decode_hbm_bytes_per_token=st.decode_hbm_bytes_per_token,
            mfu_decode_est=st.mfu_decode_est,
            tp_collective_bytes_per_step=st.tp_collective_bytes_per_step,
        ),
        kv_stats=KvStats(kv_active_blocks=used, kv_total_blocks=total,
                         gpu_cache_usage_perc=used / max(1, total)),
        spec_decode_stats=spec,
        kv_transfer_stats=xfer,
        # the always-on phase histograms, shipped once anything is recorded,
        # so the aggregator and the health scorer see this worker's own view
        phase_histograms=(st.phase_histograms if st.phase_histograms.total_count() else None),
        # shipped even empty: it marks a port worker, which the health
        # plane scores on its pace, never on its inter_token gaps
        health_histograms=st.health_histograms,
        goodput=st.goodput if st.goodput.total_events() else None,
    )


# ----------------------------------------------------------------- util


async def _resolve_execution(config: EngineConfig, drt: Optional[Any]) -> tuple[ModelExecution, str]:
    """The static engine's chain, or the first model discovery finds
    (within 30 s)."""
    if config.is_static:
        return config.execution(), config.mdc.name
    from dynamo_tpu_torch.discovery import ModelWatcher

    if drt is None:
        raise ValueError("a dynamic config (out=dyn) needs a DistributedRuntime")
    manager = ModelManager()
    watcher = ModelWatcher(drt, manager, config.router_mode, config.kv_router_config)
    await watcher.start()
    for _ in range(300):
        models = manager.list_models()
        if models:
            return manager.get(models[0]), models[0]
        await asyncio.sleep(0.1)
    raise TimeoutError("no models discovered within 30s")
