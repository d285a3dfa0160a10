"""`python -m dynamo_tpu_torch.serve <graph>` — launch a serve graph supervised.

The port's own copy of dynamo_tpu/serve.py (its graphs are
``dynamo_tpu_torch.graphs``). A graph started with ``DYN_FAULT`` set is
refused: the fault hooks are not ported (ROADMAP.md A7).

Role-equivalent of the reference's `dynamo serve graphs.disagg:Frontend`
(deploy/sdk/src/dynamo/sdk/cli/serving.py:152): one command starts the
fabric control plane (unless DYN_FABRIC_ADDR points at one), then every
@service of the graph as supervised OS processes — dependencies first,
crash ⇒ restart with backoff, SIGINT/SIGTERM ⇒ graceful teardown.

    python -m dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.agg \
        --env DYN_HTTP_PORT=8080 --env DYN_ROUTER_MODE=kv --replicas Worker=4
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import socket
from typing import Optional

from dynamo_tpu_torch.sdk import Supervisor, load_graph
from dynamo_tpu_torch.sdk.runner import refuse_faults

logger = logging.getLogger("dynamo_tpu_torch.serve")


def _drain_timeout_s() -> float:
    """Graceful-drain budget for SIGTERM teardown (DYN_DRAIN_TIMEOUT_S)."""
    return float(os.environ.get("DYN_DRAIN_TIMEOUT_S", "10"))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def _wait_port(host: str, port: int, timeout: float = 10.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        try:
            _, w = await asyncio.open_connection(host, port)
            w.close()
            await w.wait_closed()
            return
        except OSError:
            await asyncio.sleep(0.1)
    raise TimeoutError(f"fabric server not reachable on {host}:{port}")


async def serve_graph(
    graph_module: str,
    *,
    extra_env: Optional[dict[str, str]] = None,
    replica_overrides: Optional[dict[str, int]] = None,
    fabric_addr: Optional[str] = None,
    only: Optional[set[str]] = None,
) -> Supervisor:
    """Start the graph; returns the running Supervisor (also the FT-test
    entry point — tests kill members and assert recovery)."""
    if "." not in graph_module:
        graph_module = f"dynamo_tpu_torch.graphs.{graph_module}"
    refuse_faults({**os.environ, **(extra_env or {})})
    sup = Supervisor()
    addr = fabric_addr or os.environ.get("DYN_FABRIC_ADDR")
    if not addr:
        port = _free_port()
        fabric_proc = sup.add_python(
            "fabric", "dynamo_tpu_torch.fabric.server", "--port", str(port),
            max_restarts=10,
        )
        fabric_proc.stop_last = True  # services deregister before it dies
        addr = f"127.0.0.1:{port}"
    specs = load_graph(graph_module)
    for spec in specs:
        refuse_faults(spec.env)
    if only:
        # one service of the graph per process — how the k8s operator
        # deploys graphs (each spec.services entry is its own Deployment)
        unknown = only - {s.name for s in specs}
        if unknown:
            raise SystemExit(
                f"--only {sorted(unknown)}: not in graph "
                f"{[s.name for s in specs]}"
            )
        specs = [s for s in specs if s.name in only]
    logger.info(
        "graph %s: %s (fabric %s)",
        graph_module, [s.name for s in specs], addr,
    )
    await sup.start_all()  # fabric first, so children can connect
    # addr may list an HA pair ("h1:p1,h2:p2"); any reachable member is
    # enough to proceed (the client finds the primary itself)
    last_err: Optional[Exception] = None
    for member in addr.split(","):
        host, _, port_s = member.strip().partition(":")
        try:
            await _wait_port(host, int(port_s))
            break
        except TimeoutError as e:
            last_err = e
    else:
        raise last_err or TimeoutError(f"no fabric member reachable: {addr}")
    for spec in specs:
        n = (replica_overrides or {}).get(spec.name, spec.replicas)
        for r in range(n):
            sup.add_python(
                f"{spec.name}-{r}",
                "dynamo_tpu_torch.sdk.runner",
                spec.target,
                env={
                    "DYN_FABRIC_ADDR": addr,
                    **spec.env,
                    **(extra_env or {}),
                },
            )
    await sup.start_all()
    return sup


def main(argv: Optional[list[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="dynamo_tpu_torch.serve")
    parser.add_argument("graph", help="graph module (e.g. dynamo_tpu_torch.graphs.agg)")
    parser.add_argument(
        "--env", action="append", default=[], metavar="KEY=VAL",
        help="extra env for every service process",
    )
    parser.add_argument(
        "--replicas", action="append", default=[], metavar="NAME=N",
        help="override a service's replica count",
    )
    parser.add_argument("--fabric-addr", default=None)
    parser.add_argument(
        "--only", action="append", default=[], metavar="NAME",
        help="launch only these graph services (repeatable; the k8s "
        "operator runs one service per Deployment this way)",
    )
    args = parser.parse_args(argv)
    extra_env = dict(kv.split("=", 1) for kv in args.env)
    replicas = {
        k: int(v) for k, v in (kv.split("=", 1) for kv in args.replicas)
    }

    async def amain() -> None:
        sup = await serve_graph(
            args.graph,
            extra_env=extra_env,
            replica_overrides=replicas,
            fabric_addr=args.fabric_addr,
            only=set(args.only) or None,
        )
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        logger.info("stopping graph (drain %ss)", _drain_timeout_s())
        # SIGTERM reaches each service's runner, which drains (stop
        # admission -> finish in-flight -> deregister) before exiting; the
        # supervisor's SIGKILL deadline leaves headroom for that drain
        await sup.stop_all(timeout=_drain_timeout_s() + 5.0)

    asyncio.run(amain())


if __name__ == "__main__":
    main()
