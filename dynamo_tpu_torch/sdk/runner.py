"""Child-process entry for one service of a serve graph.

    python -m dynamo_tpu_torch.sdk.runner pkg.graphmodule:ClassName

The port's own copy of dynamo_tpu/sdk/runner.py. The reference's fault
hooks (``DYN_FAULT``, ``testing/faults.py``) are not ported (ROADMAP.md A7):
a child started with ``DYN_FAULT`` set refuses to start rather than run
without its fault.

Builds a fabric-connected DistributedRuntime from the environment
(DYN_FABRIC_ADDR et al.), instantiates the @service class, and awaits its
``serve(runtime)`` forever. SIGTERM triggers a graceful drain — serving
surfaces registered with ``runtime.on_drain`` stop admitting, finish
in-flight requests (bounded by DYN_DRAIN_TIMEOUT_S), and deregister from
discovery — before the task is cancelled, so a scale-down never kills live
streams. Role-equivalent of the worker entry the reference's circus
watchers exec (serving.py:152)."""

from __future__ import annotations

import asyncio
import importlib
import logging
import os
import signal
import sys


async def _amain(target: str) -> None:
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    mod_name, _, cls_name = target.partition(":")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    runtime = await DistributedRuntime.from_settings()
    svc = cls()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    serve_task = asyncio.create_task(svc.serve(runtime))
    stop_task = asyncio.create_task(stop.wait())
    done, _ = await asyncio.wait(
        {serve_task, stop_task}, return_when=asyncio.FIRST_COMPLETED
    )
    if serve_task in done:
        # propagate a crashed serve() as a nonzero exit for the supervisor
        serve_task.result()
    else:
        # graceful drain before teardown: stop admission, let in-flight
        # requests finish (bounded), deregister from discovery, then exit
        await runtime.drain(
            timeout_s=float(os.environ.get("DYN_DRAIN_TIMEOUT_S", "10"))
        )
        serve_task.cancel()
        try:
            await serve_task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
    await runtime.close()


FAULTS_MISSING = (
    "DYN_FAULT asks for the fault-injection hooks (testing/faults.py), which the port "
    "does not have yet: ROADMAP.md A7"
)


def refuse_faults(env=None) -> None:
    """A service asked to inject a fault must not run without it."""
    if (env if env is not None else os.environ).get("DYN_FAULT"):
        raise NotImplementedError(FAULTS_MISSING)


def main() -> None:
    if len(sys.argv) != 2 or ":" not in sys.argv[1]:
        raise SystemExit("usage: python -m dynamo_tpu_torch.sdk.runner module:Class")
    refuse_faults()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    asyncio.run(_amain(sys.argv[1]))


if __name__ == "__main__":
    main()
