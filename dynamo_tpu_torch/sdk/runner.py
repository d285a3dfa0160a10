"""Child-process entry for one service of a serve graph.

    python -m dynamo_tpu_torch.sdk.runner pkg.graphmodule:ClassName

The port's own copy of dynamo_tpu/sdk/runner.py. A child started with
``DYN_FAULT`` set arms its fault injector (``testing/faults.py``) before it
serves: the spec is parsed at once, so a malformed one ends the child with
its parse error instead of serving without the fault.

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


def main() -> None:
    if len(sys.argv) != 2 or ":" not in sys.argv[1]:
        raise SystemExit("usage: python -m dynamo_tpu_torch.sdk.runner module:Class")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from dynamo_tpu_torch.testing import faults

    faults.get_injector()  # DYN_FAULT: parsed (a typo raises) and armed
    asyncio.run(_amain(sys.argv[1]))


if __name__ == "__main__":
    main()
