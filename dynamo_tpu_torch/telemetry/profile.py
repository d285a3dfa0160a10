"""On-demand device profiling around engine dispatches.

The port's own copy of dynamo_tpu/telemetry/profile.py on ``torch.profiler``
(CPU ops and, on a card, the CUDA kernels through CUPTI) in place of
``jax.profiler``: a window is opened on demand -- ``GET
/debug/profile?seconds=N`` on the frontend, or programmatically -- and
written, when it closes, as a Chrome trace (``trace.json``, viewable in
Perfetto or chrome://tracing) under ``DYN_PROFILE_DIR``. While a window is
open, engine dispatches annotate themselves (``annotate(label)``, a
``torch.profiler.record_function``), so the device timeline carries the
same phase names as the request traces. Every thread's ops are recorded
(the engine dispatches on its own device thread).

This module does not import torch: a frontend imports it, and importing
torch on a frontend's event loop costs seconds (it once cost a frontend its
fabric lease). ``start()`` uses torch only where the process already
imported it (an engine's process); elsewhere (an ``out=dyn`` frontend, the
echo engine) it reports the error instead, in the reference's shape, and
``annotate()`` is a no-op.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import sys
import tempfile
import threading
import time
from typing import Any, Iterator, Optional

from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger("dynamo_tpu_torch.telemetry.profile")

TRACE_FILE = "trace.json"

_active: bool = False  # fast flag for the dispatch-annotation hot path
_lock = threading.Lock()
_session: Optional[dict[str, Any]] = None
_prof: Any = None


def default_dir() -> str:
    return os.environ.get(
        "DYN_PROFILE_DIR", os.path.join(tempfile.gettempdir(), "dynamo_tpu_torch_profile")
    )


def active() -> bool:
    return _active


def _profiler(torch):
    """A profiler of every thread's ops, and of the card's kernels when
    CUDA is up (``profile_all_threads`` where this torch has it)."""
    tp = torch.profiler
    acts = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(tp.ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        cfg = None
    return tp.profile(activities=acts, experimental_config=cfg)


def start(
    seconds: float = 5.0, out_dir: Optional[str] = None
) -> dict[str, Any]:
    """Open a torch.profiler window for ``seconds`` (auto-stopped by a
    timer thread, so one HTTP poke profiles a live server hands-free).
    Returns {"profile_dir", "seconds"} or {"error": ...}."""
    global _active, _session, _prof
    seconds = max(0.1, min(float(seconds), 300.0))
    out_dir = out_dir or default_dir()
    with _lock:
        if _active:
            return {"error": "a profile window is already open", **(_session or {})}
        torch = sys.modules.get("torch")
        if torch is None:
            # never imported here: this process runs no engine, and the
            # import would block its event loop for seconds
            return {"error": "torch unavailable: this process has not imported it "
                             "(no engine runs here)"}
        run_dir = os.path.join(out_dir, time.strftime("%Y%m%d-%H%M%S"))
        try:
            os.makedirs(run_dir, exist_ok=True)
            prof = _profiler(torch)
            prof.start()
        except Exception as e:  # noqa: BLE001 — profiler init failure
            return {"error": f"profiler start failed: {e}"}
        _prof = prof
        _active = True
        _session = {"profile_dir": run_dir, "seconds": seconds}
        timer = threading.Timer(seconds, stop)
        timer.daemon = True
        timer.start()
        logger.info("device profile window open: %s (%.1fs)", run_dir, seconds)
        return dict(_session)


def stop() -> Optional[dict[str, Any]]:
    """Close the open window (idempotent) and write its trace. Returns the
    session info. ``active()`` stays true until the trace is written."""
    global _active, _session, _prof
    with _lock:
        if not _active:
            return None
        info, prof = _session, _prof
        try:
            prof.stop()
            path = os.path.join((info or {}).get("profile_dir", default_dir()), TRACE_FILE)
            prof.export_chrome_trace(path)
            logger.info("device profile window closed: %s", path)
        except Exception:  # noqa: BLE001 — stop after runtime teardown
            logger.exception("profiler stop failed")
        finally:
            _active, _session, _prof = False, None, None
        return info


async def run_window(seconds: float, out_dir: Optional[str] = None) -> dict:
    """Async convenience: open a window, sleep through it, return info."""
    info = start(seconds, out_dir)
    if "error" not in info:
        await asyncio.sleep(seconds)
    return info


@contextlib.contextmanager
def annotate(label: str) -> Iterator[None]:
    """Name the current device dispatch on the profiler timeline. No-op
    unless a profile window is open (one flag check on the hot path)."""
    if not _active:
        yield
        return
    try:
        cm = sys.modules["torch"].profiler.record_function(label)
        cm.__enter__()
    except Exception:  # noqa: BLE001 — annotation must never break serving
        yield
        return
    try:
        yield
    finally:
        with contextlib.suppress(Exception):
            cm.__exit__(None, None, None)
