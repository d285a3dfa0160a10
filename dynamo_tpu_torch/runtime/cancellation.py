"""Hierarchical cancellation tokens.

The port's own copy of dynamo_tpu/runtime/cancellation.py.

Equivalent in role to the reference runtime's tokio CancellationToken cascade
(lib/runtime/src/distributed.rs:122-135): a parent token's cancellation
propagates to every child, and arbitrary async work can await cancellation.
"""

from __future__ import annotations

import asyncio
import contextlib
import weakref
from typing import Callable, Optional


class CancellationToken:
    """A cooperatively-checked cancellation flag that cascades to children."""

    __slots__ = ("_event", "_children", "_callbacks", "__weakref__")

    def __init__(self) -> None:
        self._event = asyncio.Event()
        self._children: "weakref.WeakSet[CancellationToken]" = weakref.WeakSet()
        self._callbacks: list[Callable[[], None]] = []

    def child_token(self) -> "CancellationToken":
        child = CancellationToken()
        if self.is_cancelled():
            child.cancel()
        else:
            self._children.add(child)
        return child

    def cancel(self) -> None:
        if self._event.is_set():
            return
        self._event.set()
        for child in list(self._children):
            child.cancel()
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            with contextlib.suppress(Exception):
                cb()

    def is_cancelled(self) -> bool:
        return self._event.is_set()

    def on_cancel(self, cb: Callable[[], None]) -> None:
        """Register a synchronous callback fired exactly once on cancellation."""
        if self.is_cancelled():
            cb()
        else:
            self._callbacks.append(cb)

    async def cancelled(self) -> None:
        """Await until the token is cancelled."""
        await self._event.wait()

    async def run_until_cancelled(self, coro) -> Optional[object]:
        """Run ``coro``, aborting it (with asyncio cancellation) if this token
        fires first. Returns the coroutine result or None if cancelled."""
        task = asyncio.ensure_future(coro)
        waiter = asyncio.ensure_future(self._event.wait())
        try:
            done, _ = await asyncio.wait(
                {task, waiter}, return_when=asyncio.FIRST_COMPLETED
            )
            if task in done:
                return task.result()
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
            return None
        finally:
            if not waiter.done():
                waiter.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await waiter
