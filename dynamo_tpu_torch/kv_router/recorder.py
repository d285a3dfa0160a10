"""JSONL event recorder/replayer for router events.

The port's own copy of dynamo_tpu/kv_router/recorder.py.

Role-equivalent of lib/llm/src/recorder.rs (Recorder<T> :37) +
kv_router/recorder.rs: append events with timestamps to a JSONL file; replay
them later (optionally time-scaled) to reconstruct router state offline —
the reference ships replay traces in tests/data/replays for this.
"""

from __future__ import annotations

import asyncio
import json
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

from dynamo_tpu_torch.kv_router.protocols import RouterEvent


class KvRecorder:
    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self._fh = self.path.open("a", encoding="utf-8")
        self.count = 0

    def record(self, event: RouterEvent) -> None:
        line = json.dumps({"ts": time.time(), "event": event.to_dict()})
        self._fh.write(line + "\n")
        self._fh.flush()
        self.count += 1

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "KvRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_replay(path: str | Path) -> Iterator[tuple[float, RouterEvent]]:
    with Path(path).open(encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            yield d["ts"], RouterEvent.from_dict(d["event"])


async def replay(
    path: str | Path,
    apply: Callable[[RouterEvent], None],
    timed: bool = False,
    max_count: Optional[int] = None,
) -> int:
    """Feed recorded events to `apply` (e.g. indexer.apply_event).

    timed=True reproduces the original inter-event gaps.
    """
    n = 0
    prev_ts: Optional[float] = None
    for ts, event in iter_replay(path):
        if timed and prev_ts is not None and ts > prev_ts:
            await asyncio.sleep(ts - prev_ts)
        prev_ts = ts
        apply(event)
        n += 1
        if max_count is not None and n >= max_count:
            break
    return n
