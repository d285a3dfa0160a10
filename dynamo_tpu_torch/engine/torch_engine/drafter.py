"""Host-side self-drafting proposer for speculative decoding.

Counterpart of dynamo_tpu/engine/jax_engine/drafter.py (``NgramDrafter``,
``make_drafter``), numpy only. No draft model: drafts come from the
sequence's own token history (prompt lookup). The most recent continuation
of the current tail n-gram is proposed, and the verify pass
(``TorchModelRunner.spec_verify``) keeps the output stream exactly the
model's own. The drafter is stateless per call; the engine calls
``draft(token_ids)`` per lane between dispatches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# backwards search window: repetition that pays is recent, and a scan over
# the whole context per lane per dispatch would load the scheduling path
SEARCH_WINDOW = 4096


class NgramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most recent
    earlier occurrence of the sequence's tail n-gram, longest n first
    (``max_n`` down to ``min_n``)."""

    def __init__(self, max_k: int, min_n: int = 2, max_n: int = 4) -> None:
        if max_k < 1 or not 1 <= min_n <= max_n:
            raise ValueError(f"bad drafter bounds max_k={max_k} min_n={min_n} max_n={max_n}")
        self.max_k = max_k
        self.min_n = min_n
        self.max_n = max_n

    def draft(self, token_ids: list[int], k: Optional[int] = None) -> list[int]:
        """Up to min(k, max_k) proposed continuation tokens; [] = no match
        (the lane decodes normally this dispatch)."""
        k = self.max_k if k is None else min(k, self.max_k)
        if k <= 0:
            return []
        arr = np.asarray(token_ids[-SEARCH_WINDOW:], dtype=np.int64)
        L = len(arr)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            tail = arr[L - n:]
            # candidate starts: the tail's first token in arr[: L - n] (the
            # tail's own occurrence excluded)
            starts = np.nonzero(arr[: L - n] == tail[0])[0]
            # most recent match first, but prefer one whose continuation
            # holds all k tokens (the latest match often sits right before
            # the tail, its continuation cut by the end of the history)
            short: Optional[np.ndarray] = None
            for s in starts[::-1]:
                if not np.array_equal(arr[s:s + n], tail):
                    continue
                cont = arr[s + n:s + n + k]
                if cont.size == k:
                    return [int(t) for t in cont]
                if cont.size and short is None:
                    short = cont
            if short is not None:
                return [int(t) for t in short]
        return []


def make_drafter(kind: str, max_k: int, min_n: int = 2, max_n: int = 4) -> NgramDrafter:
    """"ngram" (alias "prompt_lookup") is the only drafter kind."""
    if kind in ("ngram", "prompt_lookup"):
        return NgramDrafter(max_k, min_n=min_n, max_n=max_n)
    raise ValueError(f"unknown drafter kind: {kind!r}")
