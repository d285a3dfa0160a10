"""The prebake manifest.

The port's own copy of the manifest part of dynamo_tpu/telemetry/goodput.py
(``PREBAKE_MANIFEST``, ``normalize_label``, ``load_prebaked_labels``,
``write_prebake_manifest``, :487-560): ``tools/prebake.py`` drops the
manifest into the kernel-cache directory, in the reference's format, so
either package's reader reads either's file. The rest of goodput.py (the
goodput ledger) is ROADMAP A12's. Stdlib only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

PREBAKE_MANIFEST = "prebake_manifest.json"


def normalize_label(label: str) -> str:
    """Map a prebake program label to its dispatch label: prebake bakes
    per-shape programs (``prefill@2048``, ``decode_multi@H4``,
    ``decode_eos``) while the engine dispatches under the base label."""
    base = label.split("@", 1)[0]
    return "decode" if base == "decode_eos" else base


def load_prebaked_labels(cache_dir: Optional[str]) -> frozenset[str]:
    """Dispatch labels covered by an earlier prebake run (read from the
    manifest it dropped in the cache directory); empty when there is
    none."""
    if not cache_dir:
        return frozenset()
    path = os.path.join(cache_dir, PREBAKE_MANIFEST)
    try:
        with open(path) as f:
            doc = json.load(f)
        labels = doc.get("labels") or []
        return frozenset(normalize_label(str(x)) for x in labels)
    except (OSError, ValueError):
        return frozenset()


def write_prebake_manifest(
    cache_dir: Optional[str], programs: list, extra: Optional[dict] = None
) -> Optional[str]:
    """Drop the manifest ``load_prebaked_labels`` reads: the labels, each
    program's (label, seconds) and the time. ``extra`` adds keys of the
    port's own (the kernel libraries, the captured graph keys); the
    reference's reader ignores them. Returns the path, or None when the
    directory is missing or the write fails."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return None
    path = os.path.join(cache_dir, PREBAKE_MANIFEST)
    doc = {
        "labels": sorted({normalize_label(lbl) for lbl, _ in programs}),
        "programs": [[lbl, s] for lbl, s in programs],
        "baked_at": time.time(),
        **(extra or {}),
    }
    try:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    except OSError:
        return None
    return path
