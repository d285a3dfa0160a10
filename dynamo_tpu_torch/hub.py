"""Model resolution: a name or path -> a servable local path.

The port's own copy of dynamo_tpu/hub.py (the role of the reference's
lib/llm/src/hub.rs:105 ``from_hf``): a local directory or a ``.gguf`` file
as it is; a HuggingFace repo id through the standard HF cache layout
(``models--org--name/snapshots/<rev>``, the newest revision holding a
``config.json`` or a ``.gguf``) under ``DYN_MODEL_CACHE``, then
``$HF_HOME/hub``, then ``~/.cache/huggingface/hub``; a revision with no
``config.json`` resolves to its first ``.gguf`` file. Downloading is GATED
(``DYN_ALLOW_DOWNLOAD=1`` and ``huggingface_hub`` importable), as serving
fleets are commonly egress-less: the error says what to pre-stage where. A
frontend imports this module, so it imports no torch.
"""

from __future__ import annotations

import os
from typing import Optional

from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger("dynamo_tpu_torch.hub")


def _cache_roots() -> list[str]:
    roots = []
    if os.environ.get("DYN_MODEL_CACHE"):
        roots.append(os.environ["DYN_MODEL_CACHE"])
    hf_home = os.environ.get("HF_HOME")
    if hf_home:
        roots.append(os.path.join(hf_home, "hub"))
    roots.append(os.path.expanduser("~/.cache/huggingface/hub"))
    return roots


def _find_in_cache(repo_id: str) -> Optional[str]:
    folder = "models--" + repo_id.replace("/", "--")
    for root in _cache_roots():
        snaps = os.path.join(root, folder, "snapshots")
        if not os.path.isdir(snaps):
            continue
        revs = sorted(
            (os.path.join(snaps, d) for d in os.listdir(snaps)),
            key=os.path.getmtime,
            reverse=True,
        )
        for rev in revs:
            if os.path.exists(os.path.join(rev, "config.json")) or any(
                f.endswith(".gguf") for f in os.listdir(rev)
            ):
                return rev
    return None


def resolve_model(name_or_path: str) -> str:
    """Local dir / .gguf file as-is; else HF-cache lookup; else a gated
    download; else an actionable error."""
    if os.path.isdir(name_or_path):
        return name_or_path
    if os.path.isfile(name_or_path) and name_or_path.endswith(".gguf"):
        return name_or_path
    cached = _find_in_cache(name_or_path)
    if cached:
        if not os.path.exists(os.path.join(cached, "config.json")):
            # a GGUF repo (no config.json): its first .gguf file is the
            # model (the reference returns the snapshot directory, which
            # its factory then cannot read)
            cached = os.path.join(cached, sorted(f for f in os.listdir(cached)
                                                 if f.endswith(".gguf"))[0])
        logger.info("resolved %s -> %s (hf cache)", name_or_path, cached)
        return cached
    if os.environ.get("DYN_ALLOW_DOWNLOAD") == "1":
        try:
            from huggingface_hub import snapshot_download  # type: ignore

            path = snapshot_download(name_or_path)
            logger.info("downloaded %s -> %s", name_or_path, path)
            return path
        except ImportError:
            raise FileNotFoundError(
                f"model {name_or_path!r}: DYN_ALLOW_DOWNLOAD=1 but "
                "huggingface_hub is not installed"
            ) from None
    raise FileNotFoundError(
        f"model {name_or_path!r} not found: not a local dir/.gguf, not in "
        f"the HF cache ({', '.join(_cache_roots())}). Pre-stage the model "
        "(huggingface-cli download on a connected host, or set "
        "DYN_MODEL_CACHE), or set DYN_ALLOW_DOWNLOAD=1 where egress exists."
    )
