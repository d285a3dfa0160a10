"""The KV-block hash chain in C, built on first use with the system compiler.

The port's own copy of dynamo_tpu/native/: ``blockhash.c`` is compiled
once (``cc -O3 -shared -fPIC``) into ``build/native/`` at the root of the
checkout, never beside the source. The library's name carries a hash of the
source, and the build writes a temporary file that is renamed into place,
so processes that start together (a serve graph's workers) never load a
half-written library and an edited source is rebuilt.

``tokens.compute_block_hash`` / ``compute_seq_hash_chain`` dispatch here
and take the pure-Python path, which gives the same digests, when
``DYN_NO_NATIVE`` is set, when an input is out of the C code's bounds (an
empty block or more than 1024 tokens a block, a salt outside u64, an id
outside u32) or when the build fails; a failed build is logged once at
WARNING with the compiler's message. ``native_available()`` says which
path runs.
"""

from __future__ import annotations

import array
import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger("dynamo_tpu_torch.native")

# on an ABI whose C ``unsigned int`` is not 32 bits the C hasher would read
# the token buffer with another layout: the Python path runs there instead
_U32_OK = array.array("I").itemsize == 4
_MAX_BLOCK = 1024  # the C code's bound on tokens per block
_U64 = 1 << 64

_SRC = Path(__file__).resolve().parent / "blockhash.c"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "native"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    digest = hashlib.blake2b(_SRC.read_bytes(), digest_size=8).hexdigest()
    return BUILD_DIR / f"libblockhash-{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = None if os.environ.get("DYN_NO_NATIVE") else _build_and_load()
            _tried = True
    return _lib


def _build_and_load() -> Optional[ctypes.CDLL]:
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC", str(_SRC), "-o", tmp],
                    check=True, capture_output=True, text=True, timeout=60,
                )
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
    except subprocess.CalledProcessError as e:
        logger.warning("building %s failed; block hashes use the Python path:\n%s",
                       _SRC.name, (e.stderr or e.stdout or "").strip())
        return None
    except Exception as e:  # noqa: BLE001 - no compiler, no writable build dir
        logger.warning("native block hash unavailable (%s: %s); block hashes use the "
                       "Python path", type(e).__name__, e)
        return None
    lib.block_hash.restype = ctypes.c_uint64
    lib.block_hash.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
    ]
    lib.hash_chain.restype = ctypes.c_size_t
    lib.hash_chain.argtypes = [
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    return lib


def native_available() -> bool:
    """Whether the C library is loaded (building it on the first call)."""
    return _load() is not None


def _tok_buffer(tokens: list[int]):
    """The ids as a C u32 buffer (one C-speed copy through ``array``), or
    None when an id does not fit in u32."""
    if not _U32_OK:
        return None
    try:
        arr = array.array("I", tokens)
    except (OverflowError, TypeError):
        return None
    return (ctypes.c_uint32 * len(arr)).from_buffer(arr)


def block_hash(parent: int, tokens: list[int], salt: int = 0) -> Optional[int]:
    """One block's hash, or None when the library is not loaded or the
    input is out of bounds."""
    lib = _load()
    n = len(tokens)
    if lib is None or not 0 < n <= _MAX_BLOCK or not 0 <= salt < _U64:
        return None
    buf = _tok_buffer(tokens)
    if buf is None:
        return None
    return int(lib.block_hash(parent & (_U64 - 1), salt, buf, n))


def hash_chain(tokens: list[int], block_size: int, salt: int = 0) -> Optional[list[int]]:
    """The hashes of every complete block, or None when the library is not
    loaded or the input is out of bounds."""
    lib = _load()
    if lib is None or not 0 < block_size <= _MAX_BLOCK or not 0 <= salt < _U64:
        return None
    nb = len(tokens) // block_size
    if nb == 0:
        return []
    buf = _tok_buffer(tokens)
    if buf is None:
        return None
    out = (ctypes.c_uint64 * nb)()
    got = lib.hash_chain(salt, buf, len(tokens), block_size, out)
    return list(out[:got])
