"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each source in ``dynamo_tpu_torch/csrc/`` becomes one shared library with a
plain C interface (a kernel with an int8 mode exports both modes' entry
points from its one library), compiled for Hopper (``sm_90a``) on first use into
the kernel cache directory (``runtime/config.kernel_cache_dir``:
``DYN_KERNEL_CACHE_DIR``, else ``build/kernels/`` at the root of the
checkout; ``tools/prebake.py`` fills it ahead of serving). The library name carries a
hash of the source, the shared ``*.cuh`` headers and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here runs at import time: the CPU
tests import every module of the package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from dynamo_tpu_torch.runtime.config import kernel_cache_dir

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (
    "paged_decode_attention",
    "flash_prefill_attention",
    "paged_verify_attention",
    "fused_qkv_rope",
    "fused_attn_out_residual",
    "grouped_swiglu_ffn",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# libraries loaded into this process so far (a runner's warm events), and
# the nvcc processes this process started
load_events = 0
nvcc_runs = 0
# per source: {"seconds": build time (0.0 when loaded from an earlier
# build), "ptxas": the compiler's register/spill report}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH and /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source on first use"
    )


def build_dir() -> Path:
    """Where the libraries are built and looked for."""
    return Path(kernel_cache_dir())


def _target(name: str) -> Path:
    # the shared headers are hashed too: a source's library changes with them
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))
    )
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str) -> subprocess.Popen | None:
    """Start nvcc for one source unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    global nvcc_runs
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc_runs += 1
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every missing library, one nvcc per source, all at once.
    Raises RuntimeError with the compiler's output if any build fails."""
    with _lock:
        t0 = time.perf_counter()
        procs = {n: _start(n) for n in names if n not in _libs}
        errors = []
        for name, proc in procs.items():
            if proc is None:
                build_info.setdefault(name, {"seconds": 0.0, "ptxas": ""})
                continue
            log, _ = proc.communicate()
            out = _target(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
            build_info[name] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": log,
            }
        if errors:
            raise RuntimeError("\n".join(errors))
        return dict(build_info)


def load(name: str) -> ctypes.CDLL:
    """The built library for one source (building it first if needed)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    global load_events
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
            load_events += 1
    return lib
