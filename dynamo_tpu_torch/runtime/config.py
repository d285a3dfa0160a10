"""Layered runtime configuration: defaults <- TOML file <- DYN_* env vars.

The port's own copy of dynamo_tpu/runtime/config.py's ``RuntimeConfig``.
In place of the reference's JAX compilation cache
(``setup_jax_compilation_cache``) the port has a kernel-cache directory,
``kernel_cache_dir()``: ``DYN_KERNEL_CACHE_DIR``, else ``build/kernels`` at
the root of the checkout, where ``ops/_build.py`` builds and finds the CUDA
libraries. ``http_enabled`` / ``http_port`` (``DYN_RUNTIME_HTTP_ENABLED``,
``DYN_RUNTIME_HTTP_PORT``) start a worker's system status server
(``runtime/http_server.py``), off by default as in the reference.

Role-equivalent of the reference's Figment-based RuntimeConfig/WorkerConfig
(lib/runtime/src/config.rs:30-130).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, fields
from typing import Any, Optional


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def kernel_cache_dir() -> str:
    """The directory of the built CUDA kernel libraries:
    ``DYN_KERNEL_CACHE_DIR`` (``~`` expanded), else ``build/kernels`` at the
    root of the checkout. A library's name carries the hash of its source
    and flags, so one directory serves any number of checkouts' builds."""
    raw = (os.environ.get("DYN_KERNEL_CACHE_DIR") or "").strip()
    if raw:
        return os.path.abspath(os.path.expanduser(raw))
    return os.path.join(_CHECKOUT, "build", "kernels")


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(name, default)


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else default


@dataclass
class RuntimeConfig:
    """Per-process runtime settings.

    Environment overrides (highest precedence):
      DYN_FABRIC_ADDR       host:port of the fabric server ("" => in-process)
      DYN_TCP_HOST          advertised host for the TCP response plane
      DYN_TCP_PORT          fixed port for the TCP response plane (0 = ephemeral)
      DYN_LEASE_TTL_S       discovery lease TTL seconds
      DYN_NAMESPACE         default namespace
      DYN_DEGRADED_MAX_S    control-plane blackout budget: how long the
                            data plane keeps serving (degraded, publishes
                            buffered) with the fabric unreachable before
                            workers self-fence / clients close streams
      DYN_WARM_RESTART_DIR  checkpoint dir for warm restarts: SIGTERM
                            drain writes the KV offload tiers + prefix
                            index as checksummed pages; boot restores
                            them so restarts rejoin warm
      DYN_RUNTIME_HTTP_ENABLED / DYN_RUNTIME_HTTP_PORT  system health/metrics server
    """

    fabric_addr: str = ""
    tcp_host: str = "127.0.0.1"
    tcp_port: int = 0
    lease_ttl_s: float = 10.0
    namespace: str = "dynamo"
    degraded_max_s: float = 45.0
    warm_restart_dir: str = ""
    http_enabled: bool = False
    http_port: int = 9090

    @classmethod
    def from_settings(cls, config_path: Optional[str] = None) -> "RuntimeConfig":
        values: dict[str, Any] = {}
        path = config_path or _env("DYN_RUNTIME_CONFIG")
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                doc = tomllib.load(f)
            section = doc.get("runtime", doc)
            known = {f.name for f in fields(cls)}
            values.update({k: v for k, v in section.items() if k in known})
        cfg = cls(**values)
        cfg.fabric_addr = _env("DYN_FABRIC_ADDR", cfg.fabric_addr) or ""
        cfg.tcp_host = _env("DYN_TCP_HOST", cfg.tcp_host) or cfg.tcp_host
        cfg.tcp_port = _env_int("DYN_TCP_PORT", cfg.tcp_port)
        ttl = _env("DYN_LEASE_TTL_S")
        if ttl is not None:
            cfg.lease_ttl_s = float(ttl)
        cfg.namespace = _env("DYN_NAMESPACE", cfg.namespace) or cfg.namespace
        degraded = _env("DYN_DEGRADED_MAX_S")
        if degraded:
            cfg.degraded_max_s = float(degraded)
        cfg.warm_restart_dir = _env("DYN_WARM_RESTART_DIR", cfg.warm_restart_dir) or ""
        cfg.http_enabled = _env_bool("DYN_RUNTIME_HTTP_ENABLED", cfg.http_enabled)
        cfg.http_port = _env_int("DYN_RUNTIME_HTTP_PORT", cfg.http_port)
        return cfg
