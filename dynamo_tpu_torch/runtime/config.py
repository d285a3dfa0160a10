"""Layered runtime configuration: defaults <- TOML file <- DYN_* env vars.

The port's own copy of dynamo_tpu/runtime/config.py's ``RuntimeConfig``.
Left out: the JAX compilation cache (``setup_jax_compilation_cache``,
``default_jax_cache_dir``) and the runtime HTTP server's knobs: nothing in
the port serves health or metrics yet, so ``DYN_RUNTIME_HTTP_ENABLED=1``
(or ``http_enabled = true`` in the TOML file) is refused rather than
ignored.

Role-equivalent of the reference's Figment-based RuntimeConfig/WorkerConfig
(lib/runtime/src/config.rs:30-130).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, fields
from typing import Any, Optional


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


def _refuse_http() -> None:
    raise NotImplementedError(
        "the runtime's health/metrics HTTP server is not ported yet "
        "(ROADMAP Queue A, item 10: runtime/http_server.py and /metrics); "
        "unset DYN_RUNTIME_HTTP_ENABLED"
    )


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
    """

    fabric_addr: str = ""
    tcp_host: str = "127.0.0.1"
    tcp_port: int = 0
    lease_ttl_s: float = 10.0
    namespace: str = "dynamo"
    degraded_max_s: float = 45.0
    warm_restart_dir: str = ""

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
            if section.get("http_enabled"):
                _refuse_http()
        if _env_bool("DYN_RUNTIME_HTTP_ENABLED", False):
            _refuse_http()
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
        return cfg
