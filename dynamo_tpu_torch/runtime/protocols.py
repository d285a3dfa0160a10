"""Endpoint identifiers and discovery paths.

The port's own copy of dynamo_tpu/runtime/protocols.py.

Role-equivalent of lib/runtime/src/protocols.rs: the `dyn://ns.comp.ep`
scheme, instance key layout (component.rs:67-72), and Instance records
(component.rs:92).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

ENDPOINT_SCHEME = "dyn://"
INSTANCE_ROOT = "instances/"
MODEL_ROOT = "models/"


@dataclass(frozen=True)
class EndpointId:
    namespace: str
    component: str
    name: str

    @classmethod
    def parse(cls, s: str, default_namespace: str = "dynamo") -> "EndpointId":
        """Parse "dyn://ns.comp.ep", "ns.comp.ep", or "comp.ep"."""
        if s.startswith(ENDPOINT_SCHEME):
            s = s[len(ENDPOINT_SCHEME) :]
        parts = [p for p in s.replace("/", ".").split(".") if p]
        if len(parts) == 2:
            parts = [default_namespace, *parts]
        if len(parts) != 3:
            raise ValueError(
                f"invalid endpoint id {s!r}: want [ns.]component.endpoint"
            )
        return cls(*parts)

    def __str__(self) -> str:
        return f"{ENDPOINT_SCHEME}{self.namespace}.{self.component}.{self.name}"

    # --- fabric addressing ---

    @property
    def instance_prefix(self) -> str:
        return f"{INSTANCE_ROOT}{self.namespace}/{self.component}/{self.name}:"

    def instance_key(self, instance_id: int) -> str:
        return f"{self.instance_prefix}{instance_id:x}"

    @property
    def subject(self) -> str:
        """Load-balanced request subject (queue-group delivery)."""
        return f"rq.{self.namespace}.{self.component}.{self.name}"

    def direct_subject(self, instance_id: int) -> str:
        return f"{self.subject}.{instance_id:x}"

    def stats_subject(self, instance_id: int) -> str:
        return f"stats.{self.namespace}.{self.component}.{self.name}.{instance_id:x}"


@dataclass
class Instance:
    """A live, discoverable endpoint replica (reference component.rs:92)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int
    transport: dict[str, Any] = field(default_factory=dict)

    @property
    def endpoint_id(self) -> EndpointId:
        return EndpointId(self.namespace, self.component, self.endpoint)

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "namespace": self.namespace,
                "component": self.component,
                "endpoint": self.endpoint,
                "instance_id": self.instance_id,
                "transport": self.transport,
            }
        ).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "Instance":
        d = json.loads(b)
        return cls(
            namespace=d["namespace"],
            component=d["component"],
            endpoint=d["endpoint"],
            instance_id=d["instance_id"],
            transport=d.get("transport", {}),
        )
