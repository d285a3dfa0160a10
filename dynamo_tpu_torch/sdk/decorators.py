"""@service / depends() — the serve-graph declaration surface.

The port's own copy of dynamo_tpu/sdk/decorators.py.

Role-equivalent of the reference SDK's decorators
(deploy/sdk/src/dynamo/sdk/core/decorators (@service) and lib.py
(depends())): a graph module defines decorated classes; `depends` edges
order startup and document the topology. Services here are plain classes
with one contract: ``async def serve(self, runtime)`` runs forever inside
its own process with a fabric-connected DistributedRuntime.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Optional, Union


@dataclass
class Depends:
    """Marker for a dependency edge; resolves by service name."""

    target: Union[str, type]

    @property
    def name(self) -> str:
        if isinstance(self.target, str):
            return self.target
        spec = getattr(self.target, "__dyn_service__", None)
        return spec.name if spec else self.target.__name__


def depends(target: Union[str, type]) -> Depends:
    return Depends(target)


@dataclass
class ServiceSpec:
    name: str
    cls: type = None  # type: ignore[assignment]
    module: str = ""
    replicas: int = 1
    env: dict[str, str] = field(default_factory=dict)
    deps: list[str] = field(default_factory=list)

    @property
    def target(self) -> str:
        """module:ClassName handle for the child-process runner."""
        return f"{self.module}:{self.cls.__name__}"


def service(
    name: Optional[str] = None,
    *,
    replicas: int = 1,
    env: Optional[dict[str, str]] = None,
):
    """Class decorator registering a service in its module's graph."""

    def wrap(cls: type) -> type:
        deps = [
            v.name for v in vars(cls).values() if isinstance(v, Depends)
        ]
        cls.__dyn_service__ = ServiceSpec(
            name=name or cls.__name__,
            cls=cls,
            module=cls.__module__,
            replicas=replicas,
            env=dict(env or {}),
            deps=deps,
        )
        return cls

    return wrap


def load_graph(module_path: str) -> list[ServiceSpec]:
    """Import a graph module and return its services in dependency order
    (dependencies first), so `dynamo_tpu_torch.serve` starts workers before the
    frontends that route to them."""
    mod = importlib.import_module(module_path)
    specs = [
        v.__dyn_service__
        for v in vars(mod).values()
        if isinstance(v, type)
        and getattr(v, "__dyn_service__", None) is not None
        and v.__module__ == mod.__name__
    ]
    by_name = {s.name: s for s in specs}
    ordered: list[ServiceSpec] = []
    visiting: set[str] = set()

    def visit(s: ServiceSpec) -> None:
        if s in ordered:
            return
        if s.name in visiting:
            raise ValueError(f"dependency cycle through {s.name!r}")
        visiting.add(s.name)
        for d in s.deps:
            if d in by_name:
                visit(by_name[d])
        visiting.discard(s.name)
        ordered.append(s)

    for s in specs:
        visit(s)
    if not ordered:
        raise ValueError(f"no @service classes found in {module_path!r}")
    return ordered
