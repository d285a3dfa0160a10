"""Serve-graph SDK: declare a deployment as decorated service classes,
launch it supervised from one command.

The port's own copy of dynamo_tpu/sdk/.

Role-equivalent of the reference's deploy/sdk (`@service` + `depends()` +
`dynamo serve`, deploy/sdk/src/dynamo/sdk/cli/serving.py:152) — rebuilt as
a dependency-light asyncio process supervisor instead of a bentoml/circus
stack: each service runs in its own OS process wired to the fabric, crashes
restart with backoff, and the whole graph tears down on SIGINT/SIGTERM.
"""

from dynamo_tpu_torch.sdk.decorators import (
    Depends,
    ServiceSpec,
    depends,
    load_graph,
    service,
)
from dynamo_tpu_torch.sdk.supervisor import ManagedProcess, Supervisor

__all__ = [
    "Depends",
    "ManagedProcess",
    "ServiceSpec",
    "Supervisor",
    "depends",
    "load_graph",
    "service",
]
