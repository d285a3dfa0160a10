"""Multi-node bring-up: the node's place in the engine's rank grid and the
fabric rendezvous that hands every node the grid's address.

Counterpart of the bring-up half of dynamo_tpu/parallel/multihost.py
(``MultiNodeConfig`` :63, ``rendezvous_and_initialize`` :102), kept free of
torch so that a frontend or a supervisor may read the config without
importing it. Each node is one rank process of the grid: node ``node_rank``
is global rank ``node_rank``, and the grid's sizes multiply to
``num_nodes`` (engine/torch_engine/factory.py). The rendezvous rides the
fabric's ``LeaderBarrier`` / ``WorkerBarrier`` (runtime/barrier.py) under
the reference's barrier id: the leader publishes the ``torch.distributed``
address (``host:port``) where the reference publishes its JAX coordinator,
under its own lease, and every other node reads it and checks in. Without a
fabric, ``leader_addr`` names the address on every node (static mode). The
process group itself is made by the caller from the returned
``tcp://host:port`` (parallel/mesh.TPGroup), which the reference's
``jax.distributed.initialize`` does inside the function.

The leader's host is the address of its own connection to the fabric
server (``FabricClient.local_host``), which the other nodes reach the
fabric by as well; nothing is sent to find it.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Optional

BARRIER_ID = "engine-bringup"


@dataclass
class MultiNodeConfig:
    """The reference's MultiNodeConfig (multihost.py:63): ``num_nodes``
    rank processes, this one ``node_rank``, the grid's address
    ``leader_addr`` (``host:port``) in static mode."""

    num_nodes: int = 1
    node_rank: int = 0
    leader_addr: Optional[str] = None

    @classmethod
    def from_env(cls) -> "MultiNodeConfig":
        """``DYN_NUM_NODES`` (1), ``DYN_NODE_RANK`` (0) and
        ``DYN_LEADER_ADDR`` (unset), as the reference reads them."""
        return cls(
            num_nodes=int(os.environ.get("DYN_NUM_NODES", "1")),
            node_rank=int(os.environ.get("DYN_NODE_RANK", "0")),
            leader_addr=os.environ.get("DYN_LEADER_ADDR") or None,
        )

    @property
    def is_leader(self) -> bool:
        return self.node_rank == 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def rendezvous_and_initialize(
    cfg: MultiNodeConfig,
    fabric: Optional[Any] = None,
    lease_id: int = 0,
    *,
    barrier_id: str = BARRIER_ID,
    timeout: float = 120.0,
) -> Optional[str]:
    """Bring this node into the grid: returns the ``torch.distributed``
    init address ``tcp://host:port`` every node joins (None for one node).

    Leader: pick the address (``leader_addr``, else its fabric connection's
    host and a free port), publish it through the fabric barrier under
    ``lease_id`` and wait for every other node to check in. Other nodes:
    read it, check in under their own lease. Without a fabric,
    ``leader_addr`` must be set on every node (static mode); raises
    ValueError otherwise."""
    if cfg.num_nodes <= 1:
        return None
    if fabric is None:
        return static_init_method(cfg)
    from dynamo_tpu_torch.runtime.barrier import LeaderBarrier, WorkerBarrier

    if cfg.is_leader:
        addr = cfg.leader_addr or f"{fabric.local_host}:{_free_port()}"
        barrier = LeaderBarrier(barrier_id, cfg.num_nodes - 1, timeout=timeout)
        await barrier.sync(fabric, lease_id, {"coordinator": addr})
    else:
        barrier = WorkerBarrier(barrier_id, f"node-{cfg.node_rank}", timeout=timeout)
        addr = (await barrier.sync(fabric, lease_id))["coordinator"]
    return f"tcp://{addr}"


def static_init_method(cfg: MultiNodeConfig) -> str:
    """The init address of static mode (no fabric): ``tcp://<leader_addr>``;
    raises ValueError when ``leader_addr`` is unset."""
    if not cfg.leader_addr:
        raise ValueError(
            "multi-node bring-up needs a leader_addr (DYN_LEADER_ADDR) or a fabric for "
            "rendezvous"
        )
    return f"tcp://{cfg.leader_addr}"
