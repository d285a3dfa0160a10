"""Multi-tier KV-cache block management (the KVBM role).

The port's own copy of dynamo_tpu/block_manager/: a tiered pool of KV blocks
addressed by sequence hash --

    G1  device memory -- the engine's paged cache, in the runner; blocks
                         move in and out through its extract / inject
    G2  host RAM      -- one arena tensor per K and V, pinned on a card
    G3  local disk    -- one file per block under a spill directory
    G4  a peer        -- another worker's G2 / G3, pulled over the fabric
                         (peer.py, G4-lite)

Offload flows G1 -> G2 mid-generation as blocks become KV-complete (the
bounded ``OffloadQueue`` the engine loop drains), at preemption and at a
sequence's end; G2 -> G3 under host pressure. Onboarding walks back on
prefix hits, also into requests whose prefix is still live on another
running sequence; a prefix missing here may be pulled from a peer's tier
first.
"""

from dynamo_tpu_torch.block_manager.block import Block, BlockState
from dynamo_tpu_torch.block_manager.layout import LayoutConfig, LayoutKind
from dynamo_tpu_torch.block_manager.manager import TieredBlockManager
from dynamo_tpu_torch.block_manager.offload import OffloadQueue
from dynamo_tpu_torch.block_manager.peer import PULL_OUTCOMES, PeerBlockClient, PeerBlockService

__all__ = [
    "Block",
    "BlockState",
    "LayoutConfig",
    "LayoutKind",
    "OffloadQueue",
    "PULL_OUTCOMES",
    "PeerBlockClient",
    "PeerBlockService",
    "TieredBlockManager",
]
