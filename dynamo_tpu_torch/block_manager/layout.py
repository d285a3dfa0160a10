"""KV block tensor layouts.

The port's own copy of dynamo_tpu/block_manager/layout.py: how a tier
arranges block data in memory, and the conversion between the two
arrangements. The engine's device cache is FULLY_CONTIGUOUS, head-major
``[L, H, nb, bs, D]``; LAYER_SEPARATE (``L x [H, nb, bs, D]``) suits engines
that stream layer by layer.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class LayoutKind(str, enum.Enum):
    FULLY_CONTIGUOUS = "fully_contiguous"
    LAYER_SEPARATE = "layer_separate"


@dataclass(frozen=True)
class LayoutConfig:
    num_layers: int
    page_size: int  # tokens per block (block_size)
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"
    kind: LayoutKind = LayoutKind.FULLY_CONTIGUOUS

    @property
    def block_shape(self) -> tuple[int, ...]:
        """Shape of ONE block's K (or V) across all layers."""
        return (
            self.num_layers,
            self.num_kv_heads,
            self.page_size,
            self.head_dim,
        )

    @property
    def block_numel(self) -> int:
        return int(np.prod(self.block_shape))

    @property
    def itemsize(self) -> int:
        return 2 if self.dtype in ("bfloat16", "float16") else 4

    @property
    def block_nbytes(self) -> int:
        """K+V bytes for one block."""
        return 2 * self.block_numel * self.itemsize

    def arena_shape(self, num_blocks: int) -> tuple[int, ...]:
        """Shape of a tier arena holding num_blocks blocks (K or V)."""
        if self.kind is LayoutKind.FULLY_CONTIGUOUS:
            return (
                self.num_layers,
                self.num_kv_heads,
                num_blocks,
                self.page_size,
                self.head_dim,
            )
        return (
            num_blocks,
            self.num_layers,
            self.num_kv_heads,
            self.page_size,
            self.head_dim,
        )


def to_blocks_first(arr: np.ndarray, kind: LayoutKind) -> np.ndarray:
    """View/transpose an arena slice as [n, L, H, bs, D] (blocks leading)."""
    if kind is LayoutKind.FULLY_CONTIGUOUS:
        return np.moveaxis(arr, 2, 0)
    return arr


def to_layers_first(arr: np.ndarray, kind: LayoutKind) -> np.ndarray:
    """View/transpose blocks-first data into the arena's own arrangement."""
    if kind is LayoutKind.FULLY_CONTIGUOUS:
        return np.moveaxis(arr, 0, 2)
    return arr
