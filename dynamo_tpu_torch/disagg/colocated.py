"""Prefill clients for a prefill engine in this process: the port's twin of
dynamo_tpu/disagg/colocated.py, and an in-process client of the host
payload path.

``ColocatedPrefillClient`` is the device-native data plane: the prefill
engine (``TorchEngine.prefill_only_device``) gathers the shipped blocks into
tensors on its card and the decode engine scatters them into its own cache
(``inject_blocks_device``), with no host copy and no serialization: the
role of the reference's NIXL GPUDirect transfer. On one card the move is
two on-card copies; across cards it is a peer copy.

Unlike the reference's, this client's ``prefill`` takes every keyword the
decode engine's remote-prefill task passes (``stream``, ``on_frame``,
``deadline``, ``ctx``, ``extra``). The reference's accepts none of them,
so there every colocated prefill raises ``TypeError``, the decode engine
catches it and prefills locally: its device path never runs. The device
payload is whole, so this client never streams.

``HostPrefillClient`` serves the host payload path in-process: the prefill
engine's ``prefill_only`` (or, when the decode engine asks to stream, as it does
unless ``DYN_KV_STREAM=0``, ``prefill_only_stream``) encodes the blocks, and every frame and the
final response go through ``to_wire()`` / ``from_wire()`` before they
land, as they would cross a transport. Across processes the same roles
run over the fabric (transfer.py: ``RemotePrefillClient``,
``PrefillWorkerService`` and the prefill queue).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Any, Optional

from dynamo_tpu_torch.disagg.protocols import (
    KvStreamFrame,
    PrefillStreamCancelled,
    RemotePrefillRequest,
    RemotePrefillResponse,
)


@dataclass
class DevicePrefillResponse:
    """A prefill's result whose KV lies in tensors on the prefill engine's
    device: ``k_dev`` / ``v_dev`` [L, Hkv, num_blocks, bs, D] in the
    cache's logical dtype."""

    request_id: str
    first_token: int
    k_dev: Any = None
    v_dev: Any = None
    num_blocks: int = 0
    first_block: int = 0
    error: Optional[str] = None
    code: Optional[str] = None
    first_logprob: Optional[float] = None
    first_top: Optional[list] = None
    streamed_blocks: int = 0
    # payload=None keeps this duck-compatible with RemotePrefillResponse
    payload: None = None


def _request(token_ids, block_size, *, temperature, top_p, top_k, cached_blocks, rep_pen,
             key_data, eos_ids, eos_suppress, stream, deadline, extra) -> RemotePrefillRequest:
    return RemotePrefillRequest(
        request_id=uuid.uuid4().hex, token_ids=list(token_ids), reply_subject="(in-process)",
        temperature=temperature, top_p=top_p, top_k=top_k, cached_blocks=cached_blocks,
        block_size=block_size, rep_pen=rep_pen,
        key_data=[int(x) for x in key_data] if key_data is not None else None,
        eos_ids=[int(x) for x in eos_ids] if eos_ids is not None else None,
        eos_suppress=bool(eos_suppress), stream=stream, deadline=deadline,
        extra=dict(extra or {}),
    )


class ColocatedPrefillClient:
    """The decode engine's ``remote_prefill_client`` for a prefill engine in
    this process, over the device path (see the module docstring)."""

    def __init__(self, prefill_engine: Any, block_size: int = 16) -> None:
        self.engine = prefill_engine
        self.block_size = block_size

    async def start(self) -> None:
        return None

    async def close(self) -> None:
        return None

    async def prefill(
        self, token_ids: list[int], *, temperature: float = 0.0, top_p: float = 1.0,
        top_k: int = 0, cached_blocks: int = 0, rep_pen: float = 1.0, key_data=None,
        eos_ids=None, eos_suppress: bool = False, stream: bool = False, on_frame=None,
        deadline: Optional[float] = None, ctx: Any = None, extra: Optional[dict] = None,
    ) -> DevicePrefillResponse:
        """One prompt prefilled on the prefill engine, its blocks left on
        the device. ``stream`` / ``on_frame`` are accepted and not used:
        the device payload is whole; ``ctx`` is not watched (the decode
        engine checks it when this returns)."""
        req = _request(token_ids, self.block_size, temperature=temperature, top_p=top_p,
                       top_k=top_k, cached_blocks=cached_blocks, rep_pen=rep_pen,
                       key_data=key_data, eos_ids=eos_ids, eos_suppress=eos_suppress,
                       stream=False, deadline=deadline, extra=extra)
        return await self.engine.prefill_only_device(req)


class HostPrefillClient:
    """The decode engine's ``remote_prefill_client`` over the host payload
    path of a prefill engine in this process (see the module docstring)."""

    def __init__(self, prefill_engine: Any, block_size: int = 16) -> None:
        self.engine = prefill_engine
        self.block_size = block_size

    async def start(self) -> None:
        return None

    async def close(self) -> None:
        return None

    async def prefill(
        self, token_ids: list[int], *, temperature: float = 0.0, top_p: float = 1.0,
        top_k: int = 0, cached_blocks: int = 0, rep_pen: float = 1.0, key_data=None,
        eos_ids=None, eos_suppress: bool = False, stream: bool = False, on_frame=None,
        deadline: Optional[float] = None, ctx: Any = None, extra: Optional[dict] = None,
    ) -> RemotePrefillResponse:
        """One prompt prefilled on the prefill engine. Streamed: each frame
        goes through its wire dict into ``on_frame`` while later chunks
        compute, and a ``ctx`` killed between chunks aborts the stream
        (``PrefillStreamCancelled``)."""
        streamed = bool(stream and on_frame is not None)
        req = _request(token_ids, self.block_size, temperature=temperature, top_p=top_p,
                       top_k=top_k, cached_blocks=cached_blocks, rep_pen=rep_pen,
                       key_data=key_data, eos_ids=eos_ids, eos_suppress=eos_suppress,
                       stream=streamed, deadline=deadline, extra=extra)
        if not streamed:
            resp = await self.engine.prefill_only(req)
        else:
            async def emit(frame: KvStreamFrame) -> None:
                await on_frame(KvStreamFrame.from_wire(frame.to_wire()))

            cancelled = ctx.is_killed if ctx is not None else None
            resp = await self.engine.prefill_only_stream(req, emit, cancelled=cancelled)
            if resp is None:
                raise PrefillStreamCancelled(f"request {req.request_id} cancelled mid-stream")
        return RemotePrefillResponse.from_wire(resp.to_wire())
