"""Disaggregated prefill/decode in the port (dynamo_tpu/disagg/): the KV
payload codec and wire types (protocols.py), the local-or-remote decision
with live thresholds (router.py), the prefill work queue on the fabric
(prefill_queue.py), the fabric transport between decode and prefill
workers (transfer.py: ``RemotePrefillClient``, ``PrefillWorkerService``) and
the in-process prefill clients (colocated.py). The block gather / scatter
lives on the runner (``TorchModelRunner.extract_blocks*`` /
``inject_blocks*``, under a tensor-parallel group through the step
channel) and the two roles on the engine (``TorchEngine``'s
``remote_prefill_client`` and ``prefill_only*``)."""

from dynamo_tpu_torch.disagg.prefill_queue import PrefillQueue
from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest, RemotePrefillResponse
from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter

__all__ = [
    "RemotePrefillRequest",
    "RemotePrefillResponse",
    "PrefillQueue",
    "DisaggregatedRouter",
    "DisaggConfig",
]
