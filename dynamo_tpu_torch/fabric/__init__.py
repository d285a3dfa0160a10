"""The fabric: discovery + messaging control plane of the port.

The port's own copy of dynamo_tpu/fabric/. One subsystem plays the role
both of etcd (kv store with leases, CAS, prefix watches) and of NATS
(subject pub/sub with queue groups, work queues, object store).

Three deployment shapes, one client API (`FabricClient`):
  * in-process  — a process-local `FabricState`
  * remote      — TCP connection to a `FabricServer` (msgpack-framed by the
    stdlib codec in `mpack.py`, byte-identical to the JAX package's frames)
  * the server  — `python -m dynamo_tpu_torch.fabric.server --port 6650`
"""

from dynamo_tpu_torch.fabric.state import FabricState, WatchEvent, KVEntry  # noqa: F401
from dynamo_tpu_torch.fabric.client import FabricClient  # noqa: F401
from dynamo_tpu_torch.fabric.server import FabricServer  # noqa: F401
