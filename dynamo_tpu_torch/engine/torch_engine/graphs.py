"""CUDA graphs of the runner's step programs: the decode step, the decode
horizon and the verify pass, each captured once per shape and replayed per
dispatch.

The port's counterpart of the reference's ``jax.jit`` over these programs
(dynamo_tpu/engine/jax_engine/model_runner.py: ``_decode_fn``,
``_decode_multi_fn``, ``_spec_verify_jit``). PyTorch runs eagerly, so a
step of 32 layers is ~1000 kernel launches issued from Python; a replayed
graph issues them from the driver in one call. A dispatch then costs:

  1. one host-to-device copy of the packed inputs (every input of the step
     lies in one pinned host buffer, ``StepInputs``) into the graph's
     static device buffer;
  2. ``replay()``;
  3. one device-to-host copy of the packed output into a pinned buffer.

A graph is keyed by what the captured program depends on besides its
inputs' values: the kind (``decode``, ``decode_multi`` H, ``verify`` (S,
E)), the cache form, fused heads on or off, penalties, the EOS mask, whether
every lane is greedy, and the inputs' shapes (``max_batch`` lanes and
``max_model_len``-wide tables and histories, as the engine sends them). All
graphs share one memory pool. A capture runs the program once on inert
inputs first (every lane inactive: every K/V write goes to the null slot 0)
on a side stream, then captures it on that stream; neither run counts as a
kernel launch. Each capture records the kernel launches its program makes
(``ops/kernels.py`` counts in the Python wrappers, which a replay does not
call), and each replay adds them to the wrappers' counts, so a launch count
stays "one per kernel the path ran".

What a replay reads must not move: the runner's parameters and KV cache
stay where they are, the split-ticket buffer of the paged kernels is sized
before the first capture and never freed, and every input comes from the
static buffer. A capture or replay that fails raises; nothing runs the
eager path in its place. The caller (model_runner.TorchModelRunner) decides
whether graphs are used: on a CUDA device without a tensor-parallel group,
unless turned off.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

# inputs: name -> (dtype, shape)
Fields = dict[str, tuple[torch.dtype, tuple[int, ...]]]
_ALIGN = 64


class StepInputs:
    """Every input of one step program in one byte buffer: typed numpy views
    of a (pinned) host buffer to fill, typed tensor views of its device copy
    for the program. On the CPU the two are the same buffer."""

    def __init__(self, fields: Fields, device: torch.device) -> None:
        offsets, off = {}, 0
        for name, (dtype, shape) in fields.items():
            n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            offsets[name] = (off, n)
            off += -(-n // _ALIGN) * _ALIGN
        self.nbytes = max(off, _ALIGN)
        on_card = device.type == "cuda"
        self.host = torch.zeros(self.nbytes, dtype=torch.uint8, pin_memory=on_card)
        self.dev = torch.zeros(self.nbytes, dtype=torch.uint8, device=device) if on_card else self.host
        self.fields = fields
        self.host_views: dict[str, np.ndarray] = {}
        self.views: dict[str, torch.Tensor] = {}
        for name, (dtype, shape) in fields.items():
            o, n = offsets[name]
            self.host_views[name] = self.host[o:o + n].view(dtype).view(shape).numpy()
            self.views[name] = self.dev[o:o + n].view(dtype).view(shape)
        # the last upload, which must finish before the host buffer is refilled
        self._uploaded = torch.cuda.Event() if on_card else None

    def fill(self, arrays: dict) -> None:
        if self._uploaded is not None:
            self._uploaded.synchronize()
        for name, view in self.host_views.items():
            view[...] = arrays[name]

    def upload(self) -> None:
        """One host-to-device copy of the whole buffer (none on the CPU)."""
        if self._uploaded is not None:
            self.dev.copy_(self.host, non_blocking=True)
            self._uploaded.record()


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor  # the program's static output on the card
    host_out: torch.Tensor  # pinned
    done: "torch.cuda.Event"
    launches: dict[str, int]  # kernel launches one replay makes
    capture_s: float
    replays: int = 0


class StepGraphs:
    """One runner's captured step programs (see the module docstring)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._graphs: dict[tuple, _Graph] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.replays = 0
        self.captures = 0

    def __contains__(self, key: tuple) -> bool:
        return key in self._graphs

    def stats(self) -> dict[str, dict]:
        """Per graph key ("/"-joined): the seconds its capture took (its
        inert run included), its replays and the kernel launches one replay
        makes."""
        return {"/".join(map(str, k)): {"capture_s": g.capture_s, "replays": g.replays,
                                        "launches": dict(g.launches)}
                for k, g in self._graphs.items()}

    def capture(self, key: tuple, inputs: StepInputs, inert: dict,
                body: Callable[[dict], torch.Tensor]) -> None:
        """Run ``body`` once on ``inert`` inputs, then capture it reading
        ``inputs``' static device views. Its output tensor becomes the
        graph's static output."""
        from dynamo_tpu_torch.ops import kernels

        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        before = kernels.launch_counts()
        inputs.fill(inert)
        inputs.upload()
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            body(inputs.views)
        main.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        ran = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture, in any thread: a cycle
        # it frees may hold CUDA events or graphs, whose destruction is a
        # CUDA call the capture does not allow (the capture is invalidated)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                out = body(inputs.views)
        finally:
            if collecting:
                gc.enable()
        captured = kernels.launch_counts()
        # neither the inert run nor the capture is a run of the caller's path
        for name, fn in kernels.KERNELS.items():
            fn.launches = before[name]
        self._graphs[key] = _Graph(
            graph=graph, out=out,
            host_out=torch.empty(out.shape, dtype=out.dtype, pin_memory=True),
            done=torch.cuda.Event(),
            launches={k: captured[k] - ran[k] for k in captured if captured[k] != ran[k]},
            capture_s=time.perf_counter() - t0,
        )
        self.captures += 1

    def launch(self, key: tuple, inputs: StepInputs, arrays: Optional[dict] = None) -> None:
        """Fill (unless ``arrays`` is None: the inputs as they are) and
        upload the inputs, and replay, without waiting for the card."""
        from dynamo_tpu_torch.ops import kernels

        g = self._graphs[key]
        if arrays is not None:
            inputs.fill(arrays)
        inputs.upload()
        g.graph.replay()
        self.replays += 1
        g.replays += 1
        for name, n in g.launches.items():
            kernels.KERNELS[name].launches += n

    def replay(self, key: tuple, inputs: StepInputs, arrays: dict) -> torch.Tensor:
        """``launch``, then bring the output back: a CPU tensor of its own."""
        self.launch(key, inputs, arrays)
        g = self._graphs[key]
        g.host_out.copy_(g.out, non_blocking=True)
        g.done.record()
        g.done.synchronize()
        return g.host_out.clone()
