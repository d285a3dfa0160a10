"""Deployable serve graphs: service topologies launched by
``python -m dynamo_tpu_torch.serve <module>``.

The port's own copies of dynamo_tpu/graphs/:

  * ``dynamo_tpu_torch.graphs.agg``         — frontend + N aggregated workers
  * ``dynamo_tpu_torch.graphs.hello_world`` — one echo worker + a frontend

Engine selection is env-driven (``DYN_GRAPH_ENGINE``): ``echo`` (protocol
level, the default), ``tiny-torch`` (a tiny Llama from seed 0 on
``DYN_DEVICE``, default ``cuda``), or ``torch`` with ``DYN_MODEL_PATH``
pointing at an HF dir. ``graphs/disagg.py`` waits for the fabric transport
of remote prefill (ROADMAP.md A8).
"""
