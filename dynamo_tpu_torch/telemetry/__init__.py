"""Distributed request telemetry: spans across the port's processes.

The port's own copy of the JAX package's ``telemetry`` tracing plane: every
hop of a request — HTTP ingress, router decision, worker dispatch,
disaggregated prefill stream, migration replay — records lightweight spans
into a bounded per-process ring buffer, stitched back together at the
frontend into one trace per request (``/debug/traces/{request_id}``, Chrome
trace-event JSON, and a timing breakdown on the final SSE ``usage`` block).

Off by default (``DYN_TRACE=0``): every instrumentation point first checks a
module flag and returns a shared no-op object, so the disabled fast path
allocates nothing and costs one attribute load and a branch.
"""
