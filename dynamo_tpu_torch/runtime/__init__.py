"""Core runtime of the port: process lifecycle, distributed fabric handle,
component model (the port's own copy of dynamo_tpu/runtime/). Import from
the submodules (``runtime.distributed``, ``runtime.component``, ...): this
package imports none of them, so ``pipeline.context`` can read the clock
without pulling in the component model."""
