"""Disaggregated prefill/decode in the port (dynamo_tpu/disagg/): the KV
payload codec and wire types (protocols.py), the local-or-remote decision
(router.py) and the in-process prefill clients (colocated.py). The block
gather / scatter lives on the runner (``TorchModelRunner.extract_blocks*`` /
``inject_blocks*``) and the two roles on the engine (``TorchEngine``'s
``remote_prefill_client`` and ``prefill_only*``)."""
