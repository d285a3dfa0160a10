"""Tensor parallelism for the port: the rank group, Megatron sharding, the
rank processes and the leader / follower step protocol."""
