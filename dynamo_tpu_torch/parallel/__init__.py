"""Parallelism for the port: the rank grid (dp x pp x sp x ep x tp),
sharding, the rank processes, the leader / follower step protocol,
multi-node bring-up, ring attention and the pipelined forward."""
