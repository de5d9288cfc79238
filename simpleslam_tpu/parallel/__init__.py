"""Multi-device sharding: mesh helpers, sharded registration, distributed BA.

No reference counterpart (the C++ system is single-process; SURVEY.md §2.3):
this layer is the framework's own scaling story — point-parallel registration
and edge-sharded pose-graph solves over ``jax.sharding.Mesh`` with XLA
collectives inside ``shard_map``.
"""
