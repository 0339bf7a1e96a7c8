"""Multi-chip scaling — frame-sharded SPMD over a jax.sharding.Mesh.

The honest parallelism mapping for this workload (SURVEY.md §2 & §5): the
codec is embarrassingly parallel over frames; data parallelism = frames
sharded across chips, zero steady-state cross-chip collectives, with one
optional psum for the packet-table byte statistics.  Inventing inter-chip
traffic here would be cargo cult — the interconnect carries only the
input scatter and the bitstream gather.
"""

from .sharding import ShardedCodec, frame_mesh, frame_sharding

__all__ = ["ShardedCodec", "frame_mesh", "frame_sharding"]
