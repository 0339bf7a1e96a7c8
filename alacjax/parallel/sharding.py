"""Frame-axis sharding over a device mesh.

Encode/decode programs are per-frame-lane pure, so a 1-D ``frames`` mesh
axis scales them to N devices: each runs per shard under ``shard_map``
(codec.shard_frames).  The packet-table byte-count reduction (the one
real collective in the system, SURVEY.md §5) is a psum inside the
sharded round-trip step, outside the kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import AlacConfig
from .. import codec as _codec
from ..codec import FRAMES_AXIS


def frame_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices along the frames axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (FRAMES_AXIS,))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(FRAMES_AXIS))


class ShardedCodec(_codec.JaxCodec):
    """Batched codec whose frame batches shard across a device mesh.

    A thin subclass of :class:`alacjax.codec.JaxCodec` with the mesh
    pinned: it inherits the full pipelined host API (``encode_frames``,
    ``encode_frames_ex``, ``decode_frames``, ``decode_frames_ex``) with
    every compiled program sharded over the frames axis, and adds
    ``roundtrip_step`` — the encode→psum→decode 'training step' analog
    used by the multichip dryrun and the sharding tests.  Packet bytes
    are identical to the single-device codec (tested).
    """

    def __init__(self, config: AlacConfig, mesh: Mesh | None = None,
                 chunk: int = _codec.DEFAULT_CHUNK):
        mesh = mesh if mesh is not None else frame_mesh()
        super().__init__(config, chunk=chunk, mesh=mesh)
        S = config.frame_length

        shard = frame_sharding(self.mesh)
        repl = NamedSharding(self.mesh, P())

        def train_step(pcm):
            """Full round-trip step on one shard: encode -> decode, with
            the byte total and the mismatch count summed over the frames
            axis (the 'training step' analog for the codec).  Returns
            the encoded words/bits too so callers can assert byte-parity
            against the host implementations without a second program.
            """
            words, bits = _codec.encode_frames_device(
                pcm, config=config, num_words=self.num_words)
            decoded, err, _num = _codec.decode_frames_device(
                words, config=config, num_samples=S)
            total_bytes = jax.lax.psum(jnp.sum((bits + 7) // 8),
                                       FRAMES_AXIS)
            mismatch = jax.lax.psum(
                jnp.sum((decoded != pcm.astype(jnp.int32))
                        .astype(jnp.int32)), FRAMES_AXIS)
            return decoded, words, bits, total_bytes, mismatch, err

        frames = P(FRAMES_AXIS)
        self._roundtrip = jax.jit(
            _codec.shard_frames(
                train_step, self.mesh,
                out_specs=(frames, frames, frames, P(), P(), frames)),
            in_shardings=(shard,),
            out_shardings=(shard, shard, shard, repl, repl, shard),
        )

    def roundtrip_step(self, pcm_block):
        """One full sharded encode+decode step (for dryrun/bench)."""
        return self._roundtrip(pcm_block)
