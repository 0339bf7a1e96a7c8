"""Stacked multichannel decode (cursor pass + one fused scan) parity.

The two-pass decode — a cheap Rice-cursor scan per channel breaks the
cross-channel chain, then ONE stacked fused scan reconstructs every
channel (codec._stacked_decode, fused_decode.cursor_scan) — is parked
OPT-IN (ALACJAX_DECODE_STACKED=1): it lost to the chained scans at
every layout before the GPU port (see _stacked_decode's docstring).
Kept bit-identical and tested: both programs must produce identical samples/err/num on every content class
— including escape lanes (cursor skip) and partial tails (num mask).
The reference decodes channels strictly serially
(codec/ALACDecoder.cpp :: Decode element loop).
"""

import os

import numpy as np
import pytest

from alacjax.types import AlacConfig
from conftest import gen_pcm

pytestmark = pytest.mark.slow  # device-compile-heavy


def _roundtrip_both(rng, nch, depth, with_partial=True):
    import jax.numpy as jnp

    from alacjax import codec as C

    S = 256
    B = 6
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    lim = 1 << (depth - 1)
    pcm = np.stack([gen_pcm(rng, "sine", nch, S, depth) for _ in range(B)])
    # one all-noise lane: escape elements (the cursor must skip them)
    pcm[B - 1] = rng.integers(-lim, lim, (nch, S),
                              dtype=np.int64).astype(np.int32)
    nums = np.full(B, S, np.int32)
    if with_partial:
        nums[2] = 100
        pcm[2, :, 100:] = 0
    nw = (cfg.max_escape_packet_bytes(S) + 3) // 4 + 2
    w, _, _ = C._encode_packet_chunks(jnp.asarray(pcm), cfg, nw,
                                      nums=jnp.asarray(nums))
    outs = {}
    for mode in ("0", "1"):
        os.environ["ALACJAX_DECODE_STACKED"] = mode
        try:
            dec, err, num = C.decode_frames_device(w, cfg, S)
        finally:
            os.environ.pop("ALACJAX_DECODE_STACKED", None)
        outs[mode] = (np.asarray(dec), np.asarray(err), np.asarray(num))
    return pcm, outs["0"], outs["1"]


@pytest.mark.parametrize("nch,depth", [(3, 16), (6, 16), (6, 24), (8, 32)])
def test_stacked_matches_chained_and_lossless(rng, nch, depth):
    pcm, (d0, e0, n0), (d1, e1, n1) = _roundtrip_both(rng, nch, depth)
    np.testing.assert_array_equal(n0, n1)
    np.testing.assert_array_equal(e0, e1)
    assert not e0.any()
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(d0, pcm)


def test_stacked_forced_stereo_matches(rng):
    """ALACJAX_DECODE_STACKED=1 forces the 2-scan stereo case through
    the stacked program (the A/B knob) — still byte-identical."""
    pcm, (d0, e0, _), (d1, e1, _) = _roundtrip_both(rng, 2, 16)
    np.testing.assert_array_equal(e0, e1)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(d0, pcm)


def test_cursor_scan_end_positions_match_oracle(rng):
    """cursor_scan's end bit positions equal the oracle dyn_comp's
    emitted bit counts (and the fused raw decode's) for the same
    stream — identical _rice_substep trajectory, no reconstruction."""
    import jax.numpy as jnp

    from alacjax.bitbuffer import BitBuffer
    from alacjax.oracle import ag as oag
    from alacjax.ops import bitpack, fused_decode

    S = 200
    B = 4
    chanbits = 16
    res = rng.integers(-120, 120, (B, S)).astype(np.int32)
    res[1, 50:150] = 0  # zero runs
    oracle_bytes, oracle_bits = [], []
    for b in range(B):
        bb = BitBuffer(byte_size=4096)
        nb = oag.dyn_comp(oag.set_standard_ag_params(S, S), bb, res[b], S,
                          chanbits)
        oracle_bytes.append(bb.to_bytes())
        oracle_bits.append(nb)
    W = max(len(p) for p in oracle_bytes) // 4 + 3
    words = jnp.asarray(bitpack.bytes_to_words(oracle_bytes, W))
    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    mb0, pb, kb, wb = cfg.mb, cfg.pb, cfg.kb, (1 << cfg.kb) - 1
    starts = jnp.zeros((B,), jnp.int32)
    pbv = jnp.full((B,), pb, jnp.int32)
    end_c, err_c = fused_decode.cursor_scan(
        words, starts, S, chanbits, mb0, pbv, kb, wb)
    assert not np.asarray(err_c).any()
    np.testing.assert_array_equal(np.asarray(end_c), oracle_bits)
    # and a skipped lane's cursor must not move
    skip = jnp.asarray([False, True, False, False])
    end_s, _ = fused_decode.cursor_scan(
        words, starts, S, chanbits, mb0, pbv, kb, wb, skip=skip)
    assert int(np.asarray(end_s)[1]) == 0
    np.testing.assert_array_equal(np.asarray(end_s)[[0, 2, 3]],
                                  np.asarray(end_c)[[0, 2, 3]])
