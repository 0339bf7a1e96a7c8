"""Escape-vs-compressed boundary conformance.

The escape decision (comp_bits >= esc_bits) is computed independently in
three implementations (oracle/encoder.py, codec.py, alac_host.cpp) with
a "headers cancel" argument.  These fixtures pin frames whose compressed
size lands AT the flip point: for each depth x {SCE, CPE}, a noise
amplitude is binary-searched until one amplitude step flips the
decision, then both sides of the flip are asserted byte-identical across
implementations.  A one-header off-by regression in any dialect moves
the flip point and fails the byte compare.

Reference: codec/ALACEncoder.cpp :: Encode{Stereo,Mono} escape branch.
"""

import numpy as np
import pytest

from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig

S = 256


def _gen(rng_seed, nch, depth, amp, S=S):
    """Deterministic noise frame at integer amplitude ``amp``."""
    rng = np.random.default_rng(rng_seed)
    lim = 1 << (depth - 1)
    x = rng.integers(-amp, amp + 1, (nch, S))
    return np.clip(x, -lim, lim - 1).astype(np.int64)


def _escaped(packet: bytes) -> bool:
    """Escape flag = bit 22 of the element header (LSB of the 23-bit
    header)."""
    hdr = (packet[0] << 16) | (packet[1] << 8) | packet[2]
    return bool((hdr >> 1) & 1)


def _find_flip(cfg, depth, seed=5):
    """Binary-search the smallest amplitude whose frame escapes."""
    lim = (1 << (depth - 1)) - 1

    def escapes(amp):
        enc = ALACEncoder(cfg, independent_frames=True)
        return _escaped(enc.encode_packet(_gen(seed, cfg.num_channels,
                                               depth, amp)))

    lo, hi = 1, lim
    if not escapes(hi):
        pytest.skip("full-scale noise does not escape at this config")
    while lo < hi:
        mid = (lo + hi) // 2
        if escapes(mid):
            hi = mid
        else:
            lo = mid + 1
    assert escapes(lo) and not escapes(lo - 1)
    return lo


@pytest.mark.parametrize("depth", [16, 20, 24, 32])
@pytest.mark.parametrize("nch", [1, 2])
def test_escape_flip_oracle_native(depth, nch):
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    flip = _find_flip(cfg, depth)
    native = pytest.importorskip("alacjax.native")
    if not native.available():
        pytest.skip(native.build_error() or "native unavailable")
    for amp in (flip - 1, flip):
        x = _gen(5, nch, depth, amp)
        p_o = ALACEncoder(cfg, independent_frames=True).encode_packet(x)
        p_n = native.NativeEncoder(cfg).encode_packet(x)
        assert p_o == p_n, f"depth={depth} nch={nch} amp={amp}"
        assert _escaped(p_o) == (amp == flip)


@pytest.mark.slow
@pytest.mark.parametrize("depth", [16, 20, 24, 32])
@pytest.mark.parametrize("nch", [1, 2])
def test_escape_flip_device(depth, nch):
    from alacjax.codec import JaxCodec

    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    flip = _find_flip(cfg, depth)
    x = np.stack([_gen(5, nch, depth, flip - 1), _gen(5, nch, depth, flip)])
    pkts = JaxCodec(cfg, chunk=2).encode_frames(x)
    for i, amp in enumerate((flip - 1, flip)):
        p_o = ALACEncoder(cfg, independent_frames=True).encode_packet(x[i])
        assert pkts[i] == p_o, f"depth={depth} nch={nch} amp={amp}"
        assert _escaped(pkts[i]) == (amp == flip)
