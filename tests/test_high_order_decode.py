"""Device-native decode of 17..30-tap predictor streams.

Our encoder (like the reference's) emits orders <= 8, but the 5-bit
order field admits up to 30 taps (31 is the first-difference special
mode) and the reference decoder accepts them all — its coef buffers are
32 wide (codec/ALACDecoder.cpp).  A complete decoder must eat every
legal stream at device speed, so the codec
carries a lazy taps=30 program; these tests synthesize legal packets
with FORCED high orders and assert the device programs (not the oracle
fallback) reproduce the oracle decoder exactly.
"""

import jax
import numpy as np
import pytest

from alacjax.bitbuffer import BitBuffer
from alacjax.codec import JaxCodec, decode_frames_jit
from alacjax.oracle import ALACDecoder, ag, dp, matrix
from alacjax.oracle.encoder import (
    DEFAULT_MIX_BITS, PB_FACTOR, _rice_params, _write_channel_params,
    _write_element_header,
)
from alacjax.ops import bitpack
from alacjax.types import DENSHIFT_DEFAULT, AlacConfig, ElementTag
from conftest import gen_pcm

pytestmark = pytest.mark.slow  # device-compile-heavy (fast tier: -m "not slow")

S = 256


def build_packet(cfg, pcm, orders, modes, mixres=2, denshifts=None,
                 pbfs=None, mixbits=DEFAULT_MIX_BITS, bytes_shifted=0,
                 buf_bytes=None):
    """Assemble a legal packet with forced per-channel predictor orders
    (bitstream grammar per docs/BITSTREAM.md; reference:
    ALACEncoder.cpp element layout, with the search replaced by the
    given fixed parameters).

    The optional knobs open the rest of the wire grammar for the
    differential fuzz (tests/test_grammar_fuzz.py): per-channel
    denshift/pb-factor, per-element mixbits/mixres, and a forced
    bytesShifted (the reference decoder reads all of these blind from
    the header — ALACDecoder.cpp channel-parameter parse)."""
    if buf_bytes is None:
        # forced weak predictors on hostile content can exceed the
        # escape bound our real encoder never crosses; size generously
        buf_bytes = 4 * cfg.max_escape_packet_bytes(cfg.frame_length) + 256
    bits = BitBuffer(byte_size=buf_bytes)
    num = pcm.shape[1]          # num < frame_length -> partial (tail) frame
    partial = num < cfg.frame_length
    nch = cfg.num_channels
    denshifts = ([DENSHIFT_DEFAULT] * nch if denshifts is None
                 else list(denshifts))
    pbfs = [PB_FACTOR] * nch if pbfs is None else list(pbfs)
    bs = bytes_shifted
    ch = 0
    tag_counters = {}
    for tag, width in cfg.elements:
        instance = tag_counters.get(int(tag), 0)
        tag_counters[int(tag)] = instance + 1
        _write_element_header(bits, tag, instance, partial, bs, False, num)
        his, los = [], []
        for i in range(width):
            hi, lo = matrix.shift_off(pcm[ch + i].astype(np.int64), bs)
            his.append(hi)
            los.append(lo)
        if width == 2:
            chanbits = cfg.bit_depth - 8 * bs + 1
            bits.write(mixbits, 8)
            bits.write(mixres & 0xFF, 8)
            u, v = matrix.mix(his[0], his[1], mixbits, mixres)
            # Encodable-domain invariant: dyn_comp's escape writes exactly
            # chanbits bits, so every residual must fit chanbits.  pc_block
            # wraps all outputs EXCEPT the first-sample / order-0
            # passthroughs (reference semantics), so the INPUT streams must
            # already fit.  Convex mixes satisfy this by construction;
            # hostile (non-convex) fuzz mixres can overflow — wrap here
            # (identity for every legal mix).  Found by the fuzz soak:
            # an order-0 + cascade channel fed an unwrapped stream
            # desynced the decoder's zero-run state via escape truncation.
            half = 1 << (chanbits - 1)
            mask = (1 << chanbits) - 1
            u = ((u.astype(np.int64) + half) & mask) - half
            v = ((v.astype(np.int64) + half) & mask) - half
            streams = [u, v]
        else:
            chanbits = cfg.bit_depth - 8 * bs
            bits.write(0, 8)   # mixBits: present in mono elements too
            bits.write(0, 8)   # mixRes
            streams = [his[0]]
        residuals = []
        for i, s in enumerate(streams):
            order, mode = orders[ch + i], modes[ch + i]
            den, pbf = denshifts[ch + i], pbfs[ch + i]
            coefs = np.zeros(32, dtype=np.int64)
            coefs[:3] = dp.init_coefs(max(den, 1))[:3]
            crng = np.random.default_rng(1000 * order + ch + i)
            if order > 3:
                coefs[3:order] = crng.integers(-64, 64, order - 3)
            c = coefs.copy()
            res = dp.pc_block(s, c, order, chanbits, den)
            if mode:
                res = dp.pc_block(res, c[:0], 31, chanbits, 0)
            _write_channel_params(bits, mode, den, pbf, coefs, order)
            residuals.append(res)
        if bs:
            # interleaved shift-byte block between the params and the
            # Rice streams (ALACEncoder.cpp shift-buffer write order)
            for j in range(num):
                for i in range(width):
                    bits.write(int(los[i][j]), 8 * bs)
        for i, res in enumerate(residuals):
            ag.dyn_comp(_rice_params(cfg, num, pbfs[ch + i]), bits, res, num,
                        chanbits)
        ch += width
    bits.write(int(ElementTag.END), 3)
    bits.byte_align(add_zeros=True)
    return bits.to_bytes()


def _oracle_decode(cfg, pkts):
    dec = ALACDecoder(cfg)
    return np.stack([dec.decode_packet(p)[0] for p in pkts])


def _device_decode(cfg, pkts, taps):
    num_words = (cfg.max_escape_packet_bytes(cfg.frame_length) + 3) // 4 + 2
    words = bitpack.bytes_to_words(pkts, num_words)
    pcm, err, num = decode_frames_jit(
        jax.numpy.asarray(words), cfg, cfg.frame_length, taps)
    return np.asarray(pcm), np.asarray(err), np.asarray(num)


@pytest.mark.parametrize("order", [17, 24, 30])
def test_mono_high_order_on_device(rng, order):
    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    pkts = [build_packet(cfg, gen_pcm(rng, "sine", 1, S, 16),
                         [order], [0]) for _ in range(4)]
    ref = _oracle_decode(cfg, pkts)
    pcm, err, _ = _device_decode(cfg, pkts, taps=30)
    assert not err.any()
    np.testing.assert_array_equal(pcm, ref)
    # native decoder (32-wide coef buffers, like the reference) agrees
    from alacjax import native
    nd = native.NativeDecoder(cfg)
    for i, p in enumerate(pkts):
        y, got = nd.decode_packet(p)
        assert got == S
        np.testing.assert_array_equal(y, ref[i])


def test_cpe_high_order_mixed_orders_on_device(rng):
    """ch0 high order, ch1 low order: exercises the per-lane order0
    offset table of the static CPE param parse at max_ord=30."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    cases = [([30, 4], [0, 0]), ([17, 26], [0, 0]), ([4, 30], [0, 0])]
    pkts = [build_packet(cfg, gen_pcm(rng, "sine", 2, S, 16), o, m)
            for o, m in cases]
    ref = _oracle_decode(cfg, pkts)
    pcm, err, _ = _device_decode(cfg, pkts, taps=30)
    assert not err.any()
    np.testing.assert_array_equal(pcm, ref)


def test_high_order_two_stage_mode_on_device(rng):
    """mode != 0 cascade combined with a 20-tap FIR."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    pkts = [build_packet(cfg, gen_pcm(rng, "sine", 2, S, 16),
                         [20, 20], [1, 1]) for _ in range(3)]
    ref = _oracle_decode(cfg, pkts)
    pcm, err, _ = _device_decode(cfg, pkts, taps=30)
    assert not err.any()
    np.testing.assert_array_equal(pcm, ref)


def test_multi_element_high_order_on_device(rng):
    """3-channel layout (SCE + CPE): the generic gather-based param
    parse at max_ord=30."""
    cfg = AlacConfig(bit_depth=16, num_channels=3, frame_length=S)
    pkts = [build_packet(cfg, gen_pcm(rng, "sine", 3, S, 16),
                         [22, 18, 29], [0, 0, 0]) for _ in range(3)]
    ref = _oracle_decode(cfg, pkts)
    pcm, err, _ = _device_decode(cfg, pkts, taps=30)
    assert not err.any()
    np.testing.assert_array_equal(pcm, ref)


def test_production_program_flags_high_order_lanes(rng):
    """The taps=8 production program must ERR on 17..30-tap lanes
    (clean handoff to the retry ladder), never silently misdecode."""
    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    pkts = [build_packet(cfg, gen_pcm(rng, "sine", 1, S, 16), [24], [0])]
    _, err, _ = _device_decode(cfg, pkts, taps=8)
    assert err.all()
    _, err16, _ = _device_decode(cfg, pkts, taps=16)
    assert err16.all()


def test_retry_ladder_reaches_taps30(rng):
    """Public decode API: a batch dominated by high-order streams rides
    the lazy taps=30 program (device), with results oracle-identical."""
    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    n = 64
    pcm = np.stack([gen_pcm(rng, "sine", 1, S, 16) for _ in range(n)])
    pkts = [build_packet(cfg, pcm[i], [19], [0]) for i in range(n)]
    ref = _oracle_decode(cfg, pkts)
    codec = JaxCodec(cfg, chunk=n)
    out = codec.decode_frames(pkts)
    np.testing.assert_array_equal(out, ref)
    # the ladder must have compiled the taps=30 executable (device path,
    # not the scalar-oracle fallback)
    assert any(k[0] == "dec30" for k in codec._exe)
