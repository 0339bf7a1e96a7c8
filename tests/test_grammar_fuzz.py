"""Differential grammar fuzz: random LEGAL header parameters.

Our encoder emits a narrow parameter slice (orders {4,8}, denshift 9,
pb-factor 4, mixres 0..4, mixbits 2, bytesShifted fixed by depth), but
the wire grammar admits far more and the reference decoder reads the
fields blind (codec/ALACDecoder.cpp channel-parameter parse, mix
parameters, AG params).  These tests synthesize packets with RANDOM
legal parameters over the full fields — order 0..31 (0 = passthrough,
31 = first difference), mode nibble (any nonzero value selects the
cascade), denshift 1..15 (0 legal only for the coef-free modes, as in
the reference where ``1 << (denshift - 1)`` would be UB), pb factor
0..7, signed mixres, mixbits 1..10 — and assert the scalar oracle, the
native C++ decoder, and the DEVICE programs (no oracle fallback:
err-free lanes) agree bit-exactly.

Cross-implementation agreement is the assertion, not PCM round-trip:
non-convex mix parameters (mixres outside [0, 1<<mixbits]) can
legitimately wrap the mixed streams beyond chanbits, in which case all
correct decoders reproduce the same wrapped samples rather than the
builder's input.
"""

import jax
import numpy as np
import pytest

from alacjax import native
from alacjax.codec import decode_frames_jit
from alacjax.oracle import ALACDecoder
from alacjax.ops import bitpack
from alacjax.types import AlacConfig
from conftest import gen_pcm
from test_high_order_decode import build_packet

pytestmark = pytest.mark.slow  # device-compile-heavy (fast tier: -m "not slow")

S = 256
B = 8          # packets per batch (device program shape; rounds reuse it)
ROUNDS = 3
KINDS = ["sine", "noise", "silence", "impulse"]


def _rand_params(rng, nch, max_order):
    """One packet's worth of random legal parameters."""
    orders, modes, dens, pbfs = [], [], [], []
    for _ in range(nch):
        r = rng.random()
        if r < 0.1:
            order = 0
        elif r < 0.2:
            order = 31
        else:
            order = int(rng.integers(1, max_order + 1))
        orders.append(order)
        # mostly single-stage; some cascade, incl. mode nibbles > 1
        modes.append(int(rng.choice([0, 0, 0, 1, 1, 2, 7])))
        # denshift 0 is legal only when no FIR walk runs (order 0/31)
        dens.append(int(rng.integers(0 if order in (0, 31) else 1, 16)))
        pbfs.append(int(rng.integers(0, 8)))
    mixbits = int(rng.integers(1, 11))
    # mostly convex (lossless-roundtrip) mixres, some hostile values
    if rng.random() < 0.75:
        mixres = int(rng.integers(0, min((1 << mixbits), 256)))
    else:
        mixres = int(rng.integers(-128, 128))
    return orders, modes, dens, pbfs, mixbits, mixres


def _build_batch(cfg, seed, max_order):
    """Random-parameter packets CONFORMING on bytesShifted: the device
    decoder treats the depth-derived value as static and errs (oracle
    fallback, documented policy — codec.py decode header check) on
    deviant streams, so batches meant to decode err-free on device must
    carry the conforming value.  Deviant-bs coverage lives in
    test_bs_deviant_flags_err_and_oracle_native_agree below."""
    from alacjax.oracle.encoder import bytes_shifted_for_depth

    bs = bytes_shifted_for_depth(cfg.bit_depth)
    rng = np.random.default_rng(seed)
    pkts, metas = [], []
    for i in range(B):
        pcm = gen_pcm(rng, KINDS[i % len(KINDS)], cfg.num_channels, S,
                      cfg.bit_depth)
        orders, modes, dens, pbfs, mixbits, mixres = _rand_params(
            rng, cfg.num_channels, max_order)
        pkts.append(build_packet(cfg, pcm, orders, modes, mixres=mixres,
                                 denshifts=dens, pbfs=pbfs, mixbits=mixbits,
                                 bytes_shifted=bs))
        metas.append((orders, modes, dens, pbfs, mixbits, mixres))
    return pkts, metas


def _num_words(cfg):
    return (4 * cfg.max_escape_packet_bytes(S) + 256) // 4 + 2


def _assert_all_agree(cfg, pkts, metas, taps):
    dec = ALACDecoder(cfg)
    ref = np.stack([dec.decode_packet(p)[0] for p in pkts])

    nd = native.NativeDecoder(cfg)
    for i, p in enumerate(pkts):
        y, got = nd.decode_packet(p)
        assert got == S, metas[i]
        np.testing.assert_array_equal(y[:, :S], ref[i], err_msg=str(metas[i]))

    words = bitpack.bytes_to_words(pkts, _num_words(cfg))
    pcm, err, num = decode_frames_jit(jax.numpy.asarray(words), cfg, S, taps)
    err = np.asarray(err)
    assert not err.any(), [m for m, e in zip(metas, err) if e]
    np.testing.assert_array_equal(np.asarray(num), S)
    np.testing.assert_array_equal(np.asarray(pcm), ref)


def test_fuzz_stereo_production_orders():
    """Orders 0..8 and 31 through the production (taps=8) program with
    every other field randomized."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    for r in range(ROUNDS):
        pkts, metas = _build_batch(cfg, seed=100 + r, max_order=8)
        _assert_all_agree(cfg, pkts, metas, taps=8)


def test_fuzz_stereo_full_orders():
    """The full legal order range 0..31 through the taps=30 program."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    for r in range(ROUNDS):
        pkts, metas = _build_batch(cfg, seed=200 + r, max_order=30)
        _assert_all_agree(cfg, pkts, metas, taps=30)


def test_fuzz_mono_full_orders():
    """Mono (SCE fast header parse) with the full parameter grammar."""
    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    for r in range(ROUNDS):
        pkts, metas = _build_batch(cfg, seed=300 + r, max_order=30)
        _assert_all_agree(cfg, pkts, metas, taps=30)


def test_fuzz_multielement_full_orders():
    """3-channel SCE+CPE layout: the generic gather-based header parse
    with randomized per-channel parameters."""
    cfg = AlacConfig(bit_depth=16, num_channels=3, frame_length=S)
    for r in range(ROUNDS):
        pkts, metas = _build_batch(cfg, seed=400 + r, max_order=30)
        _assert_all_agree(cfg, pkts, metas, taps=30)


def test_fuzz_partial_frames_random_params():
    """Partial (tail) frames — every real stream's last packet — with
    randomized legal parameters and random per-packet sample counts,
    batched together with full frames: the per-lane num mask must ride
    the device scans (device-native partial decode) and agree
    with the oracle and native decoders sample-for-sample."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    rng = np.random.default_rng(500)
    pkts, metas, nums = [], [], []
    for i in range(B):
        n = S if i % 4 == 0 else int(rng.integers(1, S))
        pcm = gen_pcm(rng, KINDS[i % len(KINDS)], 2, S, 16)[:, :n]
        orders, modes, dens, pbfs, mixbits, mixres = _rand_params(rng, 2, 8)
        pkts.append(build_packet(cfg, pcm, orders, modes, mixres=mixres,
                                 denshifts=dens, pbfs=pbfs, mixbits=mixbits))
        metas.append((n, orders, modes, dens, pbfs, mixbits, mixres))
        nums.append(n)

    dec = ALACDecoder(cfg)
    refs = [dec.decode_packet(p) for p in pkts]
    nd = native.NativeDecoder(cfg)
    for i, p in enumerate(pkts):
        y, got = nd.decode_packet(p)
        assert got == nums[i], metas[i]
        np.testing.assert_array_equal(y[:, :got], refs[i][0],
                                      err_msg=str(metas[i]))

    words = bitpack.bytes_to_words(pkts, _num_words(cfg))
    pcm_d, err, num_d = decode_frames_jit(jax.numpy.asarray(words), cfg, S, 8)
    err = np.asarray(err)
    assert not err.any(), [m for m, e in zip(metas, err) if e]
    np.testing.assert_array_equal(np.asarray(num_d), nums)
    pcm_d = np.asarray(pcm_d)
    for i in range(B):
        np.testing.assert_array_equal(pcm_d[i, :, :nums[i]], refs[i][0],
                                      err_msg=str(metas[i]))
        assert (pcm_d[i, :, nums[i]:] == 0).all()


@pytest.mark.parametrize("depth", [20, 24, 32])
def test_fuzz_deep_depths_with_shift_channel(depth):
    """Random grammar at the deeper depths: the depth-derived shift-byte
    side channel (device-native) combined with randomized predictor and
    Rice parameters."""
    from alacjax.oracle.encoder import bytes_shifted_for_depth

    cfg = AlacConfig(bit_depth=depth, num_channels=2, frame_length=S)
    bs = bytes_shifted_for_depth(depth)
    rng = np.random.default_rng(600 + depth)
    pkts, metas = [], []
    for i in range(B):
        pcm = gen_pcm(rng, KINDS[i % len(KINDS)], 2, S, depth)
        orders, modes, dens, pbfs, mixbits, mixres = _rand_params(rng, 2, 8)
        pkts.append(build_packet(cfg, pcm, orders, modes, mixres=mixres,
                                 denshifts=dens, pbfs=pbfs, mixbits=mixbits,
                                 bytes_shifted=bs))
        metas.append((orders, modes, dens, pbfs, mixbits, mixres))
    _assert_all_agree(cfg, pkts, metas, taps=8)


def test_dse_fil_streams_through_public_device_api():
    """Streams carrying DSE/FIL elements (legal, never emitted by our
    encoder) decode host-only by policy (docs/ARCHITECTURE.md): the
    device program must flag err — never silently misdecode a 3-bit tag
    it doesn't parse — and the public API must return oracle-identical
    PCM via the fallback.  Native parses and skips them like the
    reference (ALACDecoder.cpp DataStreamElement/FillElement)."""
    from alacjax.bitbuffer import BitBuffer
    from alacjax.codec import JaxCodec
    from alacjax.oracle import ALACEncoder
    from alacjax.types import ElementTag

    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    rng = np.random.default_rng(6)
    pkts, pcms = [], []
    for i in range(B):
        x = gen_pcm(rng, KINDS[i % len(KINDS)], 1, S, 16)
        body = ALACEncoder(cfg, independent_frames=True).encode_packet(x)
        bits = BitBuffer(byte_size=len(body) + 64)
        bits.write(int(ElementTag.FIL), 3)
        bits.write(3, 4)
        bits.write(0xABCDEF, 24)
        bits.write(int(ElementTag.DSE), 3)
        bits.write(0, 4)
        bits.write(1, 1)                 # byte-align flag
        bits.write(2, 8)
        bits.byte_align(add_zeros=True)
        bits.write(0xBEEF, 16)
        rd = BitBuffer(body)
        total = len(body) * 8
        while rd.get_position() < total:
            take = min(32, total - rd.get_position())
            bits.write(rd.read(take), take)
        pkts.append(bits.to_bytes())
        pcms.append(x)
    ref = np.stack(pcms)

    nd = native.NativeDecoder(cfg)
    for i, p in enumerate(pkts):
        y, got = nd.decode_packet(p)
        assert got == S
        np.testing.assert_array_equal(y[:, :S], ref[i])

    words = bitpack.bytes_to_words(pkts, _num_words(cfg))
    _, err, _ = decode_frames_jit(jax.numpy.asarray(words), cfg, S, 8)
    assert np.asarray(err).all()

    codec = JaxCodec(cfg, chunk=B)
    out = codec.decode_frames(pkts)
    np.testing.assert_array_equal(out, ref)


def test_bs_deviant_flags_err_and_oracle_native_agree():
    """bytesShifted deviating from the depth-derived value (legal wire,
    never emitted by known encoders) must flag err on the device (the
    documented oracle-fallback policy, docs/ARCHITECTURE.md) — never
    silently misdecode — while oracle and native both decode it."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    rng = np.random.default_rng(5)
    pkts = []
    for i in range(B):  # B packets: reuses test 1's compiled (B, W) shape
        pcm = gen_pcm(rng, KINDS[i % len(KINDS)], 2, S, 16)
        pkts.append(build_packet(cfg, pcm, [4, 8], [0, 0], mixres=2,
                                 bytes_shifted=1))
    dec = ALACDecoder(cfg)
    ref = np.stack([dec.decode_packet(p)[0] for p in pkts])
    nd = native.NativeDecoder(cfg)
    for i, p in enumerate(pkts):
        y, got = nd.decode_packet(p)
        assert got == S
        np.testing.assert_array_equal(y[:, :S], ref[i])
    words = bitpack.bytes_to_words(pkts, _num_words(cfg))
    _, err, _ = decode_frames_jit(jax.numpy.asarray(words), cfg, S, 8)
    assert np.asarray(err).all()
