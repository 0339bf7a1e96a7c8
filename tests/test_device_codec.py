"""Batched device codec end-to-end: byte parity with the oracle encoder,
lossless decode, cross-backend compatibility, and the jax file backend."""

import numpy as np
import pytest

from alacjax.codec import get_codec
from alacjax.oracle import ALACDecoder, ALACEncoder
from alacjax.types import AlacConfig
from conftest import gen_pcm

pytestmark = pytest.mark.slow  # device-compile-heavy (fast tier: -m "not slow")

S = 256
NF = 5


def frames(rng, kind, nch, depth, nf=NF):
    return np.stack([gen_pcm(rng, kind, nch, S, depth) for _ in range(nf)])


@pytest.mark.parametrize("depth", [16, 20, 24, 32])
@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("kind", ["sine", "noise", "silence", "impulse"])
def test_device_packets_byte_identical_to_oracle(rng, depth, nch, kind):
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    x = frames(rng, kind, nch, depth)
    pkts = get_codec(cfg, chunk=NF).encode_frames(x)
    enc = ALACEncoder(cfg, independent_frames=True)
    for i in range(NF):
        assert pkts[i] == enc.encode_packet(x[i]), f"frame {i}"


@pytest.mark.parametrize("depth", [16, 24])
@pytest.mark.parametrize("nch", [1, 2, 6])
def test_device_roundtrip(rng, depth, nch):
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    codec = get_codec(cfg, chunk=NF)
    x = frames(rng, "sine", nch, depth)
    y = codec.decode_frames(codec.encode_frames(x))
    np.testing.assert_array_equal(y, x)


def test_device_decodes_persistent_oracle_streams(rng):
    """Device decode must accept streams from the stateful (coef-persistent)
    oracle encoder, not just independent-frames streams."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    x = frames(rng, "sine", 2, 16)
    enc = ALACEncoder(cfg)  # persistent banks
    pkts = [enc.encode_packet(x[i]) for i in range(NF)]
    y = get_codec(cfg, chunk=NF).decode_frames(pkts)
    np.testing.assert_array_equal(y, x)


def test_oracle_decodes_device_streams(rng):
    cfg = AlacConfig(bit_depth=24, num_channels=2, frame_length=S)
    x = frames(rng, "impulse", 2, 24)
    pkts = get_codec(cfg, chunk=NF).encode_frames(x)
    dec = ALACDecoder(cfg)
    for i in range(NF):
        y, _ = dec.decode_packet(pkts[i])
        np.testing.assert_array_equal(y, x[i])


def test_device_decode_two_stage_mode_on_device(rng):
    """Streams using predictor mode!=0 decode correctly on device (the
    cumsum pre-stage), matching the oracle."""
    import jax.numpy as jnp
    from alacjax.bitbuffer import BitBuffer
    from alacjax.oracle import dp
    from alacjax.oracle import ag as ag_mod
    from alacjax.oracle.encoder import (_rice_params, _write_channel_params,
                                        _write_element_header)
    from alacjax.types import ElementTag, kALACMaxCoefs

    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    x = gen_pcm(rng, "sine", 1, S, 16)[0]
    coefs = dp.init_coefs(9)
    coefs0 = coefs.copy()
    res_fir = dp.pc_block(x, coefs, 8, 16, 9)
    res = dp.pc_block(res_fir, np.zeros(kALACMaxCoefs, dtype=np.int64), 31, 16, 0)
    bits = BitBuffer(byte_size=4 * S)
    _write_element_header(bits, ElementTag.SCE, 0, False, 0, False, S)
    bits.write(0, 16)  # mixBits/mixRes: present in mono elements too
    _write_channel_params(bits, 1, 9, 4, coefs0, 8)
    ag_mod.dyn_comp(_rice_params(cfg, S, 4), bits, res, S, 16)
    bits.write(int(ElementTag.END), 3)
    bits.byte_align(add_zeros=True)
    pkt = bits.to_bytes()

    y = get_codec(cfg, chunk=1).decode_frames([pkt])
    np.testing.assert_array_equal(y[0, 0], x)


def test_device_decode_flags_corrupt_headers_and_falls_back(rng):
    """A frame whose header parse fails on device must be retried on the
    oracle; truly corrupt frames raise typed errors end-to-end."""
    from alacjax.types import AlacError
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    codec = get_codec(cfg, chunk=2)
    x = frames(rng, "sine", 2, 16, nf=2)
    pkts = codec.encode_frames(x)
    bad = bytearray(pkts[1])
    bad[0] = 0xFF  # wrong element tag -> device err flag -> oracle -> raise
    with pytest.raises(AlacError):
        codec.decode_frames([pkts[0], bytes(bad)])


@pytest.mark.parametrize("depth,nch", [(16, 2), (24, 2), (16, 6), (32, 2)])
def test_device_partial_frames_byte_identical_to_oracle(rng, depth, nch):
    """Partial (tail) frames encode ON DEVICE, batched with full frames
    via per-lane sample counts, byte-identical to the oracle
    (reference: ALACEncoder.cpp Encode partial-frame path) —
    and the device decoder eats them back in the same batch."""
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    nums = np.array([S, 5, 100, S - 1, 1, 77], np.int32)
    kinds = ["sine", "noise", "sine", "impulse", "silence", "noise"]
    x = np.zeros((len(nums), nch, S), np.int64)
    for b, (n, k) in enumerate(zip(nums, kinds)):
        x[b] = gen_pcm(rng, k, nch, S, depth)
        x[b, :, n:] = 0
    codec = get_codec(cfg, chunk=len(nums))
    pkts = codec.encode_frames_ex(x, nums)
    enc = ALACEncoder(cfg, independent_frames=True)
    for b, n in enumerate(nums):
        assert pkts[b] == enc.encode_packet(x[b, :, :n]), f"lane {b} num={n}"
    dec, got = codec.decode_frames_ex(pkts)
    np.testing.assert_array_equal(got, nums)
    np.testing.assert_array_equal(dec, x)


@pytest.mark.parametrize("nch", [2, 6])
def test_device_all_escape_batches_byte_identical(rng, nch):
    """Batches where EVERY lane of EVERY element escapes (32-bit white
    noise) take the merge-free assembly fast path (codec.py
    assemble_all_escape): full frames place raw images at static
    offsets; partial lanes merge escape chunks only.  Byte parity with
    the oracle pins both sub-paths."""
    cfg = AlacConfig(bit_depth=32, num_channels=nch, frame_length=S)
    enc = ALACEncoder(cfg, independent_frames=True)

    # full frames, single- and multi-element layouts (static placement)
    x = frames(rng, "noise", nch, 32)
    pkts = get_codec(cfg, chunk=NF).encode_frames(x)
    for i in range(NF):
        assert pkts[i] == enc.encode_packet(x[i]), f"full frame {i}"

    # all-escape partial batch (per-lane offsets -> escape-chunk merge)
    nums = np.array([S, 5, 100, S - 1, 1], np.int32)
    xp = frames(rng, "noise", nch, 32)
    for b, n in enumerate(nums):
        xp[b, :, n:] = 0
    pkts = get_codec(cfg, chunk=NF).encode_frames_ex(xp, nums)
    for b, n in enumerate(nums):
        assert pkts[b] == enc.encode_packet(xp[b, :, :n]), f"lane {b}"


def test_jax_backend_stream_roundtrip_with_partial_tail(rng):
    from alacjax.convert import get_backend
    enc, dec = get_backend("jax")
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    pcm = gen_pcm(rng, "sine", 2, S * 3 + 77, 16)  # partial tail packet
    pkts = enc(cfg, pcm)
    assert len(pkts) == 4
    out = dec(cfg, pkts, pcm.shape[1])
    np.testing.assert_array_equal(out, pcm)


def test_cli_jax_backend(rng, tmp_path):
    from alacjax.cli import main
    from alacjax.containers import pack_pcm, read_wav, unpack_pcm, write_wav
    from alacjax.containers.wav import WavFile
    x = gen_pcm(rng, "sine", 2, 700, 16)
    wav_in = tmp_path / "a.wav"
    write_wav(WavFile(44100, 16, 2, pack_pcm(x, 16)), str(wav_in))
    assert main([str(wav_in), str(tmp_path / "a.caf"), "--frame-size", str(S),
                 "--backend", "jax"]) == 0
    assert main([str(tmp_path / "a.caf"), str(tmp_path / "b.wav"),
                 "--backend", "jax"]) == 0
    back = read_wav(str(tmp_path / "b.wav"))
    np.testing.assert_array_equal(unpack_pcm(back.data, 16, 2), x)


def test_device_persistent_stream_matches_stateful_oracle(rng):
    """encode_streams chains packets through the coefficient banks inside
    a lax.scan: byte-identical to the stateful
    ALACEncoder(cfg) on every packet of every stream."""
    from alacjax.codec import encode_streams

    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    B, N = 3, 4
    kinds = ["sine", "noise", "impulse"]
    pcm = np.stack([frames(rng, kinds[b], 2, 16, nf=N) for b in range(B)])
    streams = encode_streams(pcm, cfg)
    for b in range(B):
        enc = ALACEncoder(cfg)  # persistent banks
        for n in range(N):
            assert streams[b][n] == enc.encode_packet(pcm[b, n]), (b, n)


def test_device_persistent_stream_multichannel(rng):
    from alacjax.codec import encode_streams

    cfg = AlacConfig(bit_depth=24, num_channels=6, frame_length=S)
    B, N = 1, 3
    pcm = np.stack([frames(rng, "sine", 6, 24, nf=N)])
    streams = encode_streams(pcm, cfg)
    enc = ALACEncoder(cfg)
    for n in range(N):
        assert streams[0][n] == enc.encode_packet(pcm[0, n]), n


@pytest.mark.parametrize("nch", [3, 4, 5, 7, 8])
def test_device_all_layouts_byte_identical_and_lossless(rng, nch):
    """Every ELEMENT_LAYOUTS composition (3.0 .. 7.1 — SCE/CPE/LFE mixes,
    reference: ALACEncoder.cpp Encode's per-layout element loop) encodes
    byte-identical to the oracle and decodes losslessly on device,
    including a partial tail frame batched with full frames."""
    cfg = AlacConfig(bit_depth=16, num_channels=nch, frame_length=S)
    codec = get_codec(cfg, chunk=NF)
    # mixed content so different elements pick different search winners
    kinds = ["sine", "impulse", "noise", "silence", "sine"]
    x = np.stack([gen_pcm(rng, kinds[i], nch, S, 16) for i in range(NF)])
    nums = np.array([S, S, S - 77, S, 3])  # two partial tails in-batch
    x[2, :, S - 77:] = 0
    x[4, :, 3:] = 0

    pkts = codec.encode_frames_ex(x, nums)
    enc = ALACEncoder(cfg, independent_frames=True)
    for i in range(NF):
        assert pkts[i] == enc.encode_packet(x[i, :, :nums[i]]), f"frame {i}"

    y, got = codec.decode_frames_ex(pkts)
    assert list(got) == list(nums)
    for i in range(NF):
        np.testing.assert_array_equal(y[i, :, :nums[i]], x[i, :, :nums[i]])
