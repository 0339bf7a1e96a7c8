"""Multi-device frame-sharding tests on the simulated 8-device CPU mesh
(SURVEY.md §4 item 6)."""

import numpy as np
import pytest
import jax

from alacjax.parallel import ShardedCodec, frame_mesh
from alacjax.types import AlacConfig
from conftest import gen_pcm

pytestmark = pytest.mark.slow  # device-compile-heavy (fast tier: -m "not slow")


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs the multi-device CPU simulation")
    return frame_mesh(devs)


def test_mesh_has_8_simulated_devices():
    assert len(jax.devices()) == 8


def test_sharded_roundtrip_step_lossless(rng, mesh):
    S = 128
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     fast_mode=True)
    codec = ShardedCodec(cfg, mesh=mesh, chunk=mesh.size * 2)
    B = mesh.size * 2
    pcm = np.stack([gen_pcm(rng, "sine", 2, S, 16) for _ in range(B)])
    decoded, _, _, total_bytes, mismatch, err = codec.roundtrip_step(
        pcm.astype(np.int32))
    assert int(mismatch) == 0
    assert not np.asarray(err).any()
    assert int(total_bytes) > 0


def test_sharded_encode_matches_single_device(rng, mesh):
    """Sharding must not change a single packet byte."""
    from alacjax.codec import get_codec
    S = 128
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    B = mesh.size * 2
    pcm = np.stack([gen_pcm(rng, "sine", 2, S, 16) for _ in range(B)])
    sharded = ShardedCodec(cfg, mesh=mesh, chunk=B).encode_frames(pcm)
    single = get_codec(cfg, chunk=B).encode_frames(pcm)
    assert sharded == single


def test_sharded_decode_matches_single_device(rng, mesh):
    """ShardedCodec.decode_frames: sharded decode, byte/sample parity."""
    from alacjax.codec import get_codec
    S = 128
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    B = mesh.size * 2
    pcm = np.stack([gen_pcm(rng, "sine", 2, S, 16) for _ in range(B)])
    packets = get_codec(cfg, chunk=B).encode_frames(pcm)
    sharded = ShardedCodec(cfg, mesh=mesh, chunk=B)
    out = sharded.decode_frames(packets)
    np.testing.assert_array_equal(out, pcm)


def test_get_codec_auto_shards_byte_identical(rng, mesh):
    """get_codec(devices=N): the public auto-shard path — same packets,
    lossless decode, from every entry point that calls get_codec."""
    from alacjax.codec import get_codec
    S = 128
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     fast_mode=True)
    B = mesh.size * 2
    pcm = np.stack([gen_pcm(rng, "impulse", 2, S, 16) for _ in range(B)])
    multi = get_codec(cfg, chunk=B, devices=mesh.size)
    single = get_codec(cfg, chunk=B, devices=1)
    assert multi is not single and multi.mesh is not None
    pk_m = multi.encode_frames(pcm)
    assert pk_m == single.encode_frames(pcm)
    np.testing.assert_array_equal(multi.decode_frames(pk_m), pcm)


def test_cli_devices_flag_byte_identical(rng, tmp_path, monkeypatch):
    """python -m alacjax.cli --devices 8 output == --devices 1 output
    (multi-device is config, not code)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU simulation")
    from alacjax.cli import main
    from alacjax.containers.pcm import pack_pcm
    from alacjax.containers.wav import WavFile, write_wav
    S = 128
    pcm = gen_pcm(rng, "sine", 2, 5 * S + 37, 16)
    src = tmp_path / "in.wav"
    write_wav(WavFile(44100, 16, 2, pack_pcm(pcm, 16)), str(src))
    outs = {}
    for n in (1, 8):
        out = tmp_path / f"out{n}.caf"
        monkeypatch.setenv("ALACJAX_DEVICES", "8")  # restored per-test
        rc = main([str(src), str(out), "--frame-size", str(S),
                   "--devices", str(n), "--backend", "jax"])
        assert rc == 0
        outs[n] = out.read_bytes()
    assert outs[1] == outs[8]


def test_graft_entry_dryrun():
    import __graft_entry__ as g
    g.dryrun_multichip(min(8, len(jax.devices())))
