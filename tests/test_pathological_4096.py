"""Full-frame (S=4096) pathological content through the device codec.

The decode scan's group/cache-refill
machinery (fused_decode block cache, G-sample substep groups) and the
depth-specific closed-form arithmetic (shift-byte block offsets, escape
extraction strides) have boundary conditions only full-length frames with
adversarial content stress: zero-runs spanning cache refills, escape/run
alternation at group boundaries, max-amplitude residuals right after
silence.  Every BASELINE.json config runs its batch through one compile;
every frame must be byte-identical to the oracle encoder and round-trip
exactly.
"""

import numpy as np
import pytest

from alacjax.codec import get_codec
from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig

pytestmark = pytest.mark.slow  # S=4096 device compile

S = 4096


def _fixtures(rng: np.random.Generator, nch: int, depth: int) -> np.ndarray:
    full = (1 << (depth - 1)) - 1
    frames = []

    # 1. impulses separating zero-runs of growing lengths (runs cross the
    #    24-word cache refill at many distinct phases)
    x = np.zeros((nch, S), np.int64)
    pos, step = 3, 5
    while pos < S:
        x[:, pos] = full
        pos += step
        step = step * 2 + 7
    frames.append(x)

    # 2. run/burst alternation near group boundaries: silence chunks of
    #    30..70 samples interleaved with full-scale noise bursts
    x = np.zeros((nch, S), np.int64)
    j = 0
    w = 30
    while j < S:
        burst = min(w // 3 + 1, S - j - w) if j + w < S else 0
        if burst > 0:
            x[:, j + w:j + w + burst] = rng.integers(
                -full - 1, full + 1, (nch, burst))
        j += w + burst
        w = 30 + (w * 13 + 7) % 41
    frames.append(x)

    # 3. half-frame silence then max-amplitude noise: mb collapses into
    #    run mode, then every residual escapes
    x = np.zeros((nch, S), np.int64)
    x[:, S // 2:] = rng.integers(-full - 1, full + 1, (nch, S - S // 2))
    frames.append(x)

    # 4. per-sample zmode churn: 0, +full, 0, -full, ...
    x = np.zeros((nch, S), np.int64)
    x[:, 1::4] = full
    x[:, 3::4] = -full - 1
    frames.append(x)

    # 5. plain music-like content as the control lane (per-channel phase
    #    rolls keep the stereo/side decisions nontrivial)
    t = np.arange(S)
    sig = np.sin(2 * np.pi * 441 * t / 44100) * 0.6 * full
    x = np.stack([np.roll(sig, 5 * c) for c in range(nch)]).astype(np.int64)
    frames.append(x)

    return np.stack(frames)


CONFIGS = [
    pytest.param(dict(bit_depth=16, num_channels=2), id="stereo16"),
    pytest.param(dict(bit_depth=16, num_channels=1), id="mono16"),
    pytest.param(dict(bit_depth=24, num_channels=2, sample_rate=96000),
                 id="hires24"),
    pytest.param(dict(bit_depth=16, num_channels=6, sample_rate=48000),
                 id="surround51"),
    pytest.param(dict(bit_depth=32, num_channels=2, sample_rate=96000),
                 id="escape32"),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_pathological_full_frames_device_byte_parity(rng, kw):
    cfg = AlacConfig(frame_length=S, **kw)
    x = _fixtures(rng, cfg.num_channels, cfg.bit_depth)
    codec = get_codec(cfg, chunk=x.shape[0])
    pkts = codec.encode_frames(x)
    enc = ALACEncoder(cfg, independent_frames=True)
    for i in range(x.shape[0]):
        assert pkts[i] == enc.encode_packet(x[i]), f"fixture {i}"
    y = codec.decode_frames(pkts)
    np.testing.assert_array_equal(y, x)
