"""Fast-tier device-codec smoke test.

One tiny S=64 encode+decode round-trip through the full jax device
pipeline (search, emission, merge, fused decode) so gross device-path
breakage surfaces in the ~30 s tier instead of the 8-minute slow tier.
Byte- and sample-exact against the oracle.
"""

import numpy as np

from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig

S = 64


def test_device_roundtrip_smoke(rng):
    from alacjax.codec import JaxCodec

    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    t = np.arange(S)
    x = np.stack([
        np.stack([(np.sin(t * 0.2) * 900).astype(np.int64),
                  (np.sin(t * 0.21 + 1) * 700).astype(np.int64)]),
        rng.integers(-60, 60, (2, S)),
    ])
    codec = JaxCodec(cfg, chunk=2)
    pkts = codec.encode_frames(x)
    enc = ALACEncoder(cfg, independent_frames=True)
    for i in range(2):
        assert pkts[i] == enc.encode_packet(x[i]), f"frame {i}"
    y = codec.decode_frames(pkts)
    np.testing.assert_array_equal(y, x)
