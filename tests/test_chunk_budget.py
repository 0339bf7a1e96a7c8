"""merge_sorted_chunks invariant verification (successor of the
combine_chunks dup-budget check).

The sort-free merge requires that per lane the non-empty chunk keys are
STRICTLY increasing and gaplessly cover [0, n) — i.e. the i-th non-empty
slot holds exactly word i (flush-suppressed emission guarantees it).  A
violated invariant would silently misplace words.  This test instruments
merge_sorted_chunks, runs the WIDEST supported layout (7.1 = 8 channels:
5 elements) with mixed escape/compressed lanes, asserts the invariant on
the real streams, and byte-compares against the oracle so the
instrumented run is a real encode.
"""

import numpy as np
import pytest

from alacjax.ops import bitpack
from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig

S = 64


@pytest.mark.slow
def test_merge_invariant_widest_layout(rng, monkeypatch):
    import alacjax.codec as codec_mod
    from alacjax.codec import JaxCodec

    observed = []
    real = bitpack.merge_sorted_chunks

    def record(keys):
        keys = np.asarray(keys)
        for lane in range(keys.shape[0]):
            k = keys[lane]
            k = k[k != 0xFFFFFFFF].astype(np.int64)
            # strictly increasing, gapless, starting at word 0
            assert (k == np.arange(len(k))).all(), (
                f"lane {lane}: keys violate the gapless-unique invariant")
            observed.append(len(k))

    def instrumented(vals, keys, tail_vals, tail_keys, num_words,
                     radix_bits=2):
        import jax

        jax.debug.callback(record, keys)
        return real(vals, keys, tail_vals, tail_keys, num_words,
                    radix_bits=radix_bits)

    monkeypatch.setattr(codec_mod.bitpack, "merge_sorted_chunks",
                        instrumented)

    cfg = AlacConfig(bit_depth=16, num_channels=8, frame_length=S)
    # mixed content: compressible lanes + full-scale noise (escape) lanes
    x = np.zeros((4, 8, S), dtype=np.int64)
    t = np.arange(S)
    x[0] = (np.sin(t * 0.05)[None, :] * 3000).astype(np.int64)
    x[1] = rng.integers(-32768, 32768, (8, S))        # all escape
    x[2, ::2] = rng.integers(-32768, 32768, (4, S))   # alternating
    x[2, 1::2] = (np.sin(t * 0.1)[None, :] * 500).astype(np.int64)
    x[3] = rng.integers(-40, 40, (8, S))              # tiny residuals

    pkts = JaxCodec(cfg, chunk=4).encode_frames(x)
    enc = ALACEncoder(cfg, independent_frames=True)
    for i in range(4):
        assert pkts[i] == enc.encode_packet(x[i]), f"frame {i}"

    assert observed, "instrumented merge_sorted_chunks never ran"
