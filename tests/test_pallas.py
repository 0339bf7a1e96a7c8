"""GPU kernels (ops/pallas/, Triton route) against the XLA scans and the
scalar oracle.

On the CPU every kernel runs in interpret mode and must equal the XLA
scan bit for bit (the codec is integer-only: every comparison is exact),
and its lowering for the GPU must produce a Triton call.  The ``gpu``
tests run the same comparisons with the kernels compiled for the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alacjax.bitbuffer import BitBuffer
from alacjax.ops import fused_decode, pallas, predict, rice
from alacjax.ops.pallas import cost_pallas, decode_step, emit_pallas
from alacjax.oracle import ag as oag, dp as odp
from alacjax.types import KB0, MB0, PB0

MB, PB, KB = 10, 40, 14
WB = (1 << KB) - 1


def _music_lanes(rng, L, S, bits):
    """Mixed lanes: zero runs, alternating zeros, tiny values, noise,
    sines — every path of the token machine."""
    full = 1 << (bits - 2)
    x = rng.integers(-full, full, (L, S)).astype(np.int32)
    x[:4] = 0
    x[4:8, ::2] = 0
    x[8:12] = rng.integers(-2, 3, (4, S))
    t = np.arange(S)
    x[12:20] = (np.sin(t * 0.05)[None, :] * (full // 2)).astype(np.int32)
    return x


def _cost_case(rng, mode, L, S):
    """Inputs for one cost-kernel case: (x, coefs0, na, chanbits, num,
    dual)."""
    x = _music_lanes(rng, L, S, 17)
    c0 = np.tile(np.asarray(odp.init_coefs(9), np.int32), (L, 1))
    na, cb, num, dual = 8, 17, None, True
    if mode in ("perlane", "partial", "chanbits"):
        na = jnp.asarray(rng.choice([4, 8], L).astype(np.int32))
    if mode == "partial":
        num_np = rng.integers(1, S + 1, L).astype(np.int32)
        for i in range(L):
            x[i, num_np[i]:] = 0
        num = jnp.asarray(num_np)
    if mode == "chanbits":
        cb = jnp.asarray(rng.choice([16, 17, 21], L).astype(np.int32))
    if mode == "single":
        dual = False
    return x, c0, na, cb, num, dual


def _xla_cost(x, c0, na, cb, num, dual):
    if dual:
        return predict.pc_block_cost2(jnp.asarray(x), jnp.asarray(c0), na,
                                      cb, 9, MB, PB, KB, WB, na_max=8,
                                      num=num)
    res, c1, coefs = predict.pc_block_cost_coefs(
        jnp.asarray(x), jnp.asarray(c0), na, cb, 9, MB, PB, KB, WB, num=num)
    return res, c1, jnp.zeros_like(c1), coefs


def _kernel_cost(x, c0, na, cb, num, dual, interpret=True):
    return cost_pallas.pc_block_cost2_pallas(
        jnp.asarray(x), jnp.asarray(c0), na, cb, 9, MB, PB, KB, WB,
        na_max=8, num=num, dual=dual, interpret=interpret)


def _assert_equal(names, ref, got):
    for name, a, b in zip(names, ref, got):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


COST_NAMES = ("res", "cost1", "cost2", "coefs")
EMIT_NAMES = ("words", "keys", "end", "tail_val", "tail_key")
DEC_NAMES = ("samples", "end_bits", "err")


@pytest.mark.parametrize("mode,L,S", [
    ("static8", 64, 64), ("single", 70, 600), ("perlane", 96, 600),
    ("partial", 128, 200), ("chanbits", 40, 97)])
def test_cost_kernel_matches_scan(rng, mode, L, S):
    """Static and per-lane order, dual and single machine, partial
    tails, per-lane chanbits, S not a multiple of 512, lanes padded."""
    case = _cost_case(rng, mode, L, S)
    _assert_equal(COST_NAMES, _xla_cost(*case), _kernel_cost(*case))


def test_cost_kernel_matches_oracle(rng):
    """Sampled lanes against dp_enc.c / ag_enc.c (oracle.dp / oracle.ag)."""
    L, S = 48, 300
    x, c0, na, cb, num, _ = _cost_case(rng, "partial", L, S)
    res, c1, _, coefs = _kernel_cost(x, c0, na, cb, num, True)
    for b in (0, 5, 9, 13, 30):
        nab, nb = int(na[b]), int(num[b])
        c = odp.init_coefs(9)
        r = odp.pc_block(x[b].astype(np.int64), c, nab, 17, 9)
        np.testing.assert_array_equal(np.asarray(res)[b], r)
        bb = BitBuffer(byte_size=8 * S)
        bits = oag.dyn_comp(oag.set_ag_params(MB, PB, KB, S, S, 255), bb,
                            r, nb, 17)
        assert int(c1[b]) == bits


@pytest.mark.parametrize("mode,L,S", [
    ("static", 64, 64), ("perlane", 70, 600), ("partial", 128, 200)])
def test_emit_kernel_matches_scan(rng, mode, L, S):
    """Emission kernel vs rice_encode_words(emit_flush=False): static and
    per-lane bit size, partial tails, odd S, padded lanes."""
    x = _music_lanes(rng, L, S, 17)
    start = jnp.asarray(rng.integers(0, 2000, L).astype(np.int32))
    num, bs, kw = None, 17, {}
    if mode == "perlane":
        bs = jnp.asarray(rng.choice([16, 17], L).astype(np.int32))
        kw = dict(bit_size_cap=17)
    if mode == "partial":
        num = jnp.asarray(rng.integers(1, S + 1, L).astype(np.int32))
    ref = rice.rice_encode_words(jnp.asarray(x), bs, MB, PB, KB, WB, start,
                                 emit_flush=False, num=num, **kw)
    got = emit_pallas.rice_encode_words_pallas(
        jnp.asarray(x), bs, MB, PB, KB, WB, start, num=num, interpret=True,
        **kw)
    _assert_equal(EMIT_NAMES, ref, got)


def test_emit_kernel_matches_oracle(rng):
    """The kernel's chunk words, merged, are the oracle's bitstream."""
    from alacjax.ops import bitpack
    L, S = 32, 257
    x = _music_lanes(rng, L, S, 17)
    words, keys, end, tv, tk = emit_pallas.rice_encode_words_pallas(
        jnp.asarray(x), 17, MB, PB, KB, WB, jnp.zeros((L,), jnp.int32),
        interpret=True)
    nw = S * 2
    img = np.asarray(bitpack.merge_sorted_chunks(
        words, keys, tv[:, None], tk[:, None], nw))
    for b in (0, 5, 9, 13, 25):
        bb = BitBuffer(byte_size=8 * S)
        n = oag.dyn_comp(oag.set_ag_params(MB, PB, KB, S, S, 255), bb,
                         x[b].astype(np.int64), S, 17)
        assert int(end[b]) == n
        want = bb.to_bytes()[:(n + 7) // 8]
        got = bitpack.words_to_bytes(img[b:b + 1], np.asarray([n]))[0]
        assert got == want


def _decode_streams(rng, orders, chanbits_per_lane, S, mode_nz):
    """Oracle-encoded Rice streams for per-lane (order, chanbits) lanes."""
    from alacjax.ops import bitpack
    packets, coefs0, xs = [], [], []
    for b, (na, cb) in enumerate(zip(orders, chanbits_per_lane)):
        full = 1 << (cb - 2)
        kind = b % 4
        if kind == 0:
            x = np.clip((np.sin(np.arange(S) * 0.07) * (full // 2)),
                        -full, full - 1).astype(np.int64)
        elif kind == 1:
            x = rng.integers(-full, full, S)
        elif kind == 2:
            x = np.zeros(S, dtype=np.int64)
            x[::173] = rng.integers(-300, 300, len(x[::173]))
        else:
            x = rng.integers(-3, 4, S)
        c = odp.init_coefs(9)
        coefs0.append(np.asarray(c, dtype=np.int32).copy())
        s1 = odp.pc_block(x, c, na, cb, 9)
        if mode_nz:
            s1 = odp.pc_block(s1, odp.init_coefs(9), 31, cb, 9)
        bb = BitBuffer(byte_size=16 * S)
        oag.dyn_comp(oag.set_standard_ag_params(S, S), bb, s1, S, cb)
        packets.append(bb.to_bytes())
        xs.append(x)
    W = max(len(p) for p in packets) // 4 + 3
    wimg = jnp.asarray(bitpack.bytes_to_words(packets, W))
    return wimg, np.stack(coefs0), np.stack(xs)


def _decode_args(rng, S, mode_nz, n_rep=8):
    orders = [0, 4, 8, 31] * n_rep
    wimg, coefs0, xs = _decode_streams(rng, orders, [17] * len(orders), S,
                                       mode_nz)
    B = len(orders)
    zero = jnp.zeros((B,), jnp.int32)
    args = (wimg, zero, S, 17, MB0, jnp.full((B,), PB0, jnp.int32), KB0,
            (1 << KB0) - 1, jnp.asarray(coefs0),
            jnp.full((B,), 1 if mode_nz else 0, jnp.int32),
            jnp.asarray(np.array(orders, np.int32)),
            jnp.full((B,), 9, jnp.int32))
    return args, xs, orders


@pytest.fixture()
def on_gpu_interpreted(monkeypatch):
    """Route as on the GPU, with every kernel in interpret mode."""
    monkeypatch.setattr(pallas, "gpu_kernels", lambda: True)
    for mod, name in ((cost_pallas, "pc_block_cost2_pallas"),
                      (emit_pallas, "rice_encode_words_pallas"),
                      (decode_step, "decode_step_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


@pytest.mark.parametrize("mode_nz,partial", [(False, True), (True, False)])
def test_step_kernel_matches_xla_step(rng, monkeypatch, mode_nz, partial):
    """decode_channel through the step kernel vs the XLA step: samples,
    end bits and error flags; lossless on the lanes the 8-tap walk
    covers."""
    S = 600
    args, xs, orders = _decode_args(rng, S, mode_nz)
    B = len(orders)
    num = (jnp.asarray(np.where(np.arange(B) % 7 == 3, S // 3, S)
                       .astype(np.int32)) if partial else None)
    ref = fused_decode.decode_channel(*args, taps=8, num=num)
    monkeypatch.setattr(pallas, "gpu_kernels", lambda: True)
    monkeypatch.setattr(decode_step, "decode_step_pallas", functools.partial(
        decode_step.decode_step_pallas, interpret=True))
    got = fused_decode.decode_channel(*args, taps=8, num=num)
    _assert_equal(DEC_NAMES, ref, got)
    if not partial:
        np.testing.assert_array_equal(np.asarray(got[0]), xs)


def test_routing_on_cpu_takes_xla():
    assert not pallas.gpu_kernels()
    assert not predict._cost_kernel_ok(8, 9)
    assert not rice._emit_kernel_ok(False)
    assert not fused_decode._step_kernel_ok(False, 17, 64)


def test_routing_on_gpu(monkeypatch):
    """The platform decides, the shape refines: closed-form orders,
    dynamic denshift, the flushing emission mode, per-lane chanbits,
    raw decode and partial lane blocks stay on XLA."""
    monkeypatch.setattr(pallas, "gpu_kernels", lambda: True)
    assert predict._cost_kernel_ok(8, 9)
    assert predict._cost_kernel_ok(jnp.zeros((4,), jnp.int32), 9)
    assert not predict._cost_kernel_ok(31, 9)
    assert not predict._cost_kernel_ok(8, jnp.int32(9))
    assert rice._emit_kernel_ok(False) and not rice._emit_kernel_ok(True)
    assert fused_decode._step_kernel_ok(False, 17, 2 * pallas.LANES)
    assert not fused_decode._step_kernel_ok(True, 17, 2 * pallas.LANES)
    assert not fused_decode._step_kernel_ok(False, jnp.int32(17),
                                            2 * pallas.LANES)
    assert not fused_decode._step_kernel_ok(False, 17, pallas.LANES + 1)


def test_routed_encode_ops_call_kernels(rng, on_gpu_interpreted,
                                        monkeypatch):
    """With GPU routing the public ops reach the kernels and still equal
    the XLA results."""
    L, S = 40, 130
    case = _cost_case(rng, "perlane", L, S)
    calls = []
    for mod, name in ((cost_pallas, "pc_block_cost2_pallas"),
                      (emit_pallas, "rice_encode_words_pallas")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name, **k: (
            calls.append(name), fn(*a, **k))[1])
    got = _xla_cost(*case)
    start = jnp.arange(L, dtype=jnp.int32) * 7
    got_w = rice.rice_encode_words(jnp.asarray(case[0]), 17, MB, PB, KB, WB,
                                   start, emit_flush=False)
    assert calls == ["pc_block_cost2_pallas", "rice_encode_words_pallas"]
    monkeypatch.setattr(pallas, "gpu_kernels", lambda: False)
    _assert_equal(COST_NAMES, _xla_cost(*case), got)
    _assert_equal(EMIT_NAMES, rice.rice_encode_words(
        jnp.asarray(case[0]), 17, MB, PB, KB, WB, start, emit_flush=False),
        got_w)


@pytest.mark.parametrize("L,lanes", [(1, 32), (32, 32), (33, 32),
                                     (100, 64)])
def test_pad_lanes(L, lanes):
    x = jnp.arange(3 * L, dtype=jnp.int32).reshape(3, L)
    p = pallas.pad_lanes(x, lanes, fill=-1)
    assert p.shape == (3, -(-L // lanes) * lanes)
    np.testing.assert_array_equal(np.asarray(p[:, :L]), np.asarray(x))
    assert bool((p[:, L:] == -1).all())


def _triton_calls(fn, *args):
    """Lower ``fn`` for the GPU (no card needed) and count Triton calls."""
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    return text.count("__gpu$xla.gpu.triton")


def test_kernels_lower_for_gpu_on_triton_route():
    """Each kernel lowers for the GPU, at a real width, as a Triton call
    (the route is named, not left to the Pallas default)."""
    L, S = 64, 4096
    x = jnp.zeros((L, S), jnp.int32)
    c0 = jnp.zeros((L, 16), jnp.int32)
    na = jnp.full((L,), 8, jnp.int32)
    assert _triton_calls(lambda x, c, n: cost_pallas.pc_block_cost2_pallas(
        x, c, n, 17, 9, MB, PB, KB, WB, na_max=8), x, c0, na) == 1
    assert _triton_calls(
        lambda x, s: emit_pallas.rice_encode_words_pallas(
            x, 17, MB, PB, KB, WB, s), x, na) == 1
    n = 8
    st = [jnp.zeros((r, L), jnp.int32) for r in (6, 1, 40, 8, 19, 8)]
    assert _triton_calls(lambda *a: decode_step.decode_step_pallas(
        *a, nk=8, G=n, S=S, chanbits=17, cb_max=17, kb=KB, wb=WB, rel0=16,
        cache_words=40, r_rows=1, has_num=True), *st) == 1


# ---------------------------------------------------------------------------
# compiled for the card (skip on the CPU)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["static8", "single", "perlane", "partial",
                                  "chanbits"])
def test_gpu_cost_kernel_matches_scan(gpu, rng, monkeypatch, mode):
    case = _cost_case(rng, mode, 256, 1000)
    got = _kernel_cost(*case, interpret=False)
    monkeypatch.setattr(pallas, "gpu_kernels", lambda: False)
    _assert_equal(COST_NAMES, _xla_cost(*case), got)


@pytest.mark.gpu
@pytest.mark.parametrize("perlane", [False, True])
def test_gpu_emit_kernel_matches_scan(gpu, rng, monkeypatch, perlane):
    L, S = 256, 1000
    x = jnp.asarray(_music_lanes(rng, L, S, 17))
    start = jnp.asarray(rng.integers(0, 2000, L).astype(np.int32))
    num = jnp.asarray(rng.integers(1, S + 1, L).astype(np.int32))
    bs = (jnp.asarray(rng.choice([16, 17], L).astype(np.int32))
          if perlane else 17)
    got = emit_pallas.rice_encode_words_pallas(
        x, bs, MB, PB, KB, WB, start, bit_size_cap=17, num=num)
    monkeypatch.setattr(pallas, "gpu_kernels", lambda: False)
    _assert_equal(EMIT_NAMES, rice.rice_encode_words(
        x, bs, MB, PB, KB, WB, start, bit_size_cap=17, emit_flush=False,
        num=num), got)


@pytest.mark.gpu
def test_gpu_step_kernel_matches_xla_step(gpu, rng, monkeypatch):
    S = 600
    args, xs, orders = _decode_args(rng, S, False, n_rep=32)
    got = fused_decode.decode_channel(*args, taps=8)
    monkeypatch.setattr(pallas, "gpu_kernels", lambda: False)
    ref = fused_decode.decode_channel(*args, taps=8)
    _assert_equal(DEC_NAMES, ref, got)
