#!/usr/bin/env python
"""Smoke test of the device path on one GPU: the quickest proof that the
system still starts and is right on the card.

    python chip_smoke.py            # one card, every phase
    python chip_smoke.py --cards 4  # only the sharded frames path

Phases, in order, in this one process:

1. device   — the first JAX device must be a GPU;
2. kernels  — each Triton-route kernel, compiled for the card, equals
              the plain XLA scan at B = 4096 frames and S = 4096 samples,
              with per-lane chanbits (5.1) and partial-tail variants;
3. flagship — ``get_codec`` on 4096 frames of 16-bit 44.1 kHz stereo:
              lossless, no lane handed to the host oracle, and a sample
              of packets byte-identical to the native C++ codec;
4. configs  — mono 16-bit, 24/96 stereo, 5.1 16-bit and 32-bit noise
              (escape) at B = 1024, each lossless with no oracle lanes;
5. cli      — WAV -> M4A with --check and back through
              ``alacjax.cli.main``, then --outdir on files with partial
              final frames.

``--cards 4`` runs only the path users shard (the frames mesh through
``get_codec``, the CLI's --devices and ``ShardedCodec.roundtrip_step``)
at 4 x 4096 frames and compares its packets byte for byte with one card.

Any failed phase exits nonzero.  On success the last line of standard
output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

S = 4096


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def timed(fn, *args, reps=3):
    """(first call incl. compile s, median steady s, result)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), out


def equal_trees(a, b):
    import jax
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(la, lb))


def xla_only(fn):
    """Trace ``fn`` with the kernels' routing off: the plain XLA scans.
    The decode's shared channel jit caches its trace, so it is cleared
    on both sides of the switch."""
    from alacjax.ops import fused_decode, pallas

    def run(*args):
        orig = pallas.gpu_kernels
        pallas.gpu_kernels = lambda: False
        fused_decode._decode_channel_jit.clear_cache()
        try:
            return fn(*args)
        finally:
            pallas.gpu_kernels = orig
            fused_decode._decode_channel_jit.clear_cache()
    return run


# ---------------------------------------------------------------------------
def phase_device(cards: int):
    import jax
    from alacjax.utils.compile_cache import place_compile_cache
    cache = place_compile_cache()
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX's first device is "
                         f"{dev.platform} ({dev.device_kind})")
    if len(devs) < cards:
        raise SystemExit(f"chip_smoke: --cards {cards} but JAX sees "
                         f"{len(devs)} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"device: {dev.device_kind} x{len(devs)}; jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache}")
    log(smi)  # name, power limit: one line per card, as nvidia-smi says
    return dev


def phase_kernels(B: int = 4096):
    """Each kernel vs its XLA scan, exact, compile + steady times."""
    import jax
    import jax.numpy as jnp
    from alacjax.ops import fused_decode, predict, rice
    from bench import make_music

    mb, pb, kb = 10, 40, 14
    wb = (1 << kb) - 1
    pcm = make_music(B, S)
    rng = np.random.default_rng(0)

    def report(name, tx, tk):
        ok = equal_trees(tx[2], tk[2])
        log(f"  {name}: xla compile {tx[0]:.1f} s steady {tx[1] * 1e3:.2f} ms"
            f" | triton compile {tk[0]:.1f} s steady {tk[1] * 1e3:.2f} ms"
            f" | equal {ok}")
        check(ok, f"kernel {name} differs from its XLA scan")

    # cost: the stereo search grid (2 orders x 2 channels x B lanes)
    L = 4 * B
    x = jnp.asarray(np.concatenate([pcm[:, 0], pcm[:, 1]] * 2, axis=0))
    c0 = jnp.zeros((L, 16), jnp.int32)
    na = jnp.asarray(np.repeat([4, 8], 2 * B).astype(np.int32))
    cost = jax.jit(lambda x, c, n: predict.pc_block_cost2(
        x, c, n, 17, 9, mb, pb, kb, wb, na_max=8))
    tk = timed(cost, x, c0, na)
    report("cost (search grid)", timed(jax.jit(xla_only(
        lambda x, c, n: predict.pc_block_cost2(
            x, c, n, 17, 9, mb, pb, kb, wb, na_max=8))), x, c0, na), tk)
    # 5.1-style per-lane chanbits + partial tails, B lanes
    xb = x[:B]
    cb = jnp.asarray(rng.choice([16, 17], B).astype(np.int32))
    num = jnp.asarray(rng.integers(1, S + 1, B).astype(np.int32))
    xb = jnp.where(jnp.arange(S)[None, :] < num[:, None], xb, 0)

    def cost_var(x, c, n, cb, num):
        return predict.pc_block_cost2(x, c, n, cb, 9, mb, pb, kb, wb,
                                      na_max=8, num=num)
    report("cost (per-lane chanbits, partial)",
           timed(jax.jit(xla_only(cost_var)), xb, c0[:B], na[:B], cb, num),
           timed(jax.jit(cost_var), xb, c0[:B], na[:B], cb, num))

    # emission: the stereo emission (2 channels x B lanes)
    res = tk[2][0][:2 * B]
    start = jnp.asarray(rng.integers(0, 4000, 2 * B).astype(np.int32))

    def emit(r, s):
        return rice.rice_encode_words(r, 17, mb, pb, kb, wb, s,
                                      emit_flush=False)
    check(rice._emit_kernel_ok(False), "emission not routed to the kernel")
    report("emit", timed(jax.jit(xla_only(emit)), res, start),
           timed(jax.jit(emit), res, start))

    def emit_var(r, s, cb, num):
        return rice.rice_encode_words(r, cb, mb, pb, kb, wb, s,
                                      bit_size_cap=17, emit_flush=False,
                                      num=num)
    cb2 = jnp.concatenate([cb, cb])
    num2 = jnp.concatenate([num, num])
    report("emit (per-lane chanbits, partial)",
           timed(jax.jit(xla_only(emit_var)), res, start, cb2, num2),
           timed(jax.jit(emit_var), res, start, cb2, num2))

    # decode step: the flagship decode program (two chained channel
    # scans of B lanes) on the device encoder's packets, full and with
    # partial tails
    from alacjax.codec import JaxCodec, decode_frames_device
    from alacjax.types import AlacConfig
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     sample_rate=44100)
    codec = JaxCodec(cfg, chunk=B)
    nums = np.where(np.arange(B) % 5 == 2, rng.integers(1, S, B), S)
    pcm_p = np.where(np.arange(S)[None, None, :] < nums[:, None, None],
                     pcm, 0).astype(np.int32)
    check(fused_decode._step_kernel_ok(False, 17, B),
          "decode step not routed to the kernel")
    for label, words, want in (
            ("", codec._encode(jnp.asarray(pcm))[0], pcm),
            (" (partial)", codec._encode_ex(
                jnp.asarray(pcm_p), jnp.asarray(nums.astype(np.int32)))[0],
             pcm_p)):
        def dec(w):
            return decode_frames_device(w, config=cfg, num_samples=S)
        tk = timed(jax.jit(dec), words)
        report("decode" + label, timed(jax.jit(xla_only(dec)), words), tk)
        out, err, num = tk[2]
        check(not np.asarray(err).any()
              and np.array_equal(np.asarray(out), want)
              and np.array_equal(np.asarray(num), nums if label else
                                 np.full(B, S)),
              "decode" + label + " is not lossless")


def roundtrip(cfg, pcm, chunk, devices=None):
    """encode_frames -> decode_frames through get_codec; returns
    (packets, seconds, compile-inclusive first seconds)."""
    from alacjax.codec import get_codec
    codec = get_codec(cfg, chunk=chunk, devices=devices)
    t0 = time.perf_counter()
    packets = codec.encode_frames(pcm)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = codec.decode_frames(packets)
    t_dec = time.perf_counter() - t0
    check(np.array_equal(out, pcm), f"{cfg}: decode is not lossless")
    check(codec.oracle_fallback_lanes == 0,
          f"{cfg}: {codec.oracle_fallback_lanes} lanes fell back to the "
          "host oracle")
    return packets, t_enc, t_dec


def phase_flagship(dev, B: int = 4096):
    from alacjax import native
    from alacjax.types import AlacConfig
    from bench import make_music
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     sample_rate=44100)
    pcm = make_music(B, S).astype(np.int64)
    packets, t_enc, t_dec = roundtrip(cfg, pcm, B)
    _, t_enc2, t_dec2 = roundtrip(cfg, pcm, B)
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    log(f"  flagship B={B}: first encode {t_enc:.1f} s decode {t_dec:.1f} s"
        f" (compile incl.); warm encode {t_enc2:.3f} s decode "
        f"{t_dec2:.3f} s; peak_bytes_in_use {peak}")
    check(native.available(), f"native codec: {native.build_error()}")
    enc = native.NativeEncoder(cfg, independent_frames=True)
    for i in list(range(0, B, 257)) + [B - 1]:
        check(enc.encode_packet(pcm[i]) == packets[i],
              f"packet {i} differs from the native C++ codec")
    ratio = sum(len(p) for p in packets) / (pcm.size * 2)
    log(f"  {len(packets)} packets, ratio {ratio:.3f}, sampled packets "
        "byte-identical to the native codec")


def phase_configs(B: int = 1024):
    from alacjax.types import AlacConfig
    from bench_configs import CONFIGS, gen
    for name, kw, kind in CONFIGS[1:]:
        cfg = AlacConfig(frame_length=S, **kw)
        pcm = gen(kind, B, S, cfg.num_channels, cfg.bit_depth)
        t0 = time.perf_counter()
        roundtrip(cfg, pcm, B)
        log(f"  {name}: lossless, 0 oracle lanes "
            f"({time.perf_counter() - t0:.1f} s incl. compile)")


def phase_cli():
    from alacjax.cli import main as cli
    from alacjax.containers.wav import WavFile, read_wav, write_wav
    rng = np.random.default_rng(5)

    def wav(path, n, nch=2, rate=44100):
        t = np.arange(n)
        x = (np.sin(t[None, :] * (0.01 + 0.003 * np.arange(nch)[:, None]))
             * 9000 + rng.integers(-50, 50, (nch, n)))
        data = np.clip(x, -32768, 32767).astype("<i2").T.tobytes()
        write_wav(WavFile(rate, 16, nch, data), path)
        return data

    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "a.wav")
        data = wav(src, 5 * S + 1234)
        m4a, back = os.path.join(d, "a.m4a"), os.path.join(d, "back.wav")
        check(cli([src, m4a, "--backend", "jax", "--check"]) == 0,
              "cli encode --check failed")
        check(cli([m4a, back, "--backend", "jax"]) == 0, "cli decode failed")
        check(read_wav(back).data == data, "cli round trip not lossless")
        log("  WAV -> M4A (--check) -> WAV lossless")
        ins = []
        for i, n in enumerate((S - 1, 3 * S + 17, 777, 2 * S)):
            p = os.path.join(d, f"f{i}.wav")
            wav(p, n, nch=1 + i % 2)
            ins.append(p)
        out = os.path.join(d, "out")
        check(cli(ins + ["--outdir", out, "--to", "caf", "--backend",
                         "jax", "--check"]) == 0, "cli --outdir failed")
        log(f"  --outdir: {len(ins)} files with partial final frames, "
            "--check lossless")


def phase_sharded(cards: int, B: int = 4096):
    """The frames mesh on ``cards`` devices vs one card, byte for byte."""
    import jax
    import jax.numpy as jnp
    from alacjax.cli import main as cli
    from alacjax.ops import bitpack
    from alacjax.parallel import ShardedCodec, frame_mesh
    from alacjax.types import AlacConfig
    from bench import make_music
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     sample_rate=44100)
    n = cards * B
    pcm = make_music(n, S).astype(np.int64)
    one, t1e, t1d = roundtrip(cfg, pcm, B, devices=1)
    many, tne, tnd = roundtrip(cfg, pcm, n, devices=cards)
    check(one == many, f"{cards}-card packets differ from one card")
    log(f"  get_codec on {cards} cards: {n} frames byte-identical to one "
        f"card (1 card enc {t1e:.1f} s dec {t1d:.1f} s; {cards} cards "
        f"enc {tne:.1f} s dec {tnd:.1f} s, compile incl.)")
    codec = ShardedCodec(cfg, mesh=frame_mesh(jax.devices()[:cards]),
                         chunk=n)
    decoded, words, bits, total, mismatch, err = codec.roundtrip_step(
        jnp.asarray(pcm.astype(np.int32)))
    check(int(mismatch) == 0 and not np.asarray(err).any(),
          "roundtrip_step not lossless")
    check(bitpack.words_to_bytes(np.asarray(words), np.asarray(bits)) == one,
          "roundtrip_step packets differ from one card")
    check(int(total) == sum(len(p) for p in one), "psum byte total wrong")
    log(f"  ShardedCodec.roundtrip_step: lossless, psum total {int(total)}"
        " bytes, packets byte-identical to one card")
    from alacjax.containers.wav import WavFile, write_wav
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "s.wav")
        x = pcm[:2 * cards].transpose(1, 0, 2).reshape(2, -1)
        write_wav(WavFile(44100, 16, 2, x.astype("<i2").T.tobytes()), src)
        check(cli([src, os.path.join(d, "s.caf"), "--devices", str(cards),
                   "--backend", "jax", "--check"]) == 0,
              "cli --devices failed")
    log(f"  cli --devices {cards} --check: lossless")


def main(argv) -> int:
    cards = 1
    if "--cards" in argv:
        cards = int(argv[argv.index("--cards") + 1])
    t_all = time.perf_counter()
    dev = phase_device(cards)
    import jax
    phases = ([("sharded", lambda: phase_sharded(cards))] if cards > 1 else
              [("kernels", phase_kernels),
               ("flagship", lambda: phase_flagship(dev)),
               ("configs", phase_configs),
               ("cli", phase_cli)])
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}")
        fn()
        log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    log(f"all phases ok ({time.perf_counter() - t_all:.1f} s)")
    devs = jax.devices()[:cards]
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
