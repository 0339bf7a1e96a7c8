#!/usr/bin/env python
"""Time each GPU kernel against the XLA scan it replaces, alone and end to
end, in one process on one card.

    python tools/gpu_kernel_ab.py [B] [S] [--e2e-only]

Per kernel (cost search scan, Rice emission scan): the kernel and the
plain XLA scan are called directly, each compiled once and
timed over repeats with ``block_until_ready``; results must be equal.
The packet merge (XLA radix shuffle, no kernel) is timed alone.  End to
end (this is where the fused-decode step kernel is compared): the
flagship codec (16-bit stereo, S-sample frames, B frames) encodes
through ``JaxCodec`` as routed, with the cost or the emission kernel's
routing switched off alone, and with every kernel off (XLA only); it
decodes as routed and XLA only.  Each is compiled anew, with compile
and steady times.  Prints one JSON line per measurement
and writes them to ``chiprun_out/gpu_kernel_ab.jsonl``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "chiprun_out", "gpu_kernel_ab.jsonl")


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def guarded(name, fn):
    """Run one section; a failure is reported and the next one runs."""
    try:
        fn()
    except Exception as e:  # report and go on: one kernel's fault
        import traceback
        traceback.print_exc()
        emit({"section": name, "error": f"{type(e).__name__}: {e}"[:2000]})


def timed(fn, *args, reps=5):
    """(compile+first-call seconds, median steady seconds, result)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts), out


def same(a, b):
    import jax
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(np.array_equal(np.asarray(x), np.asarray(y)))
        for x, y in zip(la, lb))


def main(argv) -> int:
    from alacjax.utils.compile_cache import place_compile_cache
    place_compile_cache()
    import jax
    import jax.numpy as jnp
    from alacjax.ops import fused_decode, pallas, predict, rice
    from alacjax.ops.pallas import cost_pallas, emit_pallas

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    args = [a for a in argv if not a.startswith("--")]
    B = int(args[0]) if args else 4096
    S = int(args[1]) if len(args) > 1 else 4096
    e2e_only = "--e2e-only" in argv
    dev = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except Exception as e:
        smi = f"nvidia-smi unavailable: {e}"
    emit({"device": dev.platform, "kind": dev.device_kind,
          "count": len(jax.devices()), "nvidia_smi": smi, "B": B, "S": S})

    from bench import make_music
    pcm = make_music(B, S)
    rng = np.random.default_rng(0)
    mb, pb, kb = 10, 40, 14
    wb = (1 << kb) - 1

    state = {}

    def cost_section():
        # ---- cost: the stacked search (2 orders x 2 channels x B) ----
        L = 4 * B
        x = jnp.asarray(np.concatenate([pcm[:, 0], pcm[:, 1]] * 2, axis=0))
        c0 = jnp.zeros((L, 16), jnp.int32)
        na = jnp.asarray(np.repeat([4, 8], 2 * B).astype(np.int32))

        def xla_cost(x, c0, na):
            out_sb, coefs, c1, c2 = predict._scan_general(
                x.T, c0, na, 17, 9, decode=False,
                cost_params=(mb, pb, kb, wb), dual_cost=True, na_max=8)
            return out_sb.T, c1, c2, coefs
        f_x = jax.jit(xla_cost)
        tx = timed(f_x, x, c0, na, reps=3)
        state["res"] = tx[2][0]
        emit({"kernel": "cost", "impl": "xla", "lanes_total": L,
              "compile_s": tx[0], "steady_s": tx[1]})
        tk = timed(jax.jit(lambda x, c0, na: cost_pallas.pc_block_cost2_pallas(
            x, c0, na, 17, 9, mb, pb, kb, wb, na_max=8)), x, c0, na)
        emit({"kernel": "cost", "impl": "triton", "lanes": pallas.LANES,
              "lanes_total": L, "compile_s": tk[0], "steady_s": tk[1],
              "equal": same(tx[2], tk[2])})

    def emit_section():
        # ---- emission: the stacked Rice emission (2 channels x B) ----
        L = 2 * B
        res = (state["res"][:L] if "res" in state else
               jnp.asarray(np.concatenate([pcm[:, 0], pcm[:, 1]], axis=0)))
        start = jnp.asarray(rng.integers(0, 4000, L).astype(np.int32))

        def xla_emit(res, start):
            with_kern = pallas.gpu_kernels
            pallas.gpu_kernels = lambda: False
            try:
                return rice.rice_encode_words(res, 17, mb, pb, kb, wb,
                                              start, emit_flush=False)
            finally:
                pallas.gpu_kernels = with_kern
        f_x = jax.jit(xla_emit)
        tx = timed(f_x, res, start, reps=3)
        emit({"kernel": "emit", "impl": "xla", "lanes_total": L,
              "compile_s": tx[0], "steady_s": tx[1]})
        tk = timed(jax.jit(lambda r, s: emit_pallas.rice_encode_words_pallas(
            r, 17, mb, pb, kb, wb, s)), res, start)
        emit({"kernel": "emit", "impl": "triton", "lanes": pallas.LANES,
              "lanes_total": L, "compile_s": tk[0], "steady_s": tk[1],
              "equal": same(tx[2], tk[2])})

    def merge_section():
        # ---- packet merge: the XLA radix shuffle alone (no kernel) ----
        from alacjax.codec import JaxCodec
        from alacjax.ops import bitpack
        from alacjax.types import AlacConfig
        cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
        W = JaxCodec(cfg, chunk=B).num_words
        T = 4 * S + 4 * W // 3        # about the flagship chunk width
        occ = rng.random((B, T)) < 0.5
        keys = np.where(occ, np.cumsum(occ, axis=1) - 1, -1)
        keys = np.where(keys < W, keys, -1).astype(np.int64)
        keys = jnp.asarray(keys.astype(np.uint32))
        vals = jnp.asarray(rng.integers(0, 2**32, (B, T), dtype=np.uint32))
        tails = (jnp.zeros((B, 1), jnp.uint32),
                 jnp.full((B, 1), 0xFFFFFFFF, jnp.uint32))
        f = jax.jit(lambda v, k: bitpack.merge_sorted_chunks(
            v, k, tails[0], tails[1], W))
        t = timed(f, vals, keys)
        emit({"kernel": "merge", "impl": "xla", "B": B, "T": T, "W": W,
              "compile_s": t[0], "steady_s": t[1]})

    if not e2e_only:
        guarded("cost", cost_section)
        guarded("emit", emit_section)
        guarded("merge", merge_section)

    def e2e_section():
        # ---- end to end, flagship codec: every kernel as routed, each
        # encode kernel switched off alone, and XLA only.  The decode
        # step is the only decode kernel, so "kernels" vs "xla" is its
        # end-to-end comparison. ----
        from alacjax.codec import JaxCodec
        from alacjax.types import AlacConfig
        cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                         sample_rate=44100)
        xin = jnp.asarray(pcm)
        off = {"kernels": (), "no_cost": ((predict, "_cost_kernel_ok"),),
               "no_emit": ((rice, "_emit_kernel_ok"),),
               "xla": ((pallas, "gpu_kernels"),)}
        results = {}
        for impl, switches in off.items():
            saved = [(m, n, getattr(m, n)) for m, n in switches]
            for m, n in switches:
                setattr(m, n, lambda *a: False)
            fused_decode._decode_channel_jit.clear_cache()
            try:
                codec = JaxCodec(cfg, chunk=B)
                te = timed(codec._encode, xin, reps=3)
                td = (timed(codec._decode, te[2][0], reps=3)
                      if impl in ("kernels", "xla") else None)
            finally:
                for m, n, f in saved:
                    setattr(m, n, f)
                fused_decode._decode_channel_jit.clear_cache()
            rec = {"e2e": impl, "encode_compile_s": te[0],
                   "encode_s": te[1]}
            if td is not None:
                dec, err, _ = td[2]
                rec.update(
                    decode_compile_s=td[0], decode_s=td[1],
                    lossless=(not np.asarray(err).any()
                              and bool((np.asarray(dec) == pcm).all())),
                    enc_dec_frames_per_s=B / (te[1] + td[1]))
            rec["peak_bytes"] = (dev.memory_stats() or {}).get(
                "peak_bytes_in_use")
            results[impl] = te[2]
            emit(rec)
        emit({"e2e_packets_equal": all(
            same(results["kernels"], r) for r in results.values())})

    guarded("e2e", e2e_section)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
