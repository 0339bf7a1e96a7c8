"""Fused Rice-decode + inverse-predictor scan (decode hot path).

The reference decodes a channel in three serial passes over the frame
(codec/ag_dec.c :: dyn_decomp, then codec/dp_dec.c :: unpc_block once or
twice for the mode!=0 cascade).  Each pass is a sequential scan, so
this module fuses all three into ONE scan: every substep decodes one
Rice residual (or consumes one sample of a pending zero run), feeds it
through the first-difference stage (mode != 0) and the adaptive FIR in
the same step, and emits the reconstructed sample.  Consequences:

  * one scan instead of two-to-three per channel;
  * outputs are dense and in order (exactly one sample per substep), so
    the (B, S) result is a reshape — the zero-run scatter disappears;
  * the intermediate residual array never exists.

Bit reads: substeps share a sliding block cache refilled by ONE 8-word
row gather per scan step (a fixed-rate single-row refill instead of
fetching the worst-case two rows).  One row per step sustains 256/G
bits per sample, above the largest legal codeword (8+1+kb compressed,
9+chanbits escape), so the cursor can only outrun the prefetch through the
adversarial zero-length-run pattern; a per-step drift check flags such
lanes with the error bit and the host re-decodes them on the oracle.
Each substep performs ONE relative-index window fetch (4 consecutive
cache words cover the worst case: residual codeword 9+32 plus zero-run
codeword 9+16 from a phase <= 31 start), and all field extractions are
cheap static selects within that window.

Zero runs are consumed one sample per substep (a ``run_rem`` counter)
instead of jumping the sample cursor: the FIR recurrence must still run
through every zero residual, so per-sample stepping costs nothing extra
and keeps outputs dense.

State arithmetic is uint32/int32 wraparound, bit-identical to the
oracle (alacjax.oracle.ag / .dp); tests assert equality against the
unfused ops and the scalar oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..types import (
    MAX_PREFIX_16, MAX_PREFIX_32, MMULSHIFT, N_MAX_MEAN_CLAMP,
    N_MEAN_CLAMP_VAL, PBSHIFT, QB, QBSHIFT, kALACMaxCoefs,
)
from .jaxutils import I32, U32, clz32, iota1, lg3a, sign_extend, sign_of_int

_U32_ONE = np.uint32(1)
_N_RICE = 7             # rice-state slots in the carry
_MAX_TAPS = 30          # largest 5-bit order that is not the mode-31 special


def _fetch_window4(blk, rel, max_rel):
    """Select 4 consecutive cache words starting at ``rel`` (0..max_rel).

    One select serves every bit read of a substep.  ``max_rel`` is the
    substep-specific reach bound: after a refill the cursor's word sits
    at rel < 8, and substep g can have advanced at most g * max_adv more
    bits, so early substeps need much shorter selects.

    The select is a BINARY TREE on the bits of ``rel`` (depth
    ceil(log2(max_rel)) instead of a max_rel-deep linear chain): the
    window fetch sits on the scan's serial bit-cursor critical path, and
    the decode scan is latency-bound, so chain depth is what the step
    costs.  Candidates past the cache tail pad with the last word — they
    feed only select combinations that rel <= max_rel can never take.
    """
    need = 4
    bit = 1
    while bit <= max_rel:
        need += bit
        bit <<= 1
    cand = [blk[min(j, len(blk) - 1)] for j in range(need)]
    bit = 1
    while bit <= max_rel:
        take = (rel & bit) != 0
        cand = [jnp.where(take, cand[i + bit], cand[i])
                for i in range(len(cand) - bit)]
        bit <<= 1
    return tuple(cand[:4])


def _win_read32(ws, off):
    """32 bits at bit offset ``off`` (0..95) within the 128-bit window.

    (32 - x) & 31 == (32 - x) % 32 for x in [0, 32]; the mask keeps every
    shift amount below 32 (a shift by 32 is undefined in the GPU
    kernel, ops/pallas/decode_step.py)."""
    idx = off >> 5
    a = jnp.where(idx == 0, ws[0], jnp.where(idx == 1, ws[1], ws[2]))
    b = jnp.where(idx == 0, ws[1], jnp.where(idx == 1, ws[2], ws[3]))
    sh = (off & 31).astype(U32)
    return jnp.where(sh == 0, a,
                     jnp.left_shift(a, sh)
                     | jnp.right_shift(b, (32 - sh) & jnp.uint32(31)))


def _win_bits(ws, off, nbits):
    stream = _win_read32(ws, off)
    nb = jnp.asarray(nbits, dtype=U32)
    nb_c = jnp.minimum(nb, jnp.uint32(31))
    mask = jnp.where(nb >= 32, jnp.uint32(0xFFFFFFFF),
                     jnp.left_shift(_U32_ONE, nb_c) - 1)
    return jnp.right_shift(stream, (32 - nb) & jnp.uint32(31)) & mask


def _rice_substep(st, blk, blk_base, g, *, S, chanbits, chanbits_max,
                  pb_v, kb, wb, zero, rel0, cache_words, num=None):
    """One Rice-cursor substep of the fused decode scan: decodes one
    residual codeword (or consumes one pending zero-run sample) and
    advances (bitpos, mb, zmode, run_rem, c, err).  ``chanbits`` may be
    per-lane (B,) (stacked channels of mixed SCE/CPE elements);
    ``chanbits_max`` is its static bound
    (sizes the window reach).  ``rel0`` is the static bound on the
    cursor's cache-relative word index at substep 0 (the refill's drift
    budget); ``cache_words`` the cache size.

    Returns (new_state, res (B,) i32 raw residual, active, decode_now,
    window ws) — the window is reused by callers for extra reads.
    """
    bitpos, mb, zmode, run_rem, c, err = st
    max_adv = MAX_PREFIX_32 + chanbits_max + MAX_PREFIX_16 + 16
    n_eff = S if num is None else num  # per-lane sample count (partial)

    active = c < n_eff
    in_run = run_rem > 0
    decode_now = active & ~in_run

    # substep g's cursor sits <= rel0 words past the refill base plus at
    # most g*max_adv bits: early substeps get short select chains
    off0 = bitpos - blk_base * 32
    max_rel = min(cache_words - 4, rel0 + (g * max_adv + 31) // 32)
    ws = _fetch_window4(blk, (off0 >> 5).astype(I32), max_rel)
    woff = (off0 & 31).astype(I32)

    m0 = mb >> QBSHIFT
    k = jnp.minimum(31 - clz32(m0 + 3), kb)               # lg3a(m0)
    m = jnp.left_shift(_U32_ONE, k.astype(U32)) - 1

    stream = _win_read32(ws, woff)
    pre = clz32(~stream)
    esc = pre >= MAX_PREFIX_32
    v = jnp.right_shift(jnp.left_shift(stream, (pre + 1).astype(U32)),
                        ((32 - k) & 31).astype(U32))
    use_v = (k != 1) & ~esc
    vge2 = v >= 2
    n_plain = (pre.astype(U32) * m
               + jnp.where(use_v & vge2, v - 1, jnp.uint32(0)))
    adv_plain = pre + 1 + jnp.where(use_v, jnp.where(vge2, k, k - 1), 0)
    raw = _win_bits(ws, woff + MAX_PREFIX_32, chanbits)
    n = jnp.where(esc, raw, n_plain)
    adv = jnp.where(esc, MAX_PREFIX_32 + chanbits, adv_plain)

    ndecode = n + zmode
    half = (ndecode >> 1).astype(I32)
    delta = jnp.where((ndecode & 1) == 1, -(half + 1), half)

    c1 = c + 1
    mb_upd = (pb_v * ndecode + mb - ((pb_v * mb) >> PBSHIFT)).astype(U32)
    mb_upd = jnp.where(n > N_MAX_MEAN_CLAMP,
                       jnp.uint32(N_MEAN_CLAMP_VAL), mb_upd)

    trigger = decode_now & ((mb_upd << MMULSHIFT) < QB) & (c1 < n_eff)

    # zero-run codeword (speculative; used when trigger)
    kz = (clz32(mb_upd) - 24
          + ((mb_upd + jnp.uint32(16)) >> 6).astype(I32))
    mz = (jnp.left_shift(_U32_ONE, kz.astype(U32)) - 1) & jnp.uint32(wb)
    off2 = woff + adv
    stream2 = _win_read32(ws, off2)
    pre2 = clz32(~stream2)
    esc2 = pre2 >= MAX_PREFIX_16
    v2 = jnp.right_shift(jnp.left_shift(stream2, (pre2 + 1).astype(U32)),
                         ((32 - kz) & 31).astype(U32))
    v2ge2 = v2 >= 2
    nz_plain = (pre2.astype(U32)
                * jnp.maximum(mz, _U32_ONE)
                + jnp.where((kz != 1) & v2ge2, v2 - 1, jnp.uint32(0)))
    adv2_plain = pre2 + 1 + jnp.where(kz != 1,
                                      jnp.where(v2ge2, kz, kz - 1), 0)
    raw2 = _win_bits(ws, off2 + MAX_PREFIX_16, 16)
    nz = jnp.where(esc2, raw2, nz_plain)
    adv2 = jnp.where(esc2, MAX_PREFIX_16 + 16, adv2_plain)

    overrun = trigger & (c1.astype(U32) + nz > jnp.asarray(n_eff).astype(U32))
    err = err | overrun
    nz_safe = jnp.where(overrun, jnp.uint32(0), nz)

    # ---- merge run-consume vs codeword-decode vs idle ----
    res = jnp.where(decode_now, delta, zero)
    run_rem2 = jnp.where(active,
                         jnp.where(in_run, run_rem - 1,
                                   jnp.where(trigger, nz_safe,
                                             jnp.uint32(0))),
                         run_rem)
    zmode2 = jnp.where(decode_now,
                       jnp.where(trigger & (nz_safe < 65535) & ~overrun,
                                 jnp.uint32(1), jnp.uint32(0)), zmode)
    mb2 = jnp.where(decode_now,
                    jnp.where(trigger, jnp.uint32(0), mb_upd), mb)
    bitpos2 = jnp.where(decode_now,
                        bitpos + adv + jnp.where(trigger, adv2, 0),
                        bitpos)
    c2 = jnp.where(active, c1, c)
    st2 = (bitpos2, mb2, zmode2, run_rem2, c2, err)
    return st2, res, active


def _substep_core(st, pred_st, blk, blk_base, g, *, nk, S, chanbits,
                  cb_max, pb_v, kb, wb, rel0, cache_words, num,
                  na_eff, den, denhalf, mode_nz, is0, is31, r_rows=None):
    """One fused decode substep: Rice codeword decode + inverse
    predictor (dp_dec.c :: unpc_block + the mode-31 first-difference
    stage), shape-agnostic elementwise — the SAME function body serves
    the XLA scan step and the GPU step kernel
    (ops/pallas/decode_step.py), so kernel parity is by construction.

    st = (bitpos i32, mb u32, zmode u32, run_rem u32, c i32, err bool);
    pred_st = (nk+1 lags, nk coefs, s1_acc, acc31) i32; blk a sequence
    of cache words (u32)."""
    c = st[4]
    lags = pred_st[:nk + 1]
    coefs = pred_st[nk + 1:nk + 1 + nk]
    s1_acc, acc31 = pred_st[-2], pred_st[-1]
    na_k = jnp.minimum(na_eff, nk)
    zero = jnp.zeros_like(c)

    # ---- rice codeword decode (shared cursor arithmetic) ----
    st2, res, active = _rice_substep(
        st, blk, blk_base, g, S=S, chanbits=chanbits,
        chanbits_max=cb_max, pb_v=pb_v, kb=kb, wb=wb, zero=zero,
        rel0=rel0, cache_words=cache_words, num=num)

    # ---- fused predictor (dp_dec.c :: unpc_block + mode-31 stage) ----
    s1_acc2 = jnp.where(active, s1_acc + res, s1_acc)
    x_t = jnp.where(mode_nz, sign_extend(s1_acc2, chanbits), res)

    top = zero
    for i in range(nk + 1):
        top = jnp.where(na_k == i, lags[i], top)
    in_warm = c <= na_k

    sum1 = denhalf
    for kk in range(nk):
        term = coefs[kk] * (lags[kk] - top)
        sum1 = sum1 + jnp.where(kk < na_k, term, 0)
    pred_adj = jnp.right_shift(sum1, den)
    out_gen = sign_extend(x_t + top + pred_adj, chanbits)
    out_warm = sign_extend(x_t + lags[0], chanbits)
    out = jnp.where(c == 0, x_t, jnp.where(in_warm, out_warm, out_gen))

    adapt = active & ~in_warm
    sg = sign_of_int(x_t)                      # residual drives adapt
    del0 = x_t
    new_coefs = list(coefs)
    sg_pos = sg > 0
    for kk in range(nk - 1, -1, -1):
        going = (sg_pos & (del0 > 0)) | (~sg_pos & (del0 < 0))
        act_k = adapt & (sg != 0) & going & (kk < na_k)
        dd = top - lags[kk]
        sgn = sign_of_int(dd)
        upd = jnp.where(sg > 0, -sgn, sgn)
        new_coefs[kk] = sign_extend(
            coefs[kk] + jnp.where(act_k, upd, 0), 16)
        mag = sgn * dd
        term = jnp.where(sg > 0, jnp.right_shift(mag, den),
                         jnp.right_shift(-mag, den))
        del0 = del0 - jnp.where(act_k, (na_k - kk) * term, 0)

    # special-mode overlays (mode 0: pass-through; mode 31: cumsum)
    acc31_2 = jnp.where(active, acc31 + x_t, acc31)
    out = jnp.where(is0, x_t,
                    jnp.where(is31, sign_extend(acc31_2, chanbits), out))

    new_lags = tuple(
        jnp.where(active, v, old)
        for v, old in zip((out,) + lags[:-1], lags))
    new_coefs = [jnp.where(active, v, old)
                 for v, old in zip(new_coefs, coefs)]
    pred2 = new_lags + tuple(new_coefs) + (s1_acc2, acc31_2)
    return st2, pred2, out


def _shift_cache(st, ext, blk_base, *, rel0, cache_words, r_rows):
    """Fixed-rate refill bookkeeping shared by the XLA step and the
    GPU step kernel: compute the cache shift from the post-substep
    cursor, flag drift-budget underruns (only reachable via the
    adversarial zero-length-run pattern; such lanes re-decode on the
    host oracle), and shift the extended cache window.

    ext: blk ++ freshly fetched rows (cache_words + 8*r_rows values).
    Returns (st with err updated, new blk_base, blk2 list)."""
    rel = (st[0] >> 5) - blk_base
    kshift = jnp.clip(rel >> 3, 0, r_rows)
    underrun = (rel - 8 * kshift) > rel0
    st = st[:5] + (st[5] | underrun,)
    blk2 = []
    for i in range(cache_words):
        w = ext[i]
        for ks in range(1, r_rows + 1):
            w = jnp.where(kshift == ks, ext[i + 8 * ks], w)
        blk2.append(w)
    return st, blk_base + 8 * kshift, tuple(blk2)


def _step_kernel_ok(raw: bool, chanbits, B: int) -> bool:
    """Route the scan step through the GPU step kernel
    (ops/pallas/decode_step.py): on the GPU backend, for static chanbits
    and a batch that fills whole lane blocks.  The kernel runs the step
    body as one launch; the per-lane row gather stays in XLA."""
    from . import pallas
    return (pallas.gpu_kernels() and not raw
            and isinstance(chanbits, (int, np.integer))
            and B % pallas.LANES == 0)


def cursor_scan(words, start_bits, num_samples: int, chanbits,
                mb0: int, pb, kb: int, wb: int, chanbits_max: int = None,
                skip=None, num=None, g: int | None = None):
    """Rice-cursor-only pass: advance the bit cursor over a channel's
    residual stream WITHOUT reconstructing samples — the cheap first leg
    of the stacked multichannel decode: channel
    c+1's stream starts where channel c's ends (the only cross-channel
    dependency), so a short cursor pass breaks the chain and lets the
    expensive fused scans run stacked across all channels.

    skip: (B,) bool — lanes whose cursor must not advance (escape
    lanes).  num: per-lane (B,) sample counts (partial tails).  Returns
    (end_bits (B,) i32, err (B,) bool) — bit-identical to the cursor
    trajectory of decode_channel (same _rice_substep, same refill
    geometry, same drift check).

    Reference: no scalar counterpart (ag_dec.c decodes values to
    advance); this replays only the length arithmetic.
    """
    B = words.shape[0]
    S = num_samples
    cb_max = chanbits_max if chanbits_max is not None else int(chanbits)
    max_adv = MAX_PREFIX_32 + cb_max + MAX_PREFIX_16 + 16
    import os
    G = max(1, int(os.environ.get("ALACJAX_DECODE_G", str(g or 8))))
    n_steps = -(-S // G)

    max_codeword = max(MAX_PREFIX_32 - 1 + 1 + kb, MAX_PREFIX_32 + cb_max)
    r_rows = -(-G * max_codeword // 256)
    rel0 = 8 * (r_rows + 1)
    max_w = (G * max_adv + 31) // 32
    cache_words = -(-(rel0 + max_w + 4) // 8) * 8
    n_rows = cache_words // 8

    if num is not None:
        num = jnp.asarray(num, I32)
    fetch_row = _make_cache(words, B)
    start_bits = jnp.asarray(start_bits, I32)
    base0 = (start_bits >> 5) & ~jnp.int32(7)
    blk0 = ()
    for i in range(n_rows):
        blk0 = blk0 + fetch_row((base0 >> 3) + i)

    pb_v = jnp.asarray(pb, dtype=U32)
    zero = jnp.zeros((B,), dtype=I32)
    if skip is None:
        skip = jnp.zeros((B,), dtype=bool)
    # skipped lanes: mark the sample counter done so every substep idles
    c0 = jnp.where(skip, jnp.int32(S), 0)

    def step(carry, _):
        st = carry[:_N_RICE - 1]
        blk_base = carry[_N_RICE - 1]
        blk = carry[_N_RICE:]
        for g in range(G):
            st, _, _ = _rice_substep(
                st, blk, blk_base, g, S=S, chanbits=chanbits,
                chanbits_max=cb_max, pb_v=pb_v, kb=kb, wb=wb, zero=zero,
                rel0=rel0, cache_words=cache_words, num=num)
        rel = (st[0] >> 5) - blk_base
        kshift = jnp.clip(rel >> 3, 0, r_rows)
        underrun = (rel - 8 * kshift) > rel0
        st = st[:5] + (st[5] | underrun,)
        ext = blk
        for j in range(r_rows):
            ext = ext + fetch_row((blk_base >> 3) + n_rows + j)
        blk2 = []
        for i in range(cache_words):
            w = ext[i]
            for ks in range(1, r_rows + 1):
                w = jnp.where(kshift == ks, ext[i + 8 * ks], w)
            blk2.append(w)
        return (st + (blk_base + 8 * kshift,) + tuple(blk2)), None

    st0 = (start_bits.astype(I32), jnp.full((B,), mb0, dtype=U32),
           jnp.zeros((B,), dtype=U32), jnp.zeros((B,), dtype=U32),
           c0, jnp.zeros((B,), dtype=bool), base0)
    final, _ = jax.lax.scan(step, st0 + blk0, None, length=n_steps)
    end_bits = jnp.where(skip, start_bits, final[0])
    return end_bits, final[5] & ~skip


def _make_cache(words, B):
    """(B, W) word image -> row-fetch helper + padded row view."""
    W = words.shape[1]
    W8 = (W + 7) // 8
    if W8 * 8 != W:
        words = jnp.pad(words, ((0, 0), (0, W8 * 8 - W)))
    rows = words.reshape(B * W8, 8)
    lane_row0 = iota1(B) * W8

    def fetch_row(row_idx):
        r = jnp.take(rows, lane_row0 + jnp.clip(row_idx, 0, W8 - 1), axis=0)
        return tuple(r[:, i] for i in range(8))

    return fetch_row


def decode_channel(words, start_bits, num_samples: int, chanbits,
                   mb0: int, pb, kb: int, wb: int,
                   coefs0, mode, numactive, denshift,
                   chanbits_max: int = None, taps: int | None = None,
                   raw: bool = False, num=None, g: int | None = None):
    """Decode + reconstruct one channel: (B, W) words -> (B, S) samples.

    start_bits/pb/coefs0/mode/numactive/denshift are per-lane; chanbits
    may be static (single-config decode) or per-lane (B,) (stacked
    channels across SCE/CPE elements), with ``chanbits_max`` its static
    bound.  Returns (samples (B, S) i32, end_bits (B,) i32,
    error (B,) bool).

    ``taps`` specializes the FIR body statically AND sizes the scan
    carry (taps+1 lag registers + taps coef registers per lane, so the
    production 8-tap program carries 9+8 predictor slots instead of
    17+16): taps=8 compiles ONLY the 8-tap walk (lanes with
    numactive > 8 get the error flag — the codec re-runs them through a
    lazily compiled taps=16 or taps=30 program); taps up to _MAX_TAPS=30
    covers every legal 5-bit order (the reference decoder's coef buffers
    are 32 wide, codec/ALACDecoder.cpp, even though its encoder emits
    <= 16); None keeps 8/16 under a runtime lax.cond (tests / unfused
    paths).  Compiling one body instead of two roughly halves the
    decode program's XLA compile time.

    ``raw=True`` returns the signed residual stream (exactly what the
    oracle's ag.dyn_decomp emits) instead of reconstructed samples —
    the residual-only mode behind rice.rice_decode, so the device tree
    has exactly ONE Rice cursor state machine.

    ``num`` (per-lane (B,), <= num_samples) decodes only the first
    ``num`` samples of each lane — partial (tail) frames ride the same
    scan with the remaining substeps idle (reference:
    codec/ALACDecoder.cpp partialFrame path, which this design handles
    with a mask instead of a shorter loop so tails batch with full
    frames under one compiled program).
    """
    B, W = words.shape
    S = num_samples

    cb_max = chanbits_max if chanbits_max is not None else int(chanbits)
    max_adv = MAX_PREFIX_32 + cb_max + MAX_PREFIX_16 + 16
    # ALACJAX_DECODE_G sets the substeps per scan step: XLA:CPU compile
    # time is superlinear in the step-body size, so the CPU test tier
    # sets G=2; results are bit-identical at any G (the cache just
    # refills more often).  The default of 8 dates from before the GPU
    # port and has not been re-measured on the H100.
    import os
    G = max(1, int(os.environ.get("ALACJAX_DECODE_G", str(g or 8))))
    n_steps = -(-S // G)

    # refill geometry: r rows of 8 words prefetched per step must sustain
    # the largest legal codeword per substep (see module docstring); the
    # drift budget rel0 tolerates one extra row of burst before the
    # underrun check trips
    max_codeword = max(MAX_PREFIX_32 - 1 + 1 + kb, MAX_PREFIX_32 + cb_max)
    r_rows = -(-G * max_codeword // 256)
    rel0 = 8 * (r_rows + 1)
    max_w = (G * max_adv + 31) // 32
    cache_words = -(-(rel0 + max_w + 4) // 8) * 8
    n_rows = cache_words // 8

    if num is not None:
        num = jnp.asarray(num, I32)
    fetch_row = _make_cache(words, B)
    start_bits = jnp.asarray(start_bits, I32)
    base0 = (start_bits >> 5) & ~jnp.int32(7)
    blk0 = ()
    for i in range(n_rows):
        blk0 = blk0 + fetch_row((base0 >> 3) + i)

    pb_v = jnp.asarray(pb, dtype=U32)
    zero = jnp.zeros((B,), dtype=I32)

    # predictor per-lane params
    na = jnp.asarray(numactive, I32)
    na_eff = jnp.clip(na, 1, _MAX_TAPS)
    den = jnp.maximum(jnp.asarray(denshift, I32), 1)
    denhalf = jnp.left_shift(jnp.int32(1), den - 1).astype(I32)
    mode_nz = jnp.asarray(mode, I32) != 0
    is0 = na == 0
    is31 = na == 31
    par = dict(na_eff=na_eff, den=den, denhalf=denhalf, mode_nz=mode_nz,
               is0=is0, is31=is31)
    geom = dict(S=S, chanbits=chanbits, cb_max=cb_max, pb_v=pb_v, kb=kb,
                wb=wb, rel0=rel0, cache_words=cache_words, r_rows=r_rows,
                num=num)
    use_kern = _step_kernel_ok(raw, chanbits, B)
    if use_kern:
        def _bc(a):
            return jnp.broadcast_to(jnp.asarray(a).astype(I32), (B,))
        par_stack = jnp.stack([
            _bc(na_eff), _bc(den), _bc(denhalf), _bc(mode_nz),
            _bc(is0), _bc(is31), _bc(pb_v),
            _bc(num) if num is not None else jnp.zeros((B,), I32)],
            axis=0)

    def substep(st, pred_st, blk, blk_base, g, nk):
        if raw:
            # residual-only mode (rice.rice_decode): the signed deltas
            # ARE dyn_decomp's output; skip reconstruction entirely
            zero_l = jnp.zeros_like(st[4])
            st2, res, _ = _rice_substep(
                st, blk, blk_base, g, S=S, chanbits=chanbits,
                chanbits_max=cb_max, pb_v=pb_v, kb=kb, wb=wb,
                zero=zero_l, rel0=rel0, cache_words=cache_words, num=num)
            return st2, pred_st, res
        return _substep_core(st, pred_st, blk, blk_base, g, nk=nk,
                             **geom, **par)

    def make_step(nk):
        def step(carry, _):
            if use_kern:
                # XLA gathers the next r_rows rows per lane, ONE kernel
                # launch runs the G substeps + FIR + cache shift
                from .pallas.decode_step import decode_step_pallas
                st6, base1, blkS, predS = carry
                ext = ()
                for j in range(r_rows):
                    ext = ext + fetch_row((base1[0] >> 3) + n_rows + j)
                extS = jnp.stack([e.astype(I32) for e in ext], axis=0)
                st6, base1, blkS, predS, y = decode_step_pallas(
                    st6, base1, blkS, extS, predS, par_stack, nk=nk,
                    G=G, S=S, chanbits=chanbits, cb_max=cb_max, kb=kb,
                    wb=wb, rel0=rel0, cache_words=cache_words,
                    r_rows=r_rows, has_num=num is not None)
                return (st6, base1, blkS, predS), y
            st = carry[:_N_RICE - 1]
            blk_base = carry[_N_RICE - 1]
            blk = carry[_N_RICE: _N_RICE + cache_words]
            pred_st = carry[_N_RICE + cache_words:]
            outs = []
            for g in range(G):
                st, pred_st, out = substep(st, pred_st, blk, blk_base, g, nk)
                outs.append(out)
            ext = blk
            for j in range(r_rows):
                ext = ext + fetch_row((blk_base >> 3) + n_rows + j)
            st, blk_base, blk2 = _shift_cache(
                st, ext, blk_base, rel0=rel0, cache_words=cache_words,
                r_rows=r_rows)
            # ONE stacked (G, B) output per step instead of G separate
            # (B,) ys: each y is a dynamic-update-slice in the while
            # body, and every DUS ends an XLA fusion
            return (st + (blk_base,) + blk2 + pred_st,
                    jnp.stack(outs, axis=0))
        return step

    rice_st0 = (start_bits.astype(I32), jnp.full((B,), mb0, dtype=U32),
                jnp.zeros((B,), dtype=U32), jnp.zeros((B,), dtype=U32),
                jnp.zeros((B,), dtype=I32), jnp.zeros((B,), dtype=bool),
                base0)
    coefs0_arr = jnp.asarray(coefs0, I32)

    def run(nk):
        def go():
            # carry sized to the tap bound: nk+1 lags + nk coef registers
            # (callers may pass a narrower coef table; pad with zeros —
            # lanes with na > its width are error-flagged anyway)
            coef_cols0 = tuple(
                coefs0_arr[:, k] if k < coefs0_arr.shape[1] else zero
                for k in range(nk))
            pred_st0 = (zero,) * (nk + 1) + coef_cols0 + (zero, zero)
            if use_kern:
                # kernel carry: row-stacked i32 arrays (the kernel
                # consumes/produces whole stacks — no per-iteration
                # jnp.stack of 60+ small arrays)
                st6 = jnp.stack([
                    rice_st0[0], rice_st0[1].astype(I32),
                    rice_st0[2].astype(I32), rice_st0[3].astype(I32),
                    rice_st0[4], rice_st0[5].astype(I32)], axis=0)
                carry0 = (st6, rice_st0[6][None, :],
                          jnp.stack([w.astype(I32) for w in blk0],
                                    axis=0),
                          jnp.stack(pred_st0, axis=0))
            else:
                carry0 = rice_st0 + blk0 + pred_st0
            final, outs = jax.lax.scan(make_step(nk), carry0, None,
                                       length=n_steps)
            # outs: (n_steps, G, B) -> (B, n_steps*G) sample order
            out_tg = outs.reshape(-1, B)
            if use_kern:
                return out_tg.T[:, :S], final[0][0], final[0][5] != 0
            return out_tg.T[:, :S], final[0], final[5]
        return go

    # our encoder (and the reference's) emits orders 4/8 plus the 0/31
    # special modes; the 8-tap body is the production one.  Lanes whose
    # order exceeds the compiled walk flag err; the codec's lazy retry
    # ladder (taps 8 -> 16 -> 30) re-runs them on a wider program.
    if taps is not None:
        nk = min(taps, _MAX_TAPS)
        big = (na > nk) & (na != 31)
        samples, end_bits, err = run(nk)()
        return samples, end_bits, err | big
    small = jnp.all((na <= 8) | (na == 31))
    samples, end_bits, err = jax.lax.cond(
        small, run(8), run(kALACMaxCoefs))
    big = (na > kALACMaxCoefs) & (na != 31)
    return samples, end_bits, err | big


_decode_channel_jit = jax.jit(
    decode_channel,
    static_argnames=("num_samples", "chanbits", "mb0", "kb", "wb",
                     "chanbits_max", "taps", "raw", "g"))


def decode_channel_cached(words, start_bits, num_samples: int, chanbits,
                          mb0: int, pb, kb: int, wb: int,
                          coefs0, mode, numactive, denshift,
                          chanbits_max: int = None,
                          taps: int | None = None, raw: bool = False,
                          num=None, g: int | None = None):
    """decode_channel through a module-level pjit so repeated calls with
    the same static signature TRACE ONCE.  A stereo decode chains two
    identical-shape channel scans; tracing each scan body costs ~4 s of
    Python on a small host (G substeps x ~500 jnp calls each), so the
    chained path was paying it per channel.  The inner pjit call is
    inlined by XLA — runtime-identical programs, tested byte-identical.
    Only usable with a STATIC (int) chanbits; per-lane chanbits (the
    stacked path) falls through to the direct call.  ALACJAX_DECODE_G
    is folded into the static key."""
    import os
    g = max(1, int(os.environ.get("ALACJAX_DECODE_G", str(g or 8))))
    if isinstance(chanbits, (int, np.integer)):
        return _decode_channel_jit(
            words, start_bits, num_samples, int(chanbits), mb0, pb, kb,
            wb, coefs0, mode, numactive, denshift,
            chanbits_max=chanbits_max, taps=taps, raw=raw, num=num, g=g)
    return decode_channel(
        words, start_bits, num_samples, chanbits, mb0, pb, kb, wb,
        coefs0, mode, numactive, denshift, chanbits_max=chanbits_max,
        taps=taps, raw=raw, num=num, g=g)
