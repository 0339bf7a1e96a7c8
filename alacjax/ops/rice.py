"""Batched adaptive Rice coding on device (oracle: alacjax.oracle.ag;
reference: codec/ag_enc.c / ag_dec.c).

Encode is reformulated for a vector machine (SURVEY.md §5): a scan over
the sample axis tracks the (mb, zero-run) state machine across B frame
lanes and *emits tokens* — up to three (value, bit-length) pairs per step
(pending zero-run codeword, residual codeword, escape payload) — instead
of writing bits serially.  alacjax.ops.bitpack turns token streams into
packed bytes with a prefix-sum + word-scatter.  A cost-only variant keeps
just the running bit count (used by the encoder's parameter search).

Decode keeps the reference's sequential bit cursor per frame (each
codeword's position depends on all previous lengths) but runs all B frame
cursors in lockstep: one scan step decodes one residual codeword (plus an
optional zero-run codeword) per lane from a (B, W) uint32 word image.

State arithmetic is uint32 wraparound, bit-identical to the oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..types import (
    BITOFF, MAX_PREFIX_16, MAX_PREFIX_32, MAX_RICE_NUMBITS, MDENSHIFT,
    MMULSHIFT, MOFF, N_MAX_MEAN_CLAMP, N_MEAN_CLAMP_VAL, PBSHIFT, QB, QBSHIFT,
)
from .jaxutils import I32, U32, clz32, iota1, lg3a

# numpy scalar, NOT jnp: a module-level jnp array becomes a hoisted
# executable constant, which this jax build loses on repeat calls
_U32_ONE = np.uint32(1)

from .predict import _unroll  # lazy env read; see ops/predict.py


def _divmod_capped(n, m):
    """(min(n // m, 9), n mod m — exact for quotients <= 8).

    Quotients only matter up to the escape threshold 9
    (MAX_PREFIX_32), so the capped quotient is a PARALLEL threshold
    count: div = sum_j [n >= j*m], j = 1..9 — a depth-4 tree of
    adds/compares with no serial dependency.  div >= 9 lanes escape and
    never read the remainder.  m <= 2^kb - 1 = 16383 (types.KB0 caps k
    for both codeword machines), so 9*m cannot wrap u32.
    """
    m2 = m + m
    m3 = m2 + m
    m4 = m2 + m2
    m5 = m4 + m
    m6 = m4 + m2
    m7 = m4 + m3
    m8 = m4 + m4
    m9 = m8 + m
    div = ((n >= m).astype(I32) + (n >= m2).astype(I32)
           + (n >= m3).astype(I32) + (n >= m4).astype(I32)
           + (n >= m5).astype(I32) + (n >= m6).astype(I32)
           + (n >= m7).astype(I32) + (n >= m8).astype(I32)
           + (n >= m9).astype(I32))
    return div, n - m * div.astype(U32)


def _dyn_code_32(bit_size: int, m, k, n):
    """Vectorized ag_enc.c :: dyn_code_32bit.

    Returns (esc, val1 u32, len1 i32): non-escape codeword, or the 9-ones
    escape prefix; escape payload is (n, bit_size) appended by the caller.
    """
    div, mod = _divmod_capped(n, m)
    de = (mod == 0).astype(I32)
    nb = div + k + 1 - de
    esc = (div >= MAX_PREFIX_32) | (nb > MAX_RICE_NUMBITS)
    prefix = jnp.left_shift(_U32_ONE, div.astype(U32)) - 1
    val = jnp.left_shift(prefix, (nb - div).astype(U32)) + mod + 1 - de.astype(U32)
    val1 = jnp.where(esc, jnp.uint32((1 << MAX_PREFIX_32) - 1), val)
    len1 = jnp.where(esc, MAX_PREFIX_32, nb)
    return esc, val1, len1


def _dyn_code_16(m, k, n):
    """Vectorized ag_enc.c :: dyn_code (zero-run lengths; n <= 65535)."""
    m = jnp.maximum(m, _U32_ONE)  # masked lanes may carry mz=0 garbage
    div, mod = _divmod_capped(n, m)
    esc = div >= MAX_PREFIX_16
    de = (mod == 0).astype(I32)
    nb = div + k + 1 - de
    val = jnp.left_shift(jnp.left_shift(_U32_ONE, div.astype(U32)) - 1,
                         (nb - div).astype(U32)) + mod + 1 - de.astype(U32)
    val_esc = jnp.uint32(((1 << MAX_PREFIX_16) - 1) << 16) | n
    return jnp.where(esc, val_esc, val), jnp.where(esc, MAX_PREFIX_16 + 16, nb)


def _run_kz_mz(mb, wb: int):
    """Zero-run Rice parameter from the collapsed mean (shared enc/dec)."""
    kz = clz32(mb) - BITOFF + ((mb + jnp.uint32(MOFF)) >> MDENSHIFT).astype(I32)
    mz = (jnp.left_shift(_U32_ONE, kz.astype(U32)) - 1) & jnp.uint32(wb)
    return kz, mz


def _encode_step_tokens(x, t, state, *, S, bit_size, pb, kb, wb):
    """One scan step: returns (new_state, vals (B,3) u32, lens (B,3) i32).

    Token slots, in stream order: [zero-run codeword, residual codeword,
    escape payload].  ``t == S`` is the virtual end step that flushes a
    pending run token.  ``S`` may be a per-lane (B,) array (partial /
    tail frames): t >= S[b] makes lane b inactive, so the flush fires at
    each lane's own end while the scan length stays static.
    """
    mb, in_run, run_len, run_kz, run_mz = state
    valid = t < S
    x = x.astype(I32)

    nonzero = x != 0
    run_end_nonzero = in_run & nonzero & valid
    run_len_new = run_len + 1
    cap = in_run & ~nonzero & valid & (run_len_new >= 65535)
    flush = in_run & (not valid if isinstance(valid, bool) else ~valid)
    emit_run = run_end_nonzero | cap | flush
    nz = jnp.where(cap, run_len_new, run_len).astype(U32)
    run_val, run_bits = _dyn_code_16(run_mz, run_kz, nz)
    run_bits = jnp.where(emit_run, run_bits, 0)

    code_now = valid & (~in_run | run_end_nonzero)
    zmode = run_end_nonzero.astype(U32)

    m0 = mb >> QBSHIFT
    k = jnp.minimum(lg3a(m0), kb)
    m = jnp.left_shift(_U32_ONE, k.astype(U32)) - 1
    absx = jnp.abs(x).astype(U32)
    n = (absx * 2 - (x < 0).astype(U32) - zmode).astype(U32)
    esc, val1, len1 = _dyn_code_32(bit_size, m, k, n)
    len1 = jnp.where(code_now, len1, 0)
    len2 = jnp.where(code_now & esc, bit_size, 0)

    # mb EMA update + clamp (uint32 wrap)
    pb_v = jnp.asarray(pb, dtype=U32)
    mb_upd = (pb_v * (n + zmode) + mb
              - ((pb_v * mb) >> PBSHIFT)).astype(U32)
    mb_upd = jnp.where(n > N_MAX_MEAN_CLAMP, jnp.uint32(N_MEAN_CLAMP_VAL), mb_upd)
    mb1 = jnp.where(code_now, mb_upd, mb)

    trigger = code_now & ((mb1 << MMULSHIFT) < QB) & (t + 1 < S)
    kz, mz = _run_kz_mz(mb1, wb)
    run_kz2 = jnp.where(trigger, kz, run_kz)
    run_mz2 = jnp.where(trigger, mz, run_mz)
    mb2 = jnp.where(trigger, jnp.uint32(0), mb1)

    continuing = in_run & ~nonzero & valid & ~cap
    in_run2 = continuing | trigger
    run_len2 = jnp.where(continuing, run_len_new, jnp.uint32(0))

    vals = (run_val, val1, n)
    lens = (run_bits, jnp.asarray(len1, I32), jnp.asarray(len2, I32))
    return (mb2, in_run2, run_len2, run_kz2, run_mz2), vals, lens


def _init_state(B, mb0: int):
    return (
        jnp.full((B,), mb0, dtype=U32),        # mb
        jnp.zeros((B,), dtype=bool),            # in_run
        jnp.zeros((B,), dtype=U32),             # run_len
        jnp.zeros((B,), dtype=I32),             # run_kz
        jnp.zeros((B,), dtype=U32),             # run_mz
    )


def rice_encode_tokens(res, bit_size: int, mb0: int, pb: int, kb: int, wb: int):
    """Residuals (B, S) -> token stream (vals (B, 3*(S+1)) u32,
    lens (B, 3*(S+1)) i32) in exact bitstream order."""
    B, S = res.shape
    xs = jnp.concatenate([res.astype(I32).T,
                          jnp.ones((1, B), dtype=I32)], axis=0)  # virtual step
    ts = iota1(S + 1)

    def step(state, inp):
        x, t = inp
        state, vals, lens = _encode_step_tokens(
            x, t, state, S=S, bit_size=bit_size, pb=pb, kb=kb, wb=wb)
        return state, vals + lens

    _, ys = jax.lax.scan(step, _init_state(B, mb0), (xs, ts), unroll=_unroll())
    # 6 x (S+1, B) -> (B, 3*(S+1)); step-major slot order == stream order
    vals = jnp.transpose(jnp.stack(ys[:3], axis=-1), (1, 0, 2)).reshape(B, -1)
    lens = jnp.transpose(jnp.stack(ys[3:], axis=-1), (1, 0, 2)).reshape(B, -1)
    return vals, lens.astype(I32)


def rice_cost(res, bit_size: int, mb0: int, pb: int, kb: int, wb: int,
              num=None):
    """Total Rice bits per frame lane (B,) — the search's cost metric.

    ``num`` (per-lane (B,), <= S): cost only the first num samples of
    each lane (partial / tail frames; the token machine treats t >= num
    as past-the-end, flushing a pending run exactly at num)."""
    B, S = res.shape
    S_eff = S if num is None else num
    xs = jnp.concatenate([res.astype(I32).T,
                          jnp.ones((1, B), dtype=I32)], axis=0)
    ts = iota1(S + 1)

    def step(carry, inp):
        state, total = carry
        x, t = inp
        state, _, lens = _encode_step_tokens(
            x, t, state, S=S_eff, bit_size=bit_size, pb=pb, kb=kb, wb=wb)
        return (state, total + lens[0] + lens[1] + lens[2]), None

    (_, total), _ = jax.lax.scan(
        step, (_init_state(B, mb0), jnp.zeros((B,), dtype=I32)), (xs, ts),
        unroll=_unroll())
    return total


def _append_bits(acc, fill, wcount, v, L):
    """Append the low-L bits of v (L <= 32, possibly 0) to the MSB-first
    word accumulator.  Returns (acc', fill', wcount', emitted_word, emit?).

    At most one word can complete per append.  All branchless.
    """
    L = jnp.asarray(L, I32)
    Lc = jnp.minimum(L.astype(U32), jnp.uint32(31))
    vmask = jnp.where(L >= 32, jnp.uint32(0xFFFFFFFF),
                      jnp.left_shift(_U32_ONE, Lc) - 1)
    v = v.astype(U32) & vmask

    total = fill + L
    ge = total >= 32
    # completed word: acc's fill bits then the top (32 - fill) bits of v
    sh_out = jnp.clip(total - 32, 0, 31).astype(U32)
    out_word = acc | jnp.right_shift(v, sh_out)
    # remainder: low (total-32) bits of v, MSB-aligned
    rem = jnp.clip(total - 32, 0, 31).astype(U32)
    acc_ge = jnp.where(rem == 0, jnp.uint32(0),
                       jnp.left_shift(v, (32 - rem) % 32))
    # no completion: v lands at offset `total` from MSB
    sh_in = jnp.clip(32 - total, 0, 32).astype(U32)
    acc_lt = acc | jnp.where(total >= 32, jnp.uint32(0),
                             jnp.left_shift(v, jnp.minimum(sh_in, jnp.uint32(31))))
    acc2 = jnp.where(ge, acc_ge, acc_lt)
    fill2 = jnp.where(ge, total - 32, total)
    wcount2 = wcount + ge.astype(I32)
    return acc2, fill2, wcount2, out_word, ge


def _emit_slots(cap: int) -> int:
    """Emission slots per step: at most floor((31 + run<=25 + prefix 9
    + bit_size)/32) words complete per step; +1 slot headroom for the
    virtual-step flush."""
    return (31 + 25 + MAX_PREFIX_32 + cap) // 32


def _emit_state0(start_bits, mb0: int):
    """Emission state: Rice machine, word accumulator seeded with the
    stream's bit phase, fill, completed-word count."""
    B = start_bits.shape[0]
    return (_init_state(B, mb0), jnp.zeros((B,), U32), start_bits & 31,
            jnp.zeros((B,), I32))


def _emit_step(state, x, t, *, S: int, S_eff, bit_size, pb, kb: int,
               wb: int, base_word, n_slots: int, emit_flush: bool):
    """One emission step, shared by the XLA scan (rice_encode_words) and
    the GPU kernel (pallas/emit_pallas.py): the token machine's (up to
    three) tokens appended to the word accumulator; completed words land
    in ``n_slots`` (word, absolute key) slots, empty slots keyed
    0xFFFFFFFF.  t == S is the virtual end step."""
    rice_state, acc, fill, wcount = state
    rice_state, vals, lens = _encode_step_tokens(
        x, t, rice_state, S=S_eff, bit_size=bit_size, pb=pb, kb=kb, wb=wb)
    zero = jnp.zeros_like(acc)
    slot_w = [zero] * n_slots
    slot_k = [zero | jnp.uint32(0xFFFFFFFF)] * n_slots
    n_emitted = jnp.zeros_like(fill)
    for v, L in zip(vals, lens):
        key = (base_word + wcount).astype(U32)
        acc, fill, wcount, w, emit = _append_bits(acc, fill, wcount, v, L)
        for si in range(n_slots):
            hit = emit & (n_emitted == si)
            slot_w[si] = jnp.where(hit, w, slot_w[si])
            slot_k[si] = jnp.where(hit, key, slot_k[si])
        n_emitted = n_emitted + emit.astype(I32)
    if emit_flush:
        # final flush on the virtual step (only the run token can emit
        # there, so a free slot always exists)
        flush = (t == S) & (fill > 0)
        fkey = (base_word + wcount).astype(U32)
        for si in range(n_slots):
            hit = flush & (n_emitted == si)
            slot_w[si] = jnp.where(hit, acc, slot_w[si])
            slot_k[si] = jnp.where(hit, fkey, slot_k[si])
    return (rice_state, acc, fill, wcount), (tuple(slot_w), tuple(slot_k))


def _emit_finish(state, base_word):
    """(end_bits, tail_val, tail_key) from the final emission state."""
    _, acc, fill, wcount = state
    end_bits = (base_word + wcount) * 32 + fill
    tail_val = jnp.where(fill > 0, acc, jnp.uint32(0))
    return end_bits, tail_val, (base_word + wcount).astype(U32)


def _emit_kernel_ok(emit_flush: bool) -> bool:
    """Route the emission scan to the GPU kernel (pallas/emit_pallas.py):
    the production mode (emit_flush=False) on the GPU backend."""
    from . import pallas
    return not emit_flush and pallas.gpu_kernels()


def rice_encode_words(res, bit_size, mb0: int, pb, kb: int, wb: int,
                      start_bits, bit_size_cap: int | None = None,
                      emit_flush: bool = True, num=None):
    """Residuals (B, S) -> phase-aligned packed word chunks.

    ``bit_size`` may be a per-lane (B,) array (the encoder stacks every
    channel of every element into one emission scan; SCE and CPE
    channels differ by one bit) — pass ``bit_size_cap`` = static maximum
    to size the per-step emission slots.

    Instead of emitting (value, length) tokens for a later global scatter,
    the scan carries a word accumulator seeded with the stream's absolute
    bit phase (start_bits & 31) and emits completed 32-bit words with
    their absolute word indices (start_bits >> 5 + count).  The caller
    merges chunk streams sort-free (alacjax.ops.bitpack
    .merge_sorted_chunks) — no scatter anywhere.

    emit_flush=False suppresses the final partial-word emission (the
    merge invariant needs each stream to emit exactly its COMPLETE words
    [start>>5, end>>5)); the partial word is returned separately as a
    per-lane tail to be OR'd by the merger.

    ``num`` (per-lane (B,), <= S) encodes only the first num samples of
    each lane — the token machine's end-of-stream predicate is t < num,
    so a pending zero-run flushes exactly at num and later steps emit
    nothing (partial / tail frames batch with full frames).

    Returns (chunk_words (B, n_slots*(S+1)) u32, chunk_keys (same) u32
    with 0xFFFFFFFF marking empty slots, end_bits (B,) i32 = absolute end
    position of the stream, tail_val (B,) u32, tail_key (B,) u32).
    """
    B, S = res.shape
    cap = bit_size if isinstance(bit_size, int) else int(bit_size_cap)
    if _emit_kernel_ok(emit_flush):
        from .pallas.emit_pallas import rice_encode_words_pallas
        return rice_encode_words_pallas(
            res, bit_size, mb0, pb, kb, wb, start_bits, bit_size_cap=cap,
            num=num)
    S_eff = S if num is None else num
    start_bits = jnp.asarray(start_bits, I32)
    base_word = start_bits >> 5
    xs = jnp.concatenate([res.astype(I32).T,
                          jnp.ones((1, B), dtype=I32)], axis=0)
    ts = iota1(S + 1)
    n_slots = _emit_slots(cap)

    def step(state, inp):
        x, t = inp
        return _emit_step(state, x, t, S=S, S_eff=S_eff, bit_size=bit_size,
                          pb=pb, kb=kb, wb=wb, base_word=base_word,
                          n_slots=n_slots, emit_flush=emit_flush)

    state, (ws, ks) = jax.lax.scan(
        step, _emit_state0(start_bits, mb0), (xs, ts), unroll=_unroll())

    # (S+1, B, n_slots) -> (B, n_slots*(S+1)) in stream order
    words = jnp.transpose(jnp.stack(ws, axis=-1), (1, 0, 2)).reshape(B, -1)
    keys = jnp.transpose(jnp.stack(ks, axis=-1), (1, 0, 2)).reshape(B, -1)
    return (words, keys) + _emit_finish(state, base_word)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _peek32(words, bitpos):
    """Load 32 bits at arbitrary bit offsets from the (B, W) word image.

    ``bitpos`` may be (B,) (one cursor per lane) or (B, K) (vectorized
    field extraction, e.g. coefficient/shift-byte arrays)."""
    B, W = words.shape
    squeeze = bitpos.ndim == 1
    bp = bitpos[:, None] if squeeze else bitpos
    w = (bp >> 5).astype(I32)
    sh = (bp & 31).astype(U32)
    # flat 1-D gather (row*W + col)
    flat = words.reshape(-1)
    rows = iota1(B)[:, None] * W
    i0 = rows + jnp.clip(w, 0, W - 1)
    i1 = rows + jnp.clip(w + 1, 0, W - 1)
    w0 = flat[i0]
    w1 = flat[i1]
    out = jnp.where(sh == 0, w0, jnp.left_shift(w0, sh)
                    | jnp.right_shift(w1, (32 - sh) % 32))
    return out[:, 0] if squeeze else out


def _read_bits(words, bitpos, nbits):
    """Read ``nbits`` (1..32, may be per-lane) MSB-first at ``bitpos``."""
    stream = _peek32(words, bitpos)
    nb = jnp.asarray(nbits, dtype=U32)
    nb_c = jnp.minimum(nb, jnp.uint32(31))  # avoid shift-by-32 (undefined)
    mask = jnp.where(nb >= 32, jnp.uint32(0xFFFFFFFF),
                     jnp.left_shift(_U32_ONE, nb_c) - 1)
    return jnp.right_shift(stream, (32 - nb) % 32) & mask


def _fetch128(words, bitpos):
    """Fetch four consecutive words at the cursor — one fetch serves every
    bit read of a full decode step (cursor phase <= 31, residual codeword
    <= 41 bits, zero-run peek at phase+41 reading 32: max 104 < 128).

    Returns ((w0..w3), phase=bitpos & 31)."""
    B, W = words.shape
    flat = words.reshape(-1)
    base = iota1(B) * W
    w = (bitpos >> 5).astype(I32)
    ws = tuple(flat[base + jnp.clip(w + i, 0, W - 1)] for i in range(4))
    return ws, (bitpos & 31).astype(U32)


def _window_read32(ws, off):
    """Read 32 bits at bit offset ``off`` (0..95) within the 128-b window."""
    idx = off >> 5
    a = jnp.where(idx == 0, ws[0], jnp.where(idx == 1, ws[1], ws[2]))
    b = jnp.where(idx == 0, ws[1], jnp.where(idx == 1, ws[2], ws[3]))
    sh = (off & 31).astype(U32)
    return jnp.where(sh == 0, a,
                     jnp.left_shift(a, sh) | jnp.right_shift(b, (32 - sh) % 32))


def _window_bits(ws, off, nbits):
    """Read ``nbits`` (<=32, per-lane) at ``off`` (0..95) in the window."""
    stream = _window_read32(ws, off)
    nb = jnp.asarray(nbits, dtype=U32)
    nb_c = jnp.minimum(nb, jnp.uint32(31))
    mask = jnp.where(nb >= 32, jnp.uint32(0xFFFFFFFF),
                     jnp.left_shift(_U32_ONE, nb_c) - 1)
    return jnp.right_shift(stream, (32 - nb) % 32) & mask


def rice_decode(words, start_bits, num_samples: int, bit_size,
                mb0: int, pb, kb: int, wb: int, max_bit_size: int = 32):
    """Decode ``num_samples`` residuals per lane from packed words.

    words: (B, W) uint32 big-endian bit image of each frame's packet.
    start_bits: (B,) bit offset where each lane's Rice stream begins.
    bit_size: escape payload width (scalar or per-lane (B,));
    max_bit_size: static upper bound on it (sizes the per-step group).
    Returns (residuals (B, S) i32, end_bits (B,), error (B,) bool).

    Implementation: the fused decode kernel's residual-only mode
    (fused_decode.decode_channel(raw=True)) — ONE Rice cursor state
    machine serves both the production decode and this unfused API.
    """
    from . import fused_decode
    B = words.shape[0]
    zeros = jnp.zeros((B,), I32)
    coefs0 = jnp.zeros((B, 16), I32)
    return fused_decode.decode_channel(
        words, start_bits, num_samples, bit_size, mb0,
        jnp.broadcast_to(jnp.asarray(pb, U32), (B,)), kb, wb,
        coefs0, zeros, zeros, zeros + 1,
        chanbits_max=(max_bit_size if not isinstance(bit_size, int)
                      else None),
        taps=8, raw=True)
