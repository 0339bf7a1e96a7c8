"""Vectorized bitstream assembly: token streams -> packed uint32 words.

This is the vectorized replacement for the reference's bit-serial
BitBuffer writes (SURVEY.md §5/§7): an exclusive prefix-sum over token
bit-lengths yields every token's absolute bit offset; each token then
contributes to at most two 32-bit words (value split by the offset's
word phase), and the contributions combine with a scatter-add — bit
regions are disjoint, so add == or, and XLA's scatter-add vectorizes.

Word images are big-endian bit order: bit 0 of the stream is the MSB of
word 0 (byte serialization is words.astype('>u4')).
"""

from __future__ import annotations

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np

from .jaxutils import I32, U32, iota1


def assemble(vals, lens, num_words: int):
    """Pack per-frame token streams into word images.

    vals: (B, T) uint32 token values (low ``lens`` bits significant)
    lens: (B, T) int32 token bit lengths (0 = empty slot), each <= 32
    num_words: static output width W (bits capacity = 32*W)

    Returns (words (B, W) uint32, total_bits (B,) int32).
    """
    vals = vals.astype(U32)
    lens = lens.astype(I32)
    B, T = vals.shape

    offs = jnp.cumsum(lens, axis=1) - lens          # exclusive prefix sum
    total_bits = offs[:, -1] + lens[:, -1]

    L = lens.astype(U32)
    nonempty = lens > 0
    # mask values to their declared width (defensive: callers may leave
    # garbage above bit L-1 in masked-off lanes)
    lc = jnp.minimum(L, jnp.uint32(31))
    mask = jnp.where(L >= 32, jnp.uint32(0xFFFFFFFF),
                     jnp.left_shift(jnp.uint32(1), lc) - 1)
    v = vals & mask

    phase = (offs & 31).astype(I32)
    s = 32 - phase - lens                            # in [-31, 32]
    w0 = (offs >> 5).astype(I32)

    s_pos = jnp.maximum(s, 0).astype(U32)
    s_neg = jnp.maximum(-s, 0).astype(U32)
    hi = jnp.where(nonempty & (s >= 0), jnp.left_shift(v, s_pos),
                   jnp.where(nonempty, jnp.right_shift(v, s_neg), 0))
    lo_shift = jnp.clip(32 + s, 1, 31).astype(U32)
    lo = jnp.where(nonempty & (s < 0), jnp.left_shift(v, lo_shift), 0)

    # Per-lane scatter-add into the word image: the bit regions are
    # disjoint, so add == or.  (An alternative formulation exploiting the
    # monotone token->word mapping — cumsum + searchsorted + boundary
    # differences — lost an end-to-end A/B before the GPU port.)
    def pack_lane(w_idx, hi_v, lo_v):
        out = jnp.zeros((num_words,), dtype=U32)
        # token offsets are monotone, so both index streams are sorted
        out = out.at[w_idx].add(hi_v, mode="drop", indices_are_sorted=True)
        out = out.at[w_idx + 1].add(lo_v, mode="drop", indices_are_sorted=True)
        return out

    words = jax.vmap(pack_lane)(w0, hi, lo)
    return words, total_bits


def pack_fields(fields, d: int, num_words: int | None = None):
    """Pack (B, F) fixed-width fields (``d`` bits each, MSB-first, field k
    at bit offset d*k) into a phase-0 word image — with NO scatter and NO
    gather.

    The bit layout is periodic: with P = d/gcd(d,32) words and
    Q = 32/gcd(d,32) fields per period, field boundaries align with word
    boundaries exactly at period edges, so each output word is a fixed OR
    of statically-shifted fields from its own period.  Reshape + static
    shifts only; XLA vectorizes it fully.  This generalizes the 16-bit
    escape packer to every depth (8/16/20/24/32) and to shift-byte blocks
    (reference packs these serially: codec/ALACEncoder.cpp shift-buffer
    writes, codec/matrix_enc.c :: mix24/mix32).

    Returns (B, W) uint32 where W = num_words or the minimal cover.
    """
    B, F = fields.shape
    assert 1 <= d <= 32
    g = math.gcd(d, 32)
    P, Q = d // g, 32 // g
    n_groups = -(-F // Q)
    v = fields.astype(U32)
    if d < 32:
        v = v & jnp.uint32((1 << d) - 1)
    if n_groups * Q != F:
        v = jnp.pad(v, ((0, 0), (0, n_groups * Q - F)))
    vg = v.reshape(B, n_groups, Q)

    per_p = []
    for p in range(P):
        w = jnp.zeros((B, n_groups), U32)
        for q in range(Q):
            s = d * q - 32 * p          # field start, relative to word p
            if s >= 32 or s + d <= 0:
                continue
            if s + d <= 32:
                sh = 32 - s - d
                w = w | (jnp.left_shift(vg[:, :, q], sh) if sh else vg[:, :, q])
            else:
                w = w | jnp.right_shift(vg[:, :, q], s + d - 32)
        per_p.append(w)
    words = jnp.stack(per_p, axis=-1).reshape(B, n_groups * P)
    need = (F * d + 31) // 32
    words = words[:, :need]
    if num_words is not None:
        if num_words < need:
            raise ValueError("num_words too small for field block")
        if num_words > need:
            words = jnp.pad(words, ((0, 0), (0, num_words - need)))
    return words


def unpack_fields(words, d: int, F: int):
    """Inverse of pack_fields: (B, W) phase-0 word image -> (B, F) fields
    of ``d`` bits each (zero-extended uint32), gather-free via the same
    periodic reshape."""
    B, W = words.shape
    g = math.gcd(d, 32)
    P, Q = d // g, 32 // g
    n_groups = -(-F // Q)
    needW = n_groups * P
    w = words.astype(U32)
    if W < needW:
        w = jnp.pad(w, ((0, 0), (0, needW - W)))
    # per period p-word view: wg[:, :, p] = word (group*P + p)
    wg = w[:, :needW].reshape(B, n_groups, P)
    mask = jnp.uint32(0xFFFFFFFF) if d == 32 else jnp.uint32((1 << d) - 1)
    outs = []
    for q in range(Q):
        s = d * q
        p0, off = s // 32, s % 32
        a = wg[:, :, p0]
        if off + d <= 32:
            f = jnp.right_shift(a, 32 - off - d) & mask
        else:
            # a spanning field never crosses a period edge (Q*d == P*32)
            assert p0 + 1 < P
            hi = jnp.left_shift(a, off + d - 32)
            f = (hi | jnp.right_shift(wg[:, :, p0 + 1], 64 - off - d)) & mask
        outs.append(f)
    fields = jnp.stack(outs, axis=-1).reshape(B, n_groups * Q)
    return fields[:, :F]


def place_segment(words, phase):
    """Shift a phase-0 word image right by a per-lane bit phase (0..31):
    the segment's bits move from [0, 32W) to [phase, phase + 32W).

    Returns (B, W+1) uint32 (one spill word).  Together with per-lane word
    keys this places any pre-packed block at an arbitrary absolute bit
    offset for combine_chunks — the building block that extends the
    scatter-free assembler to data-dependent element offsets.
    """
    B, W = words.shape
    p = phase.astype(U32)[:, None]
    prev = jnp.pad(words, ((0, 0), (1, 0)))        # w[j-1], w[-1] = 0
    cur = jnp.pad(words, ((0, 0), (0, 1)))         # w[j],   w[W] = 0
    hi = jnp.where(p == 0, jnp.uint32(0),
                   jnp.left_shift(prev, (32 - p) % 32))
    lo = jnp.where(p == 0, cur, jnp.right_shift(cur, p))
    return hi | lo


def extract_segment(words, start_bits, num_out: int):
    """Inverse of place_segment: cut ``num_out`` phase-0 words starting at
    a per-lane bit offset from the (B, W) image.

    ONE word-granularity gather (num_out+1 columns) plus a per-lane funnel
    shift.  For a d-bit field block this replaces per-field _peek32
    gathers (2 word loads per FIELD) with ~d/32 loads per field — pair
    with unpack_fields to read contiguous fixed-stride blocks (shift
    bytes, escape samples; reference reads these bit-serially:
    codec/ALACDecoder.cpp shift-buffer reads + escape path).
    """
    B, W = words.shape
    w0 = (start_bits >> 5).astype(I32)[:, None]
    ph = (jnp.asarray(start_bits).astype(U32) & 31)[:, None]
    flat = words.reshape(-1)
    rows = iota1(B)[:, None] * W
    idx = w0 + iota1(num_out + 1)[None, :]
    wv = jnp.where(idx < W,
                   flat[rows + jnp.clip(idx, 0, W - 1)], jnp.uint32(0))
    hi = jnp.where(ph == 0, wv[:, :-1], jnp.left_shift(wv[:, :-1], ph))
    lo = jnp.where(ph == 0, jnp.uint32(0),
                   jnp.right_shift(wv[:, 1:], (32 - ph) % 32))
    return hi | lo


def combine_chunks(words, keys, num_words: int, max_dups: int = 8):
    """Merge sparse (absolute word index, word value) chunk streams into a
    dense word image — the scatter-free packet assembler.

    keys: (B, T) uint32 word indices (0xFFFFFFFF = empty slot).  Each real
    word index appears at least once and at most a few times (segment
    boundary words shared between header/channel/END streams, whose set
    bits are disjoint, so duplicate values combine by addition).  Sort by
    key, chain-merge duplicate
    runs into their first occurrence, then reconstruct positionally: after
    sorting, the entry for word j sits at position j + (#duplicate extras
    before j) <= j + max_dups, so max_dups+1 static shifts recover it.

    max_dups bounds the CUMULATIVE duplicate extras across the whole
    packet, not per word: every segment boundary (header/shift/rice
    channels/END, per element) can share one word with its neighbor, so
    callers must size it to the element layout (codec passes
    4 + 4*n_elements).

    If a lane's actual duplicate extras ever exceed max_dups the
    positional reconstruct would silently drop a word; instead of
    corrupting quietly, that lane's whole image is bit-inverted so the
    lossless gates / byte-parity tests fail loudly (the overflow check
    is one compare + reduce — effectively free next to the sort).
    """
    B, T = words.shape
    keys_s, words_s = jax.lax.sort((keys.astype(U32), words.astype(U32)),
                                   dimension=1, num_keys=1)

    # chain-merge duplicates into the first of each run
    combined = words_s
    same_prev = jnp.concatenate(
        [jnp.zeros((B, 1), bool), keys_s[:, 1:] == keys_s[:, :-1]], axis=1)
    run = jnp.ones((B, T), bool)
    for r in range(1, max_dups + 1):
        # run[i]: keys_s[i..i+r] all equal
        nxt = jnp.concatenate(
            [same_prev[:, r:], jnp.zeros((B, r), bool)], axis=1)
        run = run & nxt
        shifted = jnp.concatenate(
            [words_s[:, r:], jnp.zeros((B, r), U32)], axis=1)
        combined = combined + jnp.where(run, shifted, 0)
    first = ~same_prev

    # positional reconstruct
    pad = max_dups + 1
    keys_p = jnp.concatenate(
        [keys_s, jnp.full((B, pad), 0xFFFFFFFF, U32)], axis=1)
    comb_p = jnp.concatenate([combined, jnp.zeros((B, pad), U32)], axis=1)
    first_p = jnp.concatenate([first, jnp.zeros((B, pad), bool)], axis=1)
    jq = iota1(num_words, U32)[None, :]
    out = jnp.zeros((B, num_words), U32)
    if T + pad < num_words + pad:
        raise ValueError("chunk slot count smaller than output width")
    for r in range(max_dups + 1):
        k_r = keys_p[:, r:r + num_words]
        c_r = comb_p[:, r:r + num_words]
        f_r = first_p[:, r:r + num_words]
        out = out + jnp.where((k_r == jq) & f_r, c_r, 0)

    # budget overflow -> poison the lane (see docstring).  A first
    # occurrence of real key j sits at sorted position j + extras_before,
    # so extras_before = pos - key; reconstruction reaches offsets
    # <= max_dups only.
    pos = iota1(T, U32)[None, :]
    real = keys_s != jnp.uint32(0xFFFFFFFF)
    over = jnp.any(first & real & ((pos - keys_s) > jnp.uint32(max_dups)),
                   axis=1)
    return jnp.where(over[:, None], ~out, out)


def merge_sorted_chunks(vals, keys, tail_vals, tail_keys, num_words: int,
                        radix_bits: int = 2):
    """Compact per-lane sorted sparse chunk streams into a dense word
    image, then OR per-lane boundary ("tail") words on top — the sort-free
    packet assembler.

    vals/keys: (B, T) uint32.  INVARIANT (stronger than combine_chunks):
    per lane, the non-INF keys are STRICTLY increasing and cover
    [0, n_lane) gaplessly with no duplicates — i.e. the i-th non-empty
    slot holds exactly word i.  The emitters guarantee this by
    suppressing each segment's final partial-word flush: a segment with
    bits [start, end) emits exactly the complete words [start>>5, end>>5)
    (the next segment's phase-seeded accumulator re-emits the boundary
    word), and the suppressed partial words arrive via tail_vals/
    tail_keys (B, n_t) — duplicates allowed there, bit-disjoint, OR'd in
    O(n_t) passes.

    Compaction is an LSB-first radix shuffle: element j's displacement
    d_j = j - (#non-empty before j) is non-decreasing with distinct
    targets, so moving elements left by their displacement one radix
    digit at a time is collision-free (if positions p_i..p_j collided at
    digit r, floor(d_i/R^r) - floor(d_j/R^r) = t_j - t_i > 0 would
    contradict d non-decreasing).  ~log_R(T) rounds of static shifted
    selects — no sort, no scatter, no gather.
    """
    B, T = vals.shape
    val = vals.astype(U32)
    k = keys.astype(U32)

    nonempty = k != jnp.uint32(0xFFFFFFFF)
    j = iota1(T, I32)[None, :]
    # rank == key under the invariant above (the i-th non-empty slot
    # holds exactly word i), so no prefix count is needed
    rem = jnp.where(nonempty, j - k.astype(I32), 0)
    val = jnp.where(nonempty, val, 0)

    R = 1 << radix_bits
    shift = 0
    while (1 << shift) < T:
        p = 1 << shift
        digit = (rem >> shift) & (R - 1)
        nv = jnp.where(digit == 0, val, 0)
        nr = jnp.where(digit == 0, rem, 0)
        for kk in range(1, R):
            d = kk * p
            if d >= T:
                break
            dk = jnp.pad(digit[:, d:], ((0, 0), (0, d)))
            vk = jnp.pad(val[:, d:], ((0, 0), (0, d)))
            rk = jnp.pad(rem[:, d:], ((0, 0), (0, d)))
            hit = dk == kk
            nv = nv | jnp.where(hit, vk, 0)
            nr = nr + jnp.where(hit, rk - d, 0)
        val, rem = nv, nr
        shift += radix_bits

    if T < num_words:
        val = jnp.pad(val, ((0, 0), (0, num_words - T)))
    out = val[:, :num_words]

    jq = iota1(num_words, U32)[None, :]
    for t in range(tail_vals.shape[1]):
        out = out | jnp.where(tail_keys[:, t:t + 1] == jq,
                              tail_vals[:, t:t + 1], 0)
    return out


def words_to_bytes(words: np.ndarray, total_bits: np.ndarray) -> list[bytes]:
    """Host-side: big-endian word images -> per-frame byte strings,
    truncated to ceil(total_bits/8).

    Hot at device speed (every encoded chunk funnels through here): one
    byteswap pass + zero-copy memoryview slicing runs ~6x faster than
    the astype('>u4').tobytes() + bytes-slicing version it replaced —
    at B=4096 that was ~0.2 s/chunk, comparable to the DEVICE time for
    the same frames, i.e. a 2x end-to-end CLI tax."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if words.size == 0:
        return [b""] * words.shape[0]
    if sys.byteorder == "little":
        words = words.byteswap()
    mv = memoryview(words).cast("B")
    W4 = words.shape[1] * 4
    nb = ((np.asarray(total_bits) + 7) // 8).tolist()
    return [bytes(mv[b * W4: b * W4 + nb[b]])
            for b in range(words.shape[0])]


def bytes_to_words(packets: list[bytes], num_words: int) -> np.ndarray:
    """Host-side: per-frame packet bytes -> (B, W) big-endian word images,
    zero-padded.  memoryview writes (plain memcpy) instead of per-packet
    np.frombuffer construction: ~2x on decode-side chunk prep."""
    B = len(packets)
    W4 = num_words * 4
    buf = bytearray(B * W4)
    mv = memoryview(buf)
    for i, p in enumerate(packets):
        if len(p) > W4:
            raise ValueError("packet larger than word image")
        mv[i * W4: i * W4 + len(p)] = p
    return np.frombuffer(buf, dtype=">u4").reshape(B, num_words).astype(
        np.uint32)
