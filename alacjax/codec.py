"""Batched device codec pipeline — the device-side ALACEncoder/ALACDecoder.

This is the performance path (SURVEY.md §7): whole batches of frames
encode/decode in parallel on one chip.  Per frame-lane it reproduces the
oracle bit-for-bit (tests assert byte-identical packets), with one
deliberate policy difference: the device encoder always runs in
*independent-frames* mode (predictor coefficient banks reset per packet,
matching ``ALACEncoder(config, independent_frames=True)``) so that packets
carry no cross-packet state and the whole stream is data-parallel.  The
bitstream stays fully standard — every packet transmits its own starting
coefficients.

Encode dataflow (one jit program per (B, S, config)):
  dilated mixres trial (10 stacked candidate streams, one fused
  predict+cost scan) -> full-rate dual-cost scan per order pricing both
  stage candidates -> per-channel argmin over order x stage ->
  closed-form absolute offsets for every segment -> headers as tiny
  token images, shift/escape blocks as phase-0 field packs funnel-
  shifted into place, Rice scans emitting phase-aligned word chunks ->
  per-element escape select -> sort-free radix-shuffle compaction +
  boundary-tail OR (merge_sorted_chunks) -> (B, W) word image -> host
  bytes.  No scatter, sort, or gather at any depth or layout.

Decode dataflow:
  host packet bytes -> (B, W) word image -> device header field reads ->
  Rice cursor scans (channels chained by end-position) -> predictor
  scans -> unmix/shift -> (B, C, S) PCM.  The production program
  compiles the 8-tap FIR walk only; lanes carrying 9..16- or 17..30-tap
  streams flag a per-lane error and re-decode through lazily compiled
  taps=16 / taps=30 programs (still device speed — the full legal
  5-bit order range).  Only frames outside the device grammar by
  policy (DSE/FIL elements, mismatched layouts, corruption) fall back
  to the scalar oracle on host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .oracle import ALACDecoder as OracleDecoder
from .oracle.encoder import (
    DEFAULT_MIX_BITS, FAST_MIX_RES, FAST_ORDER, MAX_RES, MIXRES_DILATE,
    PB_FACTOR, SEARCH_ORDERS, SEARCH_STAGES, bytes_shifted_for_depth,
)
from .oracle import dp as oracle_dp
from .ops import bitpack, fused_decode, matrix, predict, rice
from .ops.jaxutils import I32, U32, iota1, sign_extend
from .types import (
    DENSHIFT_DEFAULT, AlacConfig, AlacParamError, kALACMaxCoefs,
)

# frames per jit invocation (padded; 2 compiles/config).  The default
# dates from before the GPU port and has not been re-measured on the H100.
DEFAULT_CHUNK = 256


def _merge_radix() -> int:
    """Radix bits for merge_sorted_chunks' shuffle (lazy env read; see
    ops/predict.py on why trace-time)."""
    import os
    return int(os.environ.get("ALACJAX_MERGE_RADIX", "2"))


# ---------------------------------------------------------------------------
# token-building helpers (encode)
# ---------------------------------------------------------------------------
def _header23(tag, instance, bytes_shifted, escape):
    return (int(tag) << 20) | (instance << 16) | (bytes_shifted << 1) | int(escape)


def _chparam_token(order, mode):
    """(mode,denshift)<<8 | (pbFactor<<5|order) — per-lane order/mode."""
    return ((jnp.left_shift(mode.astype(U32), 4) | DENSHIFT_DEFAULT) << 8
            | jnp.uint32(PB_FACTOR << 5) | order.astype(U32))


def _coef_tokens(coefs, order):
    """(B,16) coef values + per-lane order -> 16 token slots."""
    B = coefs.shape[0]
    vals = coefs.astype(I32).astype(U32) & jnp.uint32(0xFFFF)
    ks = iota1(kALACMaxCoefs)[None, :]
    lens = jnp.where(ks < order[:, None], 16, 0).astype(I32)
    return vals, lens


def _interleave2(a, b):
    """(B,S),(B,S) -> (B,2S) interleaved a0,b0,a1,b1,..."""
    B, S = a.shape
    return jnp.stack([a, b], axis=-1).reshape(B, 2 * S)


def _rice_params_static(config: AlacConfig):
    pb = (config.pb * PB_FACTOR) // 4
    return config.mb, pb, config.kb, (1 << config.kb) - 1


def _init_coefs_batched(B):
    # built in-graph (iota + selects) rather than as a hoisted host constant
    vals = [int(v) for v in oracle_dp.init_coefs(DENSHIFT_DEFAULT)]
    ks = iota1(kALACMaxCoefs)
    row = jnp.zeros((kALACMaxCoefs,), I32)
    for i, v in enumerate(vals[:3]):
        row = jnp.where(ks == i, jnp.int32(v), row)
    return jnp.broadcast_to(row, (B, kALACMaxCoefs))


def _mixres_select(cpe_pairs, chanbits, config, nums=None):
    """Stereo-mode selection for ALL CPE elements of the packet in one
    stacked dilated trial (v2 dialect, mirrors oracle.encoder
    ._mixres_trial): mix every MIXRES_DILATE-th sample for each mixres
    0..4, run the fused predict+cost scan (order 8, fresh coefs) over
    all (n_cpe x 5 x 2) candidate streams at once, per-element argmin of
    the summed cost (first minimum wins).

    cpe_pairs: list of (l_hi, r_hi) tuples; chanbits: the (shared) CPE
    chanbits; nums: optional per-lane (B,) sample counts (partial / tail
    frames — the trial then costs ceil(num/dilate) dilated samples, the
    oracle's l_hi[:num:dilate] length).  Returns list of (B,) mixres
    selections.
    """
    B = cpe_pairs[0][0].shape[0]
    mb0, pb, kb, wb = _rice_params_static(config)
    # the side channel V = L - R is IDENTICAL for every mixres != 0
    # (matrix_enc.c mixes only U by mixres), so price it ONCE: 7 candidate
    # streams per CPE (L, R, U1..U4, V) instead of 10 — the trial scan is
    # lane-count-bound, so this is a ~30% cut at unchanged selections
    # (same per-candidate costs feed the same first-min argmin)
    n_cand = (MAX_RES + 1) + 2
    cand = []
    for l_hi, r_hi in cpe_pairs:
        ld = l_hi[:, ::MIXRES_DILATE]
        rd = r_hi[:, ::MIXRES_DILATE]
        cand.extend((ld.astype(I32), rd.astype(I32)))      # mixres 0: L, R
        for mr in range(1, MAX_RES + 1):
            u, _ = matrix.mix(ld, rd, DEFAULT_MIX_BITS, mr)
            cand.append(u)
        cand.append(ld.astype(I32) - rd.astype(I32))       # shared V
    st = jnp.concatenate(cand, axis=0)          # (n_cpe*7*B, nd)
    nd_lane = (None if nums is None else
               jnp.tile((nums + MIXRES_DILATE - 1) // MIXRES_DILATE,
                        len(cand)))
    with jax.named_scope("alacjax.mixres_trial"):
        _, c = predict.pc_block_cost(
            st, _init_coefs_batched(st.shape[0]), FAST_ORDER,
            chanbits, DENSHIFT_DEFAULT, mb0, pb, kb, wb, num=nd_lane)
    ce = c.reshape(len(cpe_pairs), n_cand, B)
    outs = []
    for e in range(len(cpe_pairs)):
        tot = jnp.stack(
            [ce[e, 0] + ce[e, 1]]                           # mixres 0
            + [ce[e, 1 + mr] + ce[e, n_cand - 1]            # U_mr + V
               for mr in range(1, MAX_RES + 1)], axis=0)
        outs.append(jnp.argmin(tot, axis=0).astype(I32))
    return outs


def _search_channels(streams, chanbits_list, config, banks=None, nums=None):
    """Per-channel (order x stage) candidate search for ALL channels of
    ALL elements in ONE dual-cost scan (v2 dialect):

    the scan runs over (orders x channels x B) stacked lanes with
    per-lane numactive and per-lane chanbits (SCE and CPE channels
    differ by one bit) — the scans are latency-bound on the per-sample
    dependency, so fewer sequential scans beats the masked-tap overhead.
    Candidate order (4,1),(4,2),(8,1),(8,2); first minimum wins.

    streams: list of (B, S) channel streams (post-mix, post-shift);
    chanbits_list: per-stream ints; banks: optional per-stream
    {order: (B, 16)} coefficient banks (persistent stream mode);
    nums: optional per-lane (B,) sample counts (partial / tail frames —
    the cost machines then price only the first num samples per lane).
    Returns per-channel lists (res, order, mode, rice_bits, coefs0_win,
    {order: adapted coefs}).
    """
    B = streams[0].shape[0]
    mb0, pb, kb, wb = _rice_params_static(config)
    fast = config.fast_mode
    orders = [FAST_ORDER] if fast else list(SEARCH_ORDERS)
    stages = [1] if fast else list(SEARCH_STAGES)
    init0 = _init_coefs_batched(B)
    W = len(streams)
    uniform_cb = len(set(chanbits_list)) == 1

    def c0_for(ci, od):
        return init0 if banks is None else banks[ci][od]

    xs = jnp.concatenate([s for _ in orders for s in streams], axis=0)
    c0s = jnp.concatenate([c0_for(ci, od) for od in orders
                           for ci in range(W)], axis=0)
    if uniform_cb:
        cb_all = chanbits_list[0]
    else:
        cb_lane = jnp.concatenate(
            [jnp.full((B,), cb, dtype=I32) for cb in chanbits_list], axis=0)
        cb_all = jnp.tile(cb_lane, len(orders))
    num_all = None if nums is None else jnp.tile(nums, len(orders) * W)
    with jax.named_scope("alacjax.predict_cost"):
        if len(orders) == 1 and stages == [1]:
            res_all, c1_all, coefs_all = predict.pc_block_cost_coefs(
                xs, c0s, orders[0], cb_all, DENSHIFT_DEFAULT,
                mb0, pb, kb, wb, num=num_all)
            c2_all = None
        else:
            na = jnp.concatenate(
                [jnp.full((W * B,), od, dtype=I32) for od in orders], axis=0)
            res_all, c1_all, c2_all, coefs_all = predict.pc_block_cost2(
                xs, c0s, na, cb_all, DENSHIFT_DEFAULT, mb0, pb, kb, wb,
                na_max=max(orders), num=num_all)

    res_list, order_list, mode_list = [], [], []
    rice_list, coefs0_list, adapted_list = [], [], []
    for ci in range(W):
        chanbits = chanbits_list[ci]
        cand_costs, cand_rice = [], []
        by_order, by_c0, by_adapt = {}, {}, {}
        for oi, od in enumerate(orders):
            sl = slice((oi * W + ci) * B, (oi * W + ci + 1) * B)
            by_order[od] = res_all[sl]
            by_c0[od] = c0_for(ci, od)
            by_adapt[od] = coefs_all[sl]
            rcosts = [c1_all[sl]] if c2_all is None else [c1_all[sl],
                                                          c2_all[sl]]
            for stg, rc in zip(stages, rcosts):
                cand_costs.append(16 + 16 * od + rc)
                cand_rice.append(rc)
        costs = jnp.stack(cand_costs, axis=0)           # (K, B)
        win = jnp.argmin(costs, axis=0)                 # first minimum wins
        rice_win = jnp.take_along_axis(
            jnp.stack(cand_rice, axis=0), win[None, :], axis=0)[0]
        order_win = jnp.full((B,), orders[0], dtype=I32)
        mode_win = jnp.zeros((B,), dtype=I32)
        for ki in range(len(cand_costs)):
            od, stg = orders[ki // len(stages)], stages[ki % len(stages)]
            hit = win == ki
            order_win = jnp.where(hit, od, order_win)
            # two-stage mode is written as 15 on the wire — the
            # reference encoder's value (third-party decoders like
            # libavcodec cascade ONLY on 15; any nonzero decodes as
            # cascade in ours/Apple's decoder)
            mode_win = jnp.where(hit, 0 if stg == 1 else 15, mode_win)
        res_win = by_order[orders[0]]
        coefs0_win = by_c0[orders[0]]
        for od in orders[1:]:
            sel = (order_win == od)[:, None]
            res_win = jnp.where(sel, by_order[od], res_win)
            coefs0_win = jnp.where(sel, by_c0[od], coefs0_win)
        if len(stages) > 1:
            res_win = jnp.where((mode_win != 0)[:, None],
                                predict.wrap_diff(res_win, chanbits), res_win)
        res_list.append(res_win)
        order_list.append(order_win)
        mode_list.append(mode_win)
        rice_list.append(rice_win)
        coefs0_list.append(coefs0_win)
        adapted_list.append(by_adapt)
    return (res_list, order_list, mode_list, rice_list,
            coefs0_list, adapted_list)


# ---------------------------------------------------------------------------
# scatter-free packet assembly: every depth / element layout as word chunks
# ---------------------------------------------------------------------------
def _segment_keys(base_word, n: int):
    """Absolute word keys base..base+n-1 for a placed segment (per lane)."""
    return base_word[:, None].astype(U32) + iota1(n, U32)[None, :]


def _emit_header(vals_list, lens_list, start_bits, cap_bits: int):
    """Assemble small header token streams at a per-lane absolute offset.

    A leading zero token of length (start & 31) phase-aligns the image;
    keys are (start >> 5) + iota.  Only COMPLETE words [start>>5, end>>5)
    keep real keys (the merge invariant: gapless unique coverage); the
    final partial word is returned separately as a tail to OR.

    Returns (words, keys, end_bits, tail_val, tail_key)."""
    B = start_bits.shape[0]
    phase = (start_bits & 31).astype(I32)
    vals = jnp.concatenate([jnp.zeros((B, 1), U32)] + vals_list, axis=1)
    lens = jnp.concatenate([phase[:, None]] + lens_list, axis=1)
    cap_words = (31 + cap_bits + 31) // 32
    words, img_bits = bitpack.assemble(vals, lens, cap_words)
    keys = _segment_keys(start_bits >> 5, cap_words)
    n_complete = (img_bits >> 5)[:, None]
    keys = jnp.where(iota1(cap_words, I32)[None, :] < n_complete, keys,
                     jnp.uint32(0xFFFFFFFF))
    # partial tail word at image position n_complete (gather-free select;
    # cap_words is small and static)
    has_tail = (img_bits & 31) > 0
    tail_val = jnp.zeros((B,), U32)
    for i in range(cap_words):
        tail_val = jnp.where(n_complete[:, 0] == i, words[:, i], tail_val)
    tail_val = jnp.where(has_tail, tail_val, 0)
    tail_key = ((start_bits >> 5) + (img_bits >> 5)).astype(U32)
    return words, keys, start_bits + img_bits - phase, tail_val, tail_key


def _emit_block(fields, d: int, start_bits):
    """Pack fixed-width fields and place them at per-lane bit offsets:
    phase-0 pack (no scatter) + per-lane funnel shift + word keys.
    Same complete-words-only key masking as _emit_header; the block bit
    length is STATIC, so the tail position takes one of two values.

    Returns (words, keys, end_bits, tail_val, tail_key)."""
    img = bitpack.pack_fields(fields, d)
    placed = bitpack.place_segment(img, (start_bits & 31).astype(U32))
    keys = _segment_keys(start_bits >> 5, placed.shape[1])
    nbits = fields.shape[1] * d
    phase = (start_bits & 31).astype(I32)
    n_complete = (phase + nbits) >> 5
    keys = jnp.where(iota1(placed.shape[1], I32)[None, :] < n_complete[:, None],
                     keys, jnp.uint32(0xFFFFFFFF))
    end = start_bits + nbits
    has_tail = (end & 31) > 0
    lo, hi = nbits >> 5, (31 + nbits) >> 5
    tail_val = jnp.where(n_complete == lo, placed[:, lo],
                         placed[:, hi] if hi < placed.shape[1]
                         else jnp.uint32(0))
    tail_val = jnp.where(has_tail, tail_val, 0)
    tail_key = ((start_bits >> 5) + n_complete).astype(U32)
    return placed, keys, end, tail_val, tail_key


def _emit_block_n(fields, d: int, start_bits, nf_lane):
    """_emit_block with a PER-LANE field count (partial / tail frames):
    lane b's block is its first nf_lane[b] fields.  Fields at index >=
    nf_lane[b] must already be zero (the caller masks), so the packed
    image is clean past each lane's end; keys beyond the per-lane
    complete-word count drop to the 0xFFFFFFFF sentinel and the boundary
    partial word comes from a one-word take_along_axis (per-lane tail
    position is data-dependent, unlike _emit_block's two-candidate
    select).

    Returns (words, keys, end_bits, tail_val, tail_key)."""
    img = bitpack.pack_fields(fields, d)
    placed = bitpack.place_segment(img, (start_bits & 31).astype(U32))
    W = placed.shape[1]
    keys = _segment_keys(start_bits >> 5, W)
    nbits = (nf_lane * d).astype(I32)
    phase = (start_bits & 31).astype(I32)
    n_complete = (phase + nbits) >> 5
    keys = jnp.where(iota1(W, I32)[None, :] < n_complete[:, None],
                     keys, jnp.uint32(0xFFFFFFFF))
    end = start_bits + nbits
    has_tail = (end & 31) > 0
    tail_val = jnp.take_along_axis(
        placed, jnp.clip(n_complete, 0, W - 1)[:, None], axis=1)[:, 0]
    tail_val = jnp.where(has_tail, tail_val, 0)
    tail_key = ((start_bits >> 5) + n_complete).astype(U32)
    return placed, keys, end, tail_val, tail_key


def _encode_packet_chunks(pcm, config: AlacConfig, num_words: int,
                          banks=None, nums=None):
    """Packet assembly without any large scatter, all configs.

    Every stream's absolute bit offset is computable before emission
    (header lengths are closed-form in the winning order; shift-byte
    blocks are fixed-size; per-channel Rice bit counts come out of the
    search; per-element escape decisions depend only on those sizes), so
    headers assemble as tiny token images, shift/escape blocks pack as
    phase-0 strided field blocks funnel-shifted into place, Rice scans
    emit phase-aligned word chunks directly, and a sort-free radix
    compaction merges all segments (ops/bitpack.merge_sorted_chunks).
    The reference writes all of this bit-serially
    (codec/ALACEncoder.cpp :: EncodeStereo).

    banks: optional {channel: {order: (B, 16)}} persistent coefficient
    banks; returns (words, total_bits, new_banks) with the oracle's
    commit rule (winning order's bank takes the adapted coefs unless the
    element escaped).  With banks=None, init coefs are used and new_banks
    is None (independent-frames mode).

    nums: optional per-lane (B,) sample counts (1 <= nums <= S) —
    partial (tail) frames batch with full frames (reference:
    ALACEncoder.cpp Encode partial-frame path).  Lanes with nums < S get
    the partial header flag + 32-bit numSamples field, per-lane-sized
    shift/escape blocks, and cost/emission machines capped at nums.
    Samples at index >= nums[b] must be zero (the host pads).  With
    banks, a partial lane's committed coefs reflect adaptation over all
    S padded samples (the oracle's stop at nums) — immaterial, because a
    tail is by construction the stream's LAST packet, so the committed
    values are never read; the PACKET bytes are oracle-identical."""
    B = pcm.shape[0]
    S = config.frame_length
    depth = config.bit_depth
    bs = bytes_shifted_for_depth(depth)
    mb0, pb, kb, wb = _rice_params_static(config)
    if nums is not None:
        nums = jnp.asarray(nums, I32)
        partial = nums < S
        pbits = jnp.where(partial, 32, 0).astype(I32)

    # ---- pass 1a: per-element prep (shift-off) ----
    elems = []
    ch = 0
    tag_counters = {}
    for tag, width in config.elements:
        instance = tag_counters.get(int(tag), 0)
        tag_counters[int(tag)] = instance + 1
        is_cpe = width == 2
        chanbits = depth - 8 * bs + (1 if is_cpe else 0)
        ch0 = ch
        chans = [pcm[:, ch + i, :] for i in range(width)]
        ch += width
        his, los = [], []
        for c in chans:
            hi, lo = matrix.shift_off(c, bs)
            his.append(hi)
            los.append(lo)
        elems.append(dict(
            tag=tag, instance=instance, width=width, is_cpe=is_cpe,
            chanbits=chanbits, chans=chans, his=his, los=los, ch0=ch0))

    exhaustive = config.search == "exhaustive" and not config.fast_mode
    if exhaustive and banks is not None:
        raise AlacParamError(
            "exhaustive device search is independent-frames only "
            "(persistent-bank stream encode uses the standard search; "
            "the stateful host encoders cover exhaustive+banks)")

    cpes = [e for e in elems if e["is_cpe"]]
    if exhaustive:
        # ---- exhaustive: ALL (mixres x order x stage) candidates of ALL
        # channels priced in the SAME stacked dual-cost scan the standard
        # path uses.  The scan is latency-bound, not lane-bound, so the
        # 5x lane widening costs far less than the 5x SERIAL full-rate
        # trials the host pays (reference: --search exhaustive =
        # EncodeStereo's kMaxRes loop at full rate, oracle/encoder.py
        # :: _encode_cpe mix_list branch).  The dilated mixres trial
        # pass disappears entirely.
        all_streams, all_cb = [], []
        for e in elems:
            if e["is_cpe"]:
                slots = []
                for mr in range(MAX_RES + 1):
                    u, v = matrix.mix(e["his"][0], e["his"][1],
                                      DEFAULT_MIX_BITS, mr)
                    slots.append(len(all_streams))
                    all_streams += [u, v]
                    all_cb += [e["chanbits"]] * 2
                e["slots"] = slots
            else:
                e["slots"] = [len(all_streams)]
                all_streams.append(e["his"][0])
                all_cb.append(e["chanbits"])
        (res_l, orders_l, modes_l, rice_l, coefs0_l, _adapted) = (
            _search_channels(all_streams, all_cb, config, nums=nums))
        for e in elems:
            e["adapted"] = None
            if not e["is_cpe"]:
                i0 = e["slots"][0]
                e["mixres_win"] = jnp.zeros((B,), dtype=I32)
                e["res_win"] = [res_l[i0]]
                e["orders_win"] = [orders_l[i0]]
                e["modes_win"] = [modes_l[i0]]
                e["rice_bits"] = [rice_l[i0]]
                e["coefs0_win"] = [coefs0_l[i0]]
                continue
            # per-mixres element cost = both channels' chparam + coef +
            # rice bits (shared fields are candidate-invariant — the
            # host's win_u.cost + win_v.cost comparison); strict < over
            # mixres 0..4 == argmin's first-minimum rule
            tot = jnp.stack(
                [sum(16 + 16 * orders_l[s + c] + rice_l[s + c]
                     for c in range(2)) for s in e["slots"]], axis=0)
            mr_win = jnp.argmin(tot, axis=0).astype(I32)
            e["mixres_win"] = mr_win

            def pick(by_mr, mr_win=mr_win):
                out = by_mr[0]
                for m in range(1, MAX_RES + 1):
                    hit = mr_win == m
                    sel = hit[:, None] if by_mr[m].ndim == 2 else hit
                    out = jnp.where(sel, by_mr[m], out)
                return out

            e["res_win"] = [pick([res_l[s + c] for s in e["slots"]])
                            for c in range(2)]
            e["orders_win"] = [pick([orders_l[s + c] for s in e["slots"]])
                               for c in range(2)]
            e["modes_win"] = [pick([modes_l[s + c] for s in e["slots"]])
                              for c in range(2)]
            e["rice_bits"] = [pick([rice_l[s + c] for s in e["slots"]])
                              for c in range(2)]
            e["coefs0_win"] = [pick([coefs0_l[s + c] for s in e["slots"]])
                               for c in range(2)]
    else:
        # ---- pass 1b: stereo mode for all CPEs, one stacked trial ----
        if config.fast_mode:
            for e in cpes:
                e["mixres_win"] = jnp.full((B,), FAST_MIX_RES, dtype=I32)
        elif cpes:
            sels = _mixres_select([(e["his"][0], e["his"][1]) for e in cpes],
                                  cpes[0]["chanbits"], config, nums=nums)
            for e, sel in zip(cpes, sels):
                e["mixres_win"] = sel
        for e in elems:
            if e["is_cpe"]:
                u, v = matrix.mix(e["his"][0], e["his"][1], DEFAULT_MIX_BITS,
                                  e["mixres_win"][:, None])
                e["streams"] = [u, v]
            else:
                e["mixres_win"] = jnp.zeros((B,), dtype=I32)
                e["streams"] = [e["his"][0]]

        # ---- pass 1c: ONE stacked search over every channel ----
        all_streams, all_cb, all_banks = [], [], []
        for e in elems:
            all_streams.extend(e["streams"])
            all_cb.extend([e["chanbits"]] * e["width"])
            if banks is not None:
                all_banks.extend(banks[e["ch0"] + i]
                                 for i in range(e["width"]))
        (res_l, orders_l, modes_l, rice_l, coefs0_l, adapted_l) = (
            _search_channels(all_streams, all_cb, config,
                             banks=all_banks if banks is not None else None,
                             nums=nums))
        ci0 = 0
        for e in elems:
            w = e["width"]
            sl = slice(ci0, ci0 + w)
            ci0 += w
            e["res_win"] = res_l[sl]
            e["orders_win"] = orders_l[sl]
            e["modes_win"] = modes_l[sl]
            e["rice_bits"] = rice_l[sl]
            e["coefs0_win"] = coefs0_l[sl]
            e["adapted"] = adapted_l[sl]

    # ---- shared: per-element header / escape sizing ----
    for e in elems:
        is_cpe, width = e["is_cpe"], e["width"]
        # +16: mixBits/mixRes are present in EVERY non-escape element
        # (mono writes 0,0) — reference grammar confirmed vs libavcodec
        # (tests/test_ffmpeg_interop.py)
        hdr_bits = (23 + 16 + width * 16
                    + 16 * sum(e["orders_win"]))
        if nums is None:
            shift_bits = width * S * 8 * bs
            esc_bits = 23 + width * S * depth
        else:
            # partial lanes carry a 32-bit numSamples field in BOTH
            # forms (it cancels in the comparison, like the 23-bit
            # header — oracle/encoder.py "compare bodies") and size
            # their sample blocks by nums
            hdr_bits = hdr_bits + pbits
            shift_bits = width * 8 * bs * nums
            esc_bits = 23 + pbits + width * depth * nums
        comp_bits = hdr_bits + shift_bits + sum(e["rice_bits"])
        use_escape = comp_bits >= esc_bits
        e["use_escape"] = use_escape
        e["elem_bits"] = jnp.where(use_escape, esc_bits, comp_bits)

    new_banks = None
    if banks is not None:
        # oracle commit rule: winning order's bank <- adapted coefs,
        # unless the element escaped; all other banks unchanged
        new_banks = dict(banks)
        for e in elems:
            for ci in range(e["width"]):
                chan = e["ch0"] + ci
                upd = dict(banks[chan])
                for od, coefs in e["adapted"][ci].items():
                    take = (~e["use_escape"]
                            & (e["orders_win"][ci] == od))[:, None]
                    upd[od] = jnp.where(take, coefs, banks[chan][od])
                new_banks[chan] = upd

    start = jnp.zeros((B,), dtype=I32)
    for e in elems:
        e["start"] = start
        start = start + e["elem_bits"]
    total_c = start

    # ---- pass 2a: ONE stacked Rice emission over every channel ----
    # (absolute start offsets are closed-form in the search results)
    rice_feed, rice_starts, rice_cb = [], [], []
    for e in elems:
        hdr_len = (23 + 16 + e["width"] * 16
                   + 16 * sum(e["orders_win"]))
        if nums is None:
            pos = e["start"] + hdr_len + e["width"] * S * 8 * bs
        else:
            pos = e["start"] + hdr_len + pbits + e["width"] * 8 * bs * nums
        for ci in range(e["width"]):
            rice_feed.append(e["res_win"][ci])
            rice_starts.append(pos)
            rice_cb.append(e["chanbits"])
            pos = pos + e["rice_bits"][ci]
    if len(set(rice_cb)) == 1:
        cb_arg = rice_cb[0]
    else:
        cb_arg = jnp.concatenate(
            [jnp.full((B,), cb, dtype=I32) for cb in rice_cb], axis=0)
    def emit_rice():
        return rice.rice_encode_words(
            jnp.concatenate(rice_feed, axis=0), cb_arg, mb0, pb, kb, wb,
            jnp.concatenate(rice_starts, axis=0), bit_size_cap=max(rice_cb),
            emit_flush=False,
            num=None if nums is None else jnp.tile(nums, len(rice_feed)))

    def skip_rice():
        # every lane of every element escaped (noise content): the Rice
        # streams are never selected — skip the S-step emission scan.
        # Empty-slot keys (0xFFFFFFFF) keep the merge invariant; the
        # escape select replaces all values/tails downstream.
        w, k, eb, tv, tk = jax.eval_shape(emit_rice)
        return (jnp.zeros(w.shape, U32),
                jnp.full(k.shape, 0xFFFFFFFF, U32),
                jnp.zeros(eb.shape, eb.dtype),
                jnp.zeros(tv.shape, U32),
                jnp.full(tk.shape, 0xFFFFFFFF, U32))

    any_comp = ~jnp.all(jnp.stack([e["use_escape"] for e in elems]))
    with jax.named_scope("alacjax.rice_words"):
        cw_all, ck_all, _, ctv_all, ctk_all = jax.lax.cond(
            any_comp, emit_rice, skip_rice)

    # ---- pass 2b: emission ----
    # Big chunk arrays carry only COMPLETE words (strictly increasing
    # keys, gapless coverage — the merge_sorted_chunks invariant); every
    # segment's final partial word is collected as a per-lane tail and
    # OR'd by the merger.
    def esc_stream_for(e):
        """Escape stream chunks for one element: 23-bit header (+32-bit
        numSamples on partial lanes) + raw samples at full depth.
        Packing the (B, width*S) raw fields + the pad/select costs
        several ms and is wasted on every batch where nothing escaped
        (typical music), so callers run this under a runtime cond."""
        is_cpe = e["is_cpe"]
        eh23 = jnp.full((B, 1),
                        _header23(e["tag"], e["instance"], 0, True),
                        dtype=U32)
        if nums is not None:
            eh23 = eh23 | (partial.astype(U32) << 3)[:, None]
        ehv = [eh23]
        ehl = [jnp.full((B, 1), 23, I32)]
        ecap = 23
        if nums is not None:
            ehv.append(nums.astype(U32)[:, None])
            ehl.append(pbits[:, None])
            ecap += 32
        ew, ek, epos, etv, etk = _emit_header(ehv, ehl, e["start"], ecap)
        raw = (_interleave2(e["chans"][0], e["chans"][1]) if is_cpe
               else e["chans"][0])
        if nums is None:
            rw, rk, _, rtv, rtk = _emit_block(raw.astype(U32), depth,
                                              epos)
        else:
            nf = e["width"] * nums
            raw = jnp.where(
                iota1(raw.shape[1])[None, :] < nf[:, None], raw, 0)
            rw, rk, _, rtv, rtk = _emit_block_n(raw.astype(U32), depth,
                                                epos, nf)
        return (jnp.concatenate([ew, rw], axis=1),
                jnp.concatenate([ek, rk], axis=1),
                (etv, rtv), (etk, rtk))

    def mixed_chunks():
        """Per-element chunk assembly for the general (some lane
        compressed) case: compressed stream chunks, per-element escape
        select under a cond."""
        all_vals, all_keys = [], []
        tail_v, tail_k = [], []
        rci = 0
        for e in elems:
            width, is_cpe = e["width"], e["is_cpe"]
            # compressed stream: header tokens (partial lanes: flag bit 3
            # of the 23-bit header + a 32-bit numSamples token,
            # zero-length on full lanes — assemble() skips L=0 tokens)
            h23 = jnp.full((B, 1),
                           _header23(e["tag"], e["instance"], bs, False),
                           dtype=U32)
            if nums is not None:
                h23 = h23 | (partial.astype(U32) << 3)[:, None]
            hv = [h23]
            hl = [jnp.full((B, 1), 23, I32)]
            if nums is not None:
                hv.append(nums.astype(U32)[:, None])
                hl.append(pbits[:, None])
            if is_cpe:
                mixtok = (jnp.uint32(DEFAULT_MIX_BITS << 8)
                          | (e["mixres_win"].astype(U32) & 0xFF))
                hv.append(mixtok[:, None])
                hl.append(jnp.full((B, 1), 16, I32))
            else:
                # mono: mixBits/mixRes written as (0, 0) — present in
                # every non-escape element per the reference grammar
                hv.append(jnp.zeros((B, 1), U32))
                hl.append(jnp.full((B, 1), 16, I32))
            for ci in range(width):
                hv.append(_chparam_token(e["orders_win"][ci],
                                         e["modes_win"][ci])[:, None])
                hl.append(jnp.full((B, 1), 16, I32))
                cv, cl = _coef_tokens(e["coefs0_win"][ci],
                                      e["orders_win"][ci])
                hv.append(cv); hl.append(cl)
            cap = (23 + (0 if nums is None else 32) + 16
                   + width * (16 + 16 * kALACMaxCoefs))
            hw, hk, pos, htv, htk = _emit_header(hv, hl, e["start"], cap)
            seg_v, seg_k = [hw], [hk]
            tv_c, tk_c = [htv], [htk]

            # shift-byte block (interleaved per sample/channel)
            if bs:
                sh = (_interleave2(e["los"][0], e["los"][1]) if is_cpe
                      else e["los"][0])
                if nums is None:
                    bw, bk, pos, btv, btk = _emit_block(sh.astype(U32),
                                                        8 * bs, pos)
                else:
                    nf = width * nums
                    sh = jnp.where(
                        iota1(sh.shape[1])[None, :] < nf[:, None], sh, 0)
                    bw, bk, pos, btv, btk = _emit_block_n(sh.astype(U32),
                                                          8 * bs, pos, nf)
                seg_v.append(bw); seg_k.append(bk)
                tv_c.append(btv); tk_c.append(btk)

            # Rice chunk streams for this element (stacked emission)
            for _ in range(width):
                seg_v.append(cw_all[rci * B:(rci + 1) * B])
                seg_k.append(ck_all[rci * B:(rci + 1) * B])
                tv_c.append(ctv_all[rci * B:(rci + 1) * B])
                tk_c.append(ctk_all[rci * B:(rci + 1) * B])
                rci += 1
            vals_c = jnp.concatenate(seg_v, axis=1)
            keys_c = jnp.concatenate(seg_k, axis=1)

            Te = jax.eval_shape(lambda: esc_stream_for(e))[0].shape[1]
            T_el = max(vals_c.shape[1], Te)
            n_t = len(tv_c)
            ue = e["use_escape"][:, None]
            ue1 = e["use_escape"]

            def pad_to(v, k, T):
                return (jnp.pad(v, ((0, 0), (0, T - v.shape[1]))),
                        jnp.pad(k, ((0, 0), (0, T - k.shape[1])),
                                constant_values=np.uint32(0xFFFFFFFF)))

            def with_escape(e=e, vals_c=vals_c, keys_c=keys_c, tv_c=tv_c,
                            tk_c=tk_c, T_el=T_el, n_t=n_t, ue=ue, ue1=ue1):
                vals_e, keys_e, tv_e, tk_e = esc_stream_for(e)
                vc, kc = pad_to(vals_c, keys_c, T_el)
                ve, ke = pad_to(vals_e, keys_e, T_el)
                tv_e = list(tv_e) + [jnp.zeros((B,), U32)] * (n_t - 2)
                tk_e = (list(tk_e)
                        + [jnp.full((B,), 0xFFFFFFFF, U32)] * (n_t - 2))
                tv = [jnp.where(ue1, b, a) for a, b in zip(tv_c, tv_e)]
                tk = [jnp.where(ue1, b, a) for a, b in zip(tk_c, tk_e)]
                return (jnp.where(ue, ve, vc), jnp.where(ue, ke, kc),
                        jnp.stack(tv), jnp.stack(tk))

            def without_escape(vals_c=vals_c, keys_c=keys_c, tv_c=tv_c,
                               tk_c=tk_c, T_el=T_el):
                vc, kc = pad_to(vals_c, keys_c, T_el)
                return vc, kc, jnp.stack(tv_c), jnp.stack(tk_c)

            av, ak, tvs, tks = jax.lax.cond(
                jnp.any(ue1), with_escape, without_escape)
            all_vals.append(av)
            all_keys.append(ak)
            tail_v.extend(tvs[i] for i in range(n_t))
            tail_k.extend(tks[i] for i in range(n_t))
        return (jnp.concatenate(all_vals, axis=1),
                jnp.concatenate(all_keys, axis=1), tail_v, tail_k)

    # ---- END tag (3 bits) at the known end position: pure tails ----
    phase = (total_c & 31).astype(U32)
    end_hi = jnp.right_shift(jnp.uint32(7 << 29), phase)
    end_lo = jnp.where(phase > 29,
                       jnp.left_shift(jnp.uint32(7), (61 - phase) % 32),
                       jnp.uint32(0))
    end_tv = [end_hi, end_lo]
    end_tk = [(total_c >> 5).astype(U32),
              jnp.where(phase > 29, ((total_c >> 5) + 1).astype(U32),
                        jnp.uint32(0xFFFFFFFF))]
    total_bits = total_c + 3  # byte-align pad bits are zeros: no emission

    def assemble_mixed():
        vals, keys, tail_v, tail_k = mixed_chunks()
        with jax.named_scope("alacjax.merge_chunks"):
            return bitpack.merge_sorted_chunks(
                vals, keys, jnp.stack(tail_v + end_tv, axis=1),
                jnp.stack(tail_k + end_tk, axis=1),
                num_words, radix_bits=_merge_radix())

    def assemble_all_escape():
        """Every lane of every element escaped (noise content): the
        packet is header+raw blocks at closed-form offsets.  Full-frame
        batches place each element's packed raw image at its STATIC bit
        offset — no chunk merge at all (the radix shuffle over the
        ~3x-wider rice chunk arrays is the dominant assembly cost on
        all-escape content).  Partial batches (per-lane offsets) merge
        escape chunks only."""
        if nums is None:
            row = np.zeros((num_words,), np.uint64)

            def or_static(row, val, nbits, pos):
                w, ph = pos >> 5, pos & 31
                v64 = (val & ((1 << nbits) - 1)) << (64 - ph - nbits)
                if w < num_words:
                    row[w] |= v64 >> 32
                if ph + nbits > 32 and w + 1 < num_words:
                    row[w + 1] |= v64 & 0xFFFFFFFF

            out = jnp.zeros((B, num_words), U32)
            pos = 0
            for e in elems:
                or_static(row, _header23(e["tag"], e["instance"], 0, True),
                          23, pos)
                raw = (_interleave2(e["chans"][0], e["chans"][1])
                       if e["is_cpe"] else e["chans"][0])
                img = bitpack.pack_fields(raw.astype(U32), depth)
                p0 = pos + 23
                placed = bitpack.place_segment(
                    img, jnp.full((B,), p0 & 31, U32))
                w0 = p0 >> 5
                Wp = min(placed.shape[1], num_words - w0)
                out = out | jnp.pad(placed[:, :Wp],
                                    ((0, 0), (w0, num_words - w0 - Wp)))
                pos = p0 + e["width"] * depth * S
            or_static(row, 0b111, 3, pos)
            return out | jnp.asarray(row.astype(np.uint32))[None, :]

        av, ak, tv, tk = [], [], [], []
        for e in elems:
            ev, ek, (etv, rtv), (etk, rtk) = esc_stream_for(e)
            av.append(ev); ak.append(ek)
            tv += [etv, rtv]; tk += [etk, rtk]
        return bitpack.merge_sorted_chunks(
            jnp.concatenate(av, axis=1), jnp.concatenate(ak, axis=1),
            jnp.stack(tv + end_tv, axis=1), jnp.stack(tk + end_tk, axis=1),
            num_words, radix_bits=_merge_radix())

    with jax.named_scope("alacjax.assemble"):
        words = jax.lax.cond(~any_comp, assemble_all_escape, assemble_mixed)
    return words, total_bits, new_banks


@functools.partial(jax.jit, static_argnames=("config", "num_words"))
def encode_frames_jit(pcm, config: AlacConfig, num_words: int):
    """Single module-level jit entry for encode (static config).

    One jit instance for the whole process: per-codec jit wrappers around
    fresh functools.partial objects intermittently dispatched the WRONG
    executable in long multi-config runs ("Execution supplied 1 buffers
    but compiled program expected 3") — an executable-identity hazard this
    layout avoids.
    """
    return encode_frames_device(pcm, config=config, num_words=num_words)


@functools.partial(jax.jit, static_argnames=("config", "num_samples", "taps"))
def decode_frames_jit(words, config: AlacConfig, num_samples: int,
                      taps: int | None = 8):
    """Single module-level jit entry for decode (static config)."""
    return decode_frames_device(words, config=config,
                                num_samples=num_samples, taps=taps)


@functools.partial(jax.jit, static_argnames=("config", "num_words"))
def encode_stream_jit(pcm, config: AlacConfig, num_words: int):
    """Jit entry for the persistent-bank stream encoder."""
    return encode_stream_device(pcm, config=config, num_words=num_words)


def encode_streams(pcm: np.ndarray, config: AlacConfig) -> list[list[bytes]]:
    """Host API: (B, N, C, S) planar streams -> per-stream packet lists,
    byte-identical to the stateful ALACEncoder(config) on each stream."""
    from .ops import bitpack
    S = config.frame_length
    num_words = (config.max_escape_packet_bytes(S) + 3) // 4 + 2
    words, bits = encode_stream_jit(
        jnp.asarray(np.asarray(pcm, dtype=np.int32)), config, num_words)
    words, bits = np.asarray(words), np.asarray(bits)
    return [bitpack.words_to_bytes(words[b], bits[b])
            for b in range(words.shape[0])]


def encode_frames_device(pcm, config: AlacConfig, num_words: int):
    """Jit core: (B, C, S) planar int32 -> ((B, W) words, (B,) total_bits)."""
    words, total_bits, _ = _encode_packet_chunks(pcm, config, num_words)
    return words, total_bits


def encode_stream_device(pcm, config: AlacConfig, num_words: int):
    """Persistent-coefficient stream encode at device speed
    (reference: ALACEncoder.cpp mCoefsU/V members surviving across
    packets).

    (B, N, C, S) planar int32 — B independent streams of N packets each —
    scanned over the packet axis with the coefficient banks as carry, so
    packets within a stream chain exactly like the stateful host encoders
    while streams stay data-parallel.  Returns ((B, N, W), (B, N)).
    """
    B = pcm.shape[0]
    orders = [FAST_ORDER] if config.fast_mode else list(SEARCH_ORDERS)
    init0 = _init_coefs_batched(B)
    banks0 = {ch: {od: init0 for od in orders}
              for ch in range(config.num_channels)}

    def step(banks, pcm_t):
        words, bits, new_banks = _encode_packet_chunks(
            pcm_t, config, num_words, banks=banks)
        return new_banks, (words, bits)

    # scan over packets (time-major)
    pcm_t = jnp.swapaxes(pcm, 0, 1)  # (N, B, C, S)
    _, (words, bits) = jax.lax.scan(step, banks0, pcm_t)
    return jnp.swapaxes(words, 0, 1), jnp.swapaxes(bits, 0, 1)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _sfield(words, off: int, n: int):
    """(B,) n-bit field at a STATIC bit offset: pure column slices and
    constant shifts — no gather.  Usable whenever the element is bit-0
    aligned in its view: single-element packets directly, later elements
    via an extract_segment-aligned window."""
    i, ph = off >> 5, off & 31
    a = words[:, i]
    if ph + n > 32:
        a = jnp.left_shift(a, ph) | jnp.right_shift(words[:, i + 1], 32 - ph)
        return jnp.right_shift(a, 32 - n)
    return jnp.right_shift(a, 32 - ph - n) & jnp.uint32((1 << n) - 1)


def _parse_ph(ph, max_ord: int = kALACMaxCoefs):
    """Split a 16-bit channel-param header into (mode, den, pbf, order).

    max_ord: largest order this program's parse/scan supports (16 for
    the standard programs, 30 for the lazy high-order retry — the
    5-bit field's full legal range, reference: ALACDecoder.cpp reads
    up to 31 coefs)."""
    mode = (ph >> 12).astype(I32) & 0xF
    den = ((ph >> 8) & 0xF).astype(I32)
    pbf = ((ph >> 5) & 0x7).astype(I32)
    order = (ph & 0x1F).astype(I32)
    perr = ((order > max_ord) & (order != 31)) | (
        (den == 0) & (order != 0) & (order != 31))
    return (mode, den, pbf, order), perr


def _decode_params_static(words, is_cpe: bool,
                          max_ord: int = kALACMaxCoefs):
    """Header/param parse on a bit-0-aligned element view, WITHOUT
    gathers.  Single-element packets pass the word image (optionally
    partial-shifted); later elements of multichannel layouts pass an
    extract_segment-aligned window, so EVERY layout parses this way.

    The element header, mix token, and channel-0 params sit at static
    bit offsets; channel 1's offset depends only on order0 (5 bits, 18
    legal values), so its 17 fields come from a static 16-bit-stride
    field table selected per lane by order0 — ~300 cheap (B,) selects
    replace per-lane gathers.  max_ord widens the accepted order
    range and the coef tables (30 for the lazy high-order retry
    program).  Returns (params list, end bits relative to the element
    start sans the partial numSamples field, err)."""
    # +16: mixBits/mixRes precede the channel params in EVERY
    # non-escape element (mono: written as 0,0 and ignored)
    c_ph0 = 23 + 16
    # deepest static read: ch1's field table at order0 up to 31
    deep = c_ph0 + 16 + 16 * ((31 + max_ord if is_cpe else max_ord) + 1)
    need = deep // 32 + 2
    if words.shape[1] < need:
        words = jnp.pad(words, ((0, 0), (0, need - words.shape[1])))
    ph0 = _sfield(words, c_ph0, 16)
    (mode0, den0, pbf0, order0), perr = _parse_ph(ph0, max_ord)
    coefs0 = sign_extend(jnp.stack(
        [_sfield(words, c_ph0 + 16 + 16 * j, 16)
         for j in range(max_ord)], axis=1).astype(I32), 16)
    params = [(mode0, den0, pbf0, order0, coefs0)]
    end = c_ph0 + 16 + 16 * order0
    if is_cpe:
        # field table H[m] = 16 bits at c_ph0+16+16m; ph1 = H[order0],
        # coefs1[j] = H[order0+1+j] (order0 <= max_ord, or the 31-tap
        # mode)
        o_vals = list(range(max_ord + 1)) + [31]
        H = [_sfield(words, c_ph0 + 16 + 16 * m, 16)
             for m in range(max(o_vals) + 1 + max_ord + 1)]

        def sel(fn):
            out = fn(o_vals[0])
            for ov in o_vals[1:]:
                out = jnp.where(order0 == ov, fn(ov), out)
            return out

        ph1 = sel(lambda ov: H[ov])
        (mode1, den1, pbf1, order1), perr1 = _parse_ph(ph1, max_ord)
        perr = perr | perr1
        coefs1 = sign_extend(jnp.stack(
            [sel(lambda ov, j=j: H[ov + 1 + j])
             for j in range(max_ord)], axis=1).astype(I32), 16)
        params.append((mode1, den1, pbf1, order1, coefs1))
        end = end + 16 + 16 * order1
    return params, end, perr


def _unescape_fast(words, depth: int, nch: int, S: int, partial):
    """Escape-sample extraction for single-element packets at ANY depth:
    the raw block sits at static bit 23 (55 on partial lanes — exactly
    one word later at the same phase), so a per-lane word-shifted view +
    a CONSTANT funnel shift brings it to phase 0 and unpack_fields
    slices the periodic field layout — no gather (the inverse of the
    encoder's pack_fields escape image).

    Returns list of nch (B, S) int32 channel arrays."""
    F = nch * S
    Wout = (depth * F + 31) // 32
    need = Wout + 2  # +1 funnel spill, +1 partial word shift
    W = words.shape[1]
    wp = words if W >= need else jnp.pad(words, ((0, 0), (0, need - W)))
    w0 = jnp.where(partial[:, None], wp[:, 1:need], wp[:, :need - 1])
    al = jnp.left_shift(w0[:, :-1], 23) | jnp.right_shift(w0[:, 1:], 9)
    f = sign_extend(bitpack.unpack_fields(al, depth, F).astype(I32), depth)
    return [f[:, ci::nch] for ci in range(nch)]


def _unescape_window(words, pos_esc, depth: int, nch: int, S: int):
    """Escape-sample extraction at a per-lane dynamic offset (multi-
    element layouts): ONE word-window gather aligned to phase 0, then
    the same periodic unpack — ~depth/32 loads per sample instead of
    _peek32's 2."""
    F = nch * S
    seg = bitpack.extract_segment(words, pos_esc, (depth * F + 31) // 32)
    f = sign_extend(bitpack.unpack_fields(seg, depth, F).astype(I32), depth)
    return [f[:, ci::nch] for ci in range(nch)]


def _stacked_decode() -> bool:
    """Whether decode runs the cursor+stacked two-pass: a cheap
    Rice-cursor scan per channel breaks the cross-channel chain, then
    ONE stacked fused scan reconstructs every channel.  Off by default:
    it lost to the chained scans at every layout before the GPU port
    (the cursor scans pay the full window-fetch and refill per sample)
    and has not been measured on the H100.  ALACJAX_DECODE_STACKED=1
    opts in (bit-identical, kept tested)."""
    import os
    return os.environ.get("ALACJAX_DECODE_STACKED") == "1"


def _decode_g(n_chan_total: int) -> int | None:
    """Per-layout default for the decode scans' substeps-per-step (G).

    Stereo/mono keep G=8; multichannel layouts (>= 3 chained scans)
    default to G=16, which halves the step count of six serial scans at
    the price of a larger step body.  Both defaults date from before the
    GPU port and have not been re-measured on the H100.  ALACJAX_DECODE_G
    overrides everywhere (tests pin G=2 for CPU compile time)."""
    return 16 if n_chan_total >= 3 else None


def decode_frames_device(words, config: AlacConfig, num_samples: int,
                         taps: int | None = 8):
    """Jit core: (B, W) word image -> ((B, C, S) pcm, (B,) err flags).

    taps statically specializes the fused scan's FIR body and the
    header parse's order bound (see fused_decode.decode_channel): the
    production program compiles ONLY the 8-tap walk; lanes carrying
    higher-order streams flag err and the host re-runs them through a
    lazily compiled taps=16 (then taps=30 — the 5-bit field's full
    legal range, reference: ALACDecoder.cpp 32-wide coef buffers)
    program (JaxCodec.decode_frames_ex) — so EVERY legal order decodes
    at device speed while the common program stays small.

    Channels decode as chained fused scans (channel c+1's stream
    starts where channel c's ends), exactly like the reference's
    serial element loop (codec/ALACDecoder.cpp :: Decode) but batched
    across lanes.  Multichannel layouts run the scans at G=16
    substeps/step (_decode_g).  An alternative cursor+stacked two-pass
    (break the chain with cheap Rice-cursor scans, then ONE stacked
    fused scan over all channels) is opt-in (_stacked_decode)."""
    B = words.shape[0]
    S = num_samples
    depth = config.bit_depth
    mb0 = config.mb
    kb = config.kb
    wb = (1 << kb) - 1

    n_chan_total = sum(w for _, w in config.elements)
    stacked = _stacked_decode()
    elems_meta = []     # stacked mode: per-element post-scan work
    chan_entries = []   # stacked mode: per-channel scan inputs
    ch_seen = 0

    out_ch = []
    bitpos = jnp.zeros((B,), dtype=I32)
    err = jnp.zeros((B,), dtype=bool)
    num = None  # per-lane decoded sample count (partial/tail frames)
    # the parse accepts orders up to the compiled walk's width (never
    # below 16: the taps=8 program still parses 9..16-tap headers so
    # those lanes err cleanly instead of desyncing)
    max_ord = max(kALACMaxCoefs, taps if taps is not None else 0)

    # single-element packets start at bit 0: every header field is at a
    # static (or order0-determined) offset — parse without gathers
    fast_hdr = len(config.elements) == 1

    for tag, width in config.elements:
        is_cpe = width == 2
        hdr = (_sfield(words, 0, 23) if fast_hdr
               else rice._read_bits(words, bitpos, 23))
        rtag = (hdr >> 20).astype(I32)
        unused = (hdr >> 4) & 0xFFF
        partial = ((hdr >> 3) & 1).astype(bool)
        bs_f = ((hdr >> 1) & 3).astype(I32)
        esc = (hdr & 1).astype(bool)
        # bytesShifted is depth-determined for every known encoder; frames
        # deviating from it fall back to the oracle (via the error flag),
        # which makes bs/chanbits STATIC: no zero-width shift gathers, and
        # the Rice escape width becomes a compile-time scalar.
        bs = bytes_shifted_for_depth(depth)
        err = (err | (rtag != int(tag)) | (unused != 0)
               | (~esc & (bs_f != bs)) | (esc & (bs_f != 0)))

        # partial (tail) frames: 32-bit numSamples right after the header
        # (reference: ALACDecoder.cpp partialFrame path); decoded with a
        # per-lane sample-count mask so tails batch with full frames
        nsf = (_sfield(words, 23, 32) if fast_hdr
               else rice._read_bits(words, bitpos + 23, 32))
        bad_num = partial & ((nsf == 0) | (nsf > jnp.uint32(S)))
        num_el = jnp.where(partial & ~bad_num, nsf.astype(I32), S)
        err = err | bad_num
        if num is None:
            num = num_el
        else:  # elements of one packet must agree on the frame length
            err = err | (num_el != num)
        partial_bits = jnp.where(partial, 32, 0)
        bitpos = bitpos + 23 + partial_bits
        pos_esc = bitpos

        if fast_hdr:
            # shifted header view: partial lanes' fields sit exactly one
            # word later (32-bit numSamples), so the static parse reads
            # from a per-lane selected 60-column window
            ncol = 61
            wpad = (words if words.shape[1] >= ncol + 1 else
                    jnp.pad(words, ((0, 0), (0, ncol + 1 - words.shape[1]))))
            w_hdr = jnp.where(partial[:, None], wpad[:, 1:ncol + 1],
                              wpad[:, :ncol])
        else:
            # later elements start at a per-lane dynamic offset: ONE
            # window gather aligns the element (sans the partial field)
            # to bit 0 and the SAME gather-free static parse applies —
            # replaces per-channel per-field _peek32 gathers
            deep = 39 + 16 + 16 * ((31 + max_ord if is_cpe else max_ord)
                                   + 1)
            w_hdr = bitpack.extract_segment(words, pos_esc - 23,
                                            deep // 32 + 2)

        chanbits = depth - 8 * bs + (1 if is_cpe else 0)

        if is_cpe:
            mixtok = _sfield(w_hdr, 23, 16)
            mixbits_f = (mixtok >> 8).astype(I32)
            mixres_f = sign_extend((mixtok & 0xFF).astype(I32), 8)
            bitpos = bitpos + jnp.where(esc, 0, 16)
            # escape lanes: neutralize header-dependent values
            mixbits_f = jnp.where(esc, 0, mixbits_f)
            mixres_f = jnp.where(esc, 0, mixres_f)
        else:
            # mono elements carry the 16 mixBits/mixRes bits too (0,0
            # from every known encoder) — skip blind, like the reference
            bitpos = bitpos + jnp.where(esc, 0, 16)

        params, end_rel, perr = _decode_params_static(
            w_hdr, is_cpe, max_ord)
        err = err | (~esc & perr)
        # end_rel is relative to the element start sans the partial
        # numSamples field == window bit 0 == pos_esc - 23
        bitpos = jnp.where(esc, pos_esc, pos_esc - 23 + end_rel)

        pos_shift = bitpos
        shift_bits_total = width * 8 * bs * num
        bitpos = bitpos + jnp.where(esc, 0, shift_bits_total)

        all_esc = jnp.all(esc)

        if stacked:
            # ---- pass A (stacked mode): cursor chaining only ----
            for ci in range(width):
                mode, den, pbf, order, coefs = params[ci]
                pb_lane = (config.pb * pbf) // 4
                # escape lanes carry garbage header fields (their decode
                # is masked out); normalize the order so they can't flag
                # the compiled taps bound
                order = jnp.where(esc, 0, order)
                chan_entries.append(dict(
                    start=bitpos, cb=chanbits, pb=pb_lane, coefs=coefs,
                    mode=mode, order=order, den=den, esc=esc))
                ch_seen += 1
                if ch_seen < n_chan_total:
                    # cursor pass finds the NEXT channel's start (the
                    # final channel's end is unused)
                    def run_cursor(bitpos=bitpos, pb_lane=pb_lane,
                                   esc=esc, chanbits=chanbits):
                        return fused_decode.cursor_scan(
                            words, bitpos, S, chanbits, mb0, pb_lane,
                            kb, wb, skip=esc, num=num,
                            g=_decode_g(n_chan_total))
                    with jax.named_scope("alacjax.cursor"):
                        end, cerr = jax.lax.cond(
                            all_esc,
                            lambda bitpos=bitpos: (
                                bitpos, jnp.zeros((B,), bool)),
                            run_cursor)
                    err = err | (~esc & cerr)
                    bitpos = jnp.where(esc, bitpos, end)
            esc_end = pos_esc + width * depth * num
            bitpos = jnp.where(esc, esc_end, bitpos)
            elems_meta.append(dict(
                width=width, is_cpe=is_cpe, esc=esc, all_esc=all_esc,
                pos_esc=pos_esc, pos_shift=pos_shift, partial=partial,
                mixbits=mixbits_f if is_cpe else None,
                mixres=mixres_f if is_cpe else None))
            continue

        def run_scans(bitpos=bitpos):
            outs = []
            rerr_acc = jnp.zeros((B,), bool)
            for ci in range(width):
                mode, den, pbf, order, coefs = params[ci]
                pb_lane = (config.pb * pbf) // 4
                # escape lanes carry garbage header fields (their decode
                # is masked out); normalize the order so they can't
                # force the fused scan off its order<=8 fast branch
                order = jnp.where(esc, 0, order)
                with jax.named_scope("alacjax.fused_decode"):
                    samples, bitpos_n, rerr = (
                        fused_decode.decode_channel_cached(
                            words, bitpos, S, chanbits, mb0, pb_lane,
                            kb, wb, coefs, mode, order, den, taps=taps,
                            num=num, g=_decode_g(n_chan_total)))
                bitpos = jnp.where(esc, bitpos, bitpos_n)
                rerr_acc = rerr_acc | (~esc & rerr)
                outs.append(samples)
            return tuple(outs) + (bitpos, rerr_acc)

        def skip_scans():
            return tuple(jnp.zeros((B, S), I32) for _ in range(width)) + (
                bitpos, jnp.zeros((B,), bool))

        # Shift side-channel re-insert + unmix ride INSIDE the same
        # all-escape cond as the scans (no extra dispatch): all-escape
        # batches (noise) skip the shift-block window+unpack and the
        # unmix entirely.  The block is contiguous
        # (channel-interleaved 8*bs-bit fields), so ONE phase-aligned
        # window + periodic unpack replaces the per-sample-per-channel
        # _peek32 gathers.
        def comp_side():
            r = run_scans()
            recon = r[:width]
            if bs:
                d = 8 * bs
                seg = bitpack.extract_segment(
                    words, pos_shift, (width * S * d + 31) // 32)
                sf = bitpack.unpack_fields(seg, d, width * S).astype(I32)
                sfv = sf.reshape(B, S, width)
                shifts = [sfv[:, :, ci] for ci in range(width)]
            else:
                shifts = [jnp.zeros((B, S), I32)] * width
            if is_cpe:
                l, rr = matrix.unmix(recon[0], recon[1],
                                     mixbits_f[:, None], mixres_f[:, None])
                dec = (matrix.shift_in(l, shifts[0], bs),
                       matrix.shift_in(rr, shifts[1], bs))
            else:
                dec = (matrix.shift_in(recon[0], shifts[0], bs),)
            return dec + (r[width], r[width + 1])

        res_t = jax.lax.cond(all_esc, skip_scans, comp_side)
        dec = list(res_t[:width])
        bitpos = res_t[width]
        err = err | res_t[width + 1]

        # escape lanes: raw samples at static stride from pos_esc
        esc_end = pos_esc + width * depth * num
        def with_unesc():
            if fast_hdr:
                # single element: the raw block's offset is static (23,
                # +1 word on partial lanes) at every depth
                raws = _unescape_fast(words, depth, width, S, partial)
            else:
                raws = _unescape_window(words, pos_esc, depth, width, S)
            return tuple(jnp.where(esc[:, None], raws[ci], dec[ci])
                         for ci in range(width))

        # raw-sample extraction only matters if some lane escaped
        out_ch.extend(jax.lax.cond(jnp.any(esc), with_unesc,
                                   lambda: tuple(dec)))
        bitpos = jnp.where(esc, esc_end, bitpos)

    if stacked:
        # ---- pass B: ONE stacked fused scan for every channel ----
        bs = bytes_shifted_for_depth(depth)
        cb_list = [e["cb"] for e in chan_entries]
        cb_max = max(cb_list)
        cb_arg = (cb_list[0] if len(set(cb_list)) == 1 else
                  jnp.concatenate([jnp.full((B,), cb, dtype=I32)
                                   for cb in cb_list], axis=0))

        def cat(k):
            return jnp.concatenate([e[k] for e in chan_entries], axis=0)

        esc_all = cat("esc")
        L = n_chan_total * B
        words_rep = (words if n_chan_total == 1 else
                     jnp.concatenate([words] * n_chan_total, axis=0))
        num_rep = jnp.tile(num, n_chan_total)

        def run_stacked():
            with jax.named_scope("alacjax.fused_decode_stacked"):
                samples, _, rerr = fused_decode.decode_channel(
                    words_rep, cat("start"), S, cb_arg, mb0, cat("pb"),
                    kb, wb, cat("coefs"), cat("mode"), cat("order"),
                    cat("den"), chanbits_max=cb_max, taps=taps,
                    num=num_rep, g=_decode_g(n_chan_total))
            return samples, rerr

        samples_all, rerr_all = jax.lax.cond(
            jnp.all(esc_all),
            lambda: (jnp.zeros((L, S), I32), jnp.zeros((L,), bool)),
            run_stacked)
        err = err | jnp.any(
            (~esc_all & rerr_all).reshape(n_chan_total, B), axis=0)

        # ---- per-element reconstruction (shift/unmix/escape select),
        # same bodies as the chained path's comp_side/with_unesc ----
        ci0 = 0
        for e in elems_meta:
            width, is_cpe = e["width"], e["is_cpe"]
            recon = [samples_all[(ci0 + ci) * B:(ci0 + ci + 1) * B]
                     for ci in range(width)]
            ci0 += width

            def comp_side(recon=recon, e=e):
                if bs:
                    d = 8 * bs
                    seg = bitpack.extract_segment(
                        words, e["pos_shift"],
                        (e["width"] * S * d + 31) // 32)
                    sf = bitpack.unpack_fields(
                        seg, d, e["width"] * S).astype(I32)
                    sfv = sf.reshape(B, S, e["width"])
                    shifts = [sfv[:, :, ci] for ci in range(e["width"])]
                else:
                    shifts = [jnp.zeros((B, S), I32)] * e["width"]
                if e["is_cpe"]:
                    l, rr = matrix.unmix(recon[0], recon[1],
                                         e["mixbits"][:, None],
                                         e["mixres"][:, None])
                    return (matrix.shift_in(l, shifts[0], bs),
                            matrix.shift_in(rr, shifts[1], bs))
                return (matrix.shift_in(recon[0], shifts[0], bs),)

            def skip_side(width=width):
                return tuple(jnp.zeros((B, S), I32) for _ in range(width))

            dec = list(jax.lax.cond(e["all_esc"], skip_side, comp_side))

            def with_unesc(dec=dec, e=e):
                if fast_hdr:
                    raws = _unescape_fast(words, depth, e["width"], S,
                                          e["partial"])
                else:
                    raws = _unescape_window(words, e["pos_esc"], depth,
                                            e["width"], S)
                return tuple(
                    jnp.where(e["esc"][:, None], raws[ci], dec[ci])
                    for ci in range(e["width"]))

            out_ch.extend(jax.lax.cond(jnp.any(e["esc"]), with_unesc,
                                       lambda dec=dec: tuple(dec)))

    pcm = jnp.stack(out_ch, axis=1)
    # partial lanes: samples past num are scan leftovers — zero them
    # (gated: full-frame batches skip the (B, C, S) select entirely)
    pcm = jax.lax.cond(
        jnp.any(num < S),
        lambda: jnp.where(iota1(S)[None, None, :] < num[:, None, None],
                          pcm, 0),
        lambda: pcm)
    return pcm, err, num


# ---------------------------------------------------------------------------
# host orchestration: stream backend
# ---------------------------------------------------------------------------
FRAMES_AXIS = "frames"  # mesh axis name for frame-parallel sharding


def shard_frames(fn, mesh, out_specs=None):
    """Run ``fn`` per shard of the frames axis.  The compiler cannot
    partition a Pallas kernel, so the sharded programs are written per
    shard with ``shard_map``; every codec array is batch-leading and
    per-lane pure, so by default each input and output is split on axis
    0.  Reductions across shards (``lax.psum``) go in ``fn`` itself,
    outside the kernels."""
    from jax.sharding import PartitionSpec
    spec = PartitionSpec(FRAMES_AXIS)
    return jax.shard_map(fn, mesh=mesh, in_specs=spec,
                         out_specs=spec if out_specs is None else out_specs,
                         check_vma=False)


class JaxCodec:
    """Compiled batched codec for one AlacConfig (+ frame batch size).

    With ``mesh`` (a 1-D ``jax.sharding.Mesh`` over the frames axis) the
    compiled programs shard every frame batch across the mesh's devices —
    the programs are per-frame-lane pure, so each runs per shard under
    ``shard_map`` with no collectives, and the packet bytes are unchanged
    (tested byte-identical to the single-device codec).  ``chunk`` rounds
    up to a mesh multiple; host blocks are always padded to ``chunk``, so every
    dispatched array divides evenly across devices.
    """

    def __init__(self, config: AlacConfig, chunk: int = DEFAULT_CHUNK,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None and chunk % mesh.size:
            chunk = ((chunk + mesh.size - 1) // mesh.size) * mesh.size
        self.config = config
        self.chunk = chunk
        S = config.frame_length
        self.num_words = (config.max_escape_packet_bytes(S) + 3) // 4 + 2
        self._exe = {}
        # lanes decode_frames_ex handed to the host oracle (a correct
        # device path leaves this at 0 on its own encoder's output)
        self.oracle_fallback_lanes = 0
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            # every codec array is batch-leading, so ONE spec (shard axis
            # 0, replicate the rest) serves all inputs and outputs
            self._shard = NamedSharding(mesh, PartitionSpec(FRAMES_AXIS))
        else:
            self._shard = None

    # NOTE: calls go through ahead-of-time compiled executables rather
    # than the jit dispatch fastpath: on this jax build the fastpath
    # intermittently paired a repeat call with the wrong executable
    # ("Execution supplied 1 buffers but compiled program expected 3") in
    # long multi-config processes.  AOT Compiled objects dispatch directly.
    def _jit(self, fn):
        if self._shard is None:
            return jax.jit(fn)
        return jax.jit(shard_frames(fn, self.mesh),
                       in_shardings=self._shard, out_shardings=self._shard)

    def _place(self, x):
        # AOT executables are strict about input shardings: reshard here
        return x if self._shard is None else jax.device_put(x, self._shard)

    def _aot(self, kind, fn, x):
        key = (kind, x.shape, str(x.dtype))
        exe = self._exe.get(key)
        if exe is None:
            exe = self._jit(fn).lower(x).compile()
            self._exe[key] = exe
        return exe(self._place(x))

    def _encode(self, pcm):
        cfg, nw = self.config, self.num_words
        return self._aot(
            "enc", lambda p: encode_frames_device(p, config=cfg,
                                                  num_words=nw), pcm)

    def _encode_ex(self, pcm, nums):
        cfg, nw = self.config, self.num_words
        key = ("encp", pcm.shape, str(pcm.dtype))
        exe = self._exe.get(key)
        if exe is None:
            fn = (lambda p, n:
                  _encode_packet_chunks(p, cfg, nw, nums=n)[:2])
            exe = self._jit(fn).lower(pcm, nums).compile()
            self._exe[key] = exe
        return exe(self._place(pcm), self._place(nums))

    def _decode(self, words, taps: int = 8):
        cfg = self.config
        return self._aot(
            "dec%d" % taps,
            lambda w: decode_frames_device(w, config=cfg,
                                           num_samples=cfg.frame_length,
                                           taps=taps),
            words)

    # -- encode ---------------------------------------------------------
    def encode_frames(self, pcm: np.ndarray) -> list[bytes]:
        """(nf, C, S) planar int -> list of nf packets.

        Chunks are PIPELINED: jax dispatch is async, so chunk k+1's
        device work is launched before chunk k's results are read back
        and serialized — the host's words_to_bytes pass rides under the
        device's compute instead of serializing with it (one chunk of
        lookahead: bounded memory)."""
        nf = pcm.shape[0]
        packets = []
        pending = None  # (n, (words, bits)) still on device
        for off in range(0, nf, self.chunk):
            block = pcm[off:off + self.chunk]
            n = block.shape[0]
            if n < self.chunk:
                block = np.concatenate(
                    [block, np.zeros((self.chunk - n,) + block.shape[1:],
                                     dtype=block.dtype)], axis=0)
            fut = self._encode(jnp.asarray(block.astype(np.int32)))
            if pending is not None:
                n0, (w0, b0) = pending
                packets.extend(bitpack.words_to_bytes(
                    np.asarray(w0)[:n0], np.asarray(b0)[:n0]))
            pending = (n, fut)
        if pending is not None:
            n0, (w0, b0) = pending
            packets.extend(bitpack.words_to_bytes(
                np.asarray(w0)[:n0], np.asarray(b0)[:n0]))
        return packets

    def encode_frames_ex(self, pcm: np.ndarray,
                         nums: np.ndarray) -> list[bytes]:
        """(nf, C, S) planar int + (nf,) per-frame sample counts -> list
        of nf packets.  Frames with nums < S encode as partial (tail)
        frames ON DEVICE, batched with full frames (reference:
        ALACEncoder.cpp Encode partial-frame path); their samples at
        index >= nums must be zero (callers pad)."""
        S = self.config.frame_length
        nf = pcm.shape[0]
        packets = []
        pending = None  # pipelined like encode_frames
        for off in range(0, nf, self.chunk):
            block = pcm[off:off + self.chunk]
            nm = np.asarray(nums[off:off + self.chunk], dtype=np.int32)
            n = block.shape[0]
            if n < self.chunk:
                pad = self.chunk - n
                block = np.concatenate(
                    [block, np.zeros((pad,) + block.shape[1:],
                                     dtype=block.dtype)], axis=0)
                nm = np.concatenate([nm, np.full((pad,), S, np.int32)])
            fut = self._encode_ex(
                jnp.asarray(block.astype(np.int32)), jnp.asarray(nm))
            if pending is not None:
                n0, (w0, b0) = pending
                packets.extend(bitpack.words_to_bytes(
                    np.asarray(w0)[:n0], np.asarray(b0)[:n0]))
            pending = (n, fut)
        if pending is not None:
            n0, (w0, b0) = pending
            packets.extend(bitpack.words_to_bytes(
                np.asarray(w0)[:n0], np.asarray(b0)[:n0]))
        return packets

    # -- decode ---------------------------------------------------------
    def decode_frames_ex(self, packets: list[bytes]
                         ) -> tuple[np.ndarray, np.ndarray]:
        """list of packets -> ((nf, C, S) planar int64, (nf,) sample
        counts).  Partial (tail) frames decode on device alongside full
        frames (per-lane num mask); their trailing columns are zero."""
        cfg = self.config
        S = cfg.frame_length
        nf = len(packets)
        out = np.zeros((nf, cfg.num_channels, S), dtype=np.int64)
        nums = np.full((nf,), S, dtype=np.int64)

        def dispatch(off):
            """Host word prep + async device decode for one chunk."""
            blk = packets[off:off + self.chunk]
            n = len(blk)
            padded = blk + [b""] * (self.chunk - n)
            wdev = jnp.asarray(bitpack.bytes_to_words(padded,
                                                      self.num_words))
            return off, n, blk, wdev, self._decode(wdev)

        # pipelined: chunk k+1's host prep + device launch happen before
        # chunk k's readback/fallback processing (one chunk of lookahead)
        offs = list(range(0, nf, self.chunk))
        pending = dispatch(offs[0]) if offs else None
        for i in range(len(offs)):
            cur = pending
            pending = dispatch(offs[i + 1]) if i + 1 < len(offs) else None
            off, n, blk, wdev, (pcm, err, num) = cur
            pcm = np.asarray(pcm)[:n]
            err = np.asarray(err)[:n]
            out[off:off + n] = pcm
            nums[off:off + n] = np.asarray(num)[:n]
            # widespread errors usually mean a legal higher-order stream
            # (the production program compiles only the 8-tap FIR body);
            # re-run through the lazily compiled 16- then 30-tap programs
            # (the 5-bit order field's full legal range) before paying
            # the scalar-oracle cliff.  The threshold keeps corruption
            # fuzzing (a few bad lanes) from triggering pointless
            # compiles.
            for retry_taps in (16, 30):
                if err.any() and err.sum() * 4 >= n and n >= 64:
                    pcm_r, err_r, num_r = self._decode(wdev,
                                                       taps=retry_taps)
                    fixed = err & ~np.asarray(err_r)[:n]
                    out[off:off + n][fixed] = np.asarray(pcm_r)[:n][fixed]
                    nums[off:off + n][fixed] = np.asarray(num_r)[:n][fixed]
                    err = err & ~fixed
            if err.any():
                # lanes the device flagged (policy: DSE/FIL elements,
                # mismatched layouts, corruption) re-decode on the host
                self.oracle_fallback_lanes += int(err.sum())
                dec = OracleDecoder(cfg)
                for j in np.nonzero(err)[0]:
                    y, got = dec.decode_packet(blk[j])
                    out[off + j, :, :got] = y[:, :got]
                    out[off + j, :, got:] = 0
                    nums[off + j] = got
        return out, nums

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """list of FULL-frame packets -> (nf, C, S) planar int64."""
        out, nums = self.decode_frames_ex(packets)
        if (nums != self.config.frame_length).any():
            raise AlacParamError("unexpected partial frame")
        return out


_CODEC_CACHE: dict[tuple, JaxCodec] = {}


def _default_mesh():
    """Frames mesh over the visible devices — multi-chip as config, not
    code (SURVEY.md §5): every public entry point (CLI, convert, batch,
    reader) auto-shards when >1 device is present.  ``ALACJAX_DEVICES``
    bounds the mesh (``1`` opts out); read lazily so the CLI's --devices
    flag and test harnesses can set it before first codec construction."""
    import os
    env = os.environ.get("ALACJAX_DEVICES")
    devs = jax.devices()
    n = len(devs)
    if env is not None:
        n = max(1, min(n, int(env)))
    if n <= 1:
        return None
    from jax.sharding import Mesh
    return Mesh(np.asarray(devs[:n]), (FRAMES_AXIS,))


def get_codec(config: AlacConfig, chunk: int = DEFAULT_CHUNK,
              devices=None) -> JaxCodec:
    """Shared-cache codec lookup.  ``devices``: None = auto (all visible
    devices, bounded by ALACJAX_DEVICES), an int device count, or an
    explicit device sequence."""
    if devices is None:
        mesh = _default_mesh()
    elif isinstance(devices, int):
        if devices <= 1:
            mesh = None
        else:
            from jax.sharding import Mesh
            mesh = Mesh(np.asarray(jax.devices()[:devices]), (FRAMES_AXIS,))
    else:
        from jax.sharding import Mesh
        devices = list(devices)
        mesh = (Mesh(np.asarray(devices), (FRAMES_AXIS,))
                if len(devices) > 1 else None)
    mesh_key = (None if mesh is None
                else tuple(d.id for d in mesh.devices.flat))
    key = (config, chunk, mesh_key)
    if key not in _CODEC_CACHE:
        _CODEC_CACHE[key] = JaxCodec(config, chunk, mesh=mesh)
    return _CODEC_CACHE[key]


def _codec_key_config(config: AlacConfig) -> AlacConfig:
    """Normalize cookie-only fields before keying the codec cache:
    sample_rate / maxFrameBytes / avgBitRate never enter the packet
    math, so files differing only in them share ONE compiled
    executable (without this, decoding two files with different
    bit-rate stats compiled twice)."""
    import dataclasses
    return dataclasses.replace(config, sample_rate=44100,
                               max_frame_bytes=0, avg_bit_rate=0)


def _jax_encode_stream(config: AlacConfig, pcm: np.ndarray) -> list[bytes]:
    """convert.py backend: planar (C, N) -> packets, full frames AND the
    partial tail in one device batch (per-lane nums; reference:
    ALACEncoder.cpp Encode partial-frame path)."""
    config = _codec_key_config(config)
    S = config.frame_length
    C = pcm.shape[0]
    N = pcm.shape[1]
    nf = N // S
    rem = N % S
    n_pk = nf + (1 if rem else 0)
    if not n_pk:
        return []
    frames = np.zeros((n_pk, C, S), dtype=pcm.dtype)
    if nf:
        frames[:nf] = np.transpose(
            pcm[:, : nf * S].reshape(C, nf, S), (1, 0, 2))
    nums = np.full((n_pk,), S, dtype=np.int32)
    if rem:
        frames[nf, :, :rem] = pcm[:, nf * S:]
        nums[nf] = rem
    codec = get_codec(config)
    if rem:
        return codec.encode_frames_ex(frames, nums)
    return codec.encode_frames(frames)


def _jax_decode_stream(config: AlacConfig, packets, num_valid_frames: int) -> np.ndarray:
    config = _codec_key_config(config)
    S = config.frame_length
    n_full = num_valid_frames // S
    n_full = min(n_full, len(packets))
    rem = num_valid_frames - n_full * S
    if rem and len(packets) <= n_full:
        raise AlacParamError("missing packets for trailing samples")
    n_pk = n_full + (1 if rem else 0)
    out = np.zeros((config.num_channels, num_valid_frames), dtype=np.int64)
    if not n_pk:
        return out
    # full frames AND the partial tail decode in one device batch
    # (per-lane num mask; reference: ALACDecoder.cpp partialFrame)
    pcm, nums = get_codec(config).decode_frames_ex(list(packets[:n_pk]))
    if (nums[:n_full] != S).any():
        raise AlacParamError("unexpected partial frame")
    if rem and nums[n_full] != rem:
        raise AlacParamError(
            f"tail packet has {int(nums[n_full])} samples, expected {rem}")
    flat = np.transpose(pcm[:n_full], (1, 0, 2)).reshape(
        config.num_channels, n_full * S)
    out[:, : n_full * S] = flat
    if rem:
        out[:, n_full * S:] = pcm[n_full, :, :rem]
    return out


from . import convert as _convert  # noqa: E402  (registration at import)

_convert.register_backend("jax", _jax_encode_stream, _jax_decode_stream)
