"""Batched adaptive FIR predictor on device (oracle: alacjax.oracle.dp;
reference: codec/dp_enc.c / dp_dec.c).

The per-frame recurrence is irreducibly sequential in the sample axis, so
it runs as a `lax.scan` over S steps, each step a full-width
elementwise op across the B frame-lanes (SURVEY.md §5
sequence-parallel row).  The reference's data-dependent early-exit
coefficient walk becomes a branchless masked update: each of the 16 tap
iterations computes its activity predicate (k < numactive, error still
on the original side) and applies a masked +/-1 coefficient step —
bit-identical to the sequential walk because the mask reproduces the
exact break condition.

Performance shape: the scan carry is a *tuple of (B,) vectors* (17 lagged
samples + 16 coefficient columns), so the per-step "window shift" is pure
SSA renaming — zero data movement — and every op in the body is a plain
elementwise op on (B,) lanes.  A (B, 17) window with a per-step
concatenate would move the whole window on every step.

``numactive`` may be a static python int (encoder: candidate orders) or a
per-lane (B,) array (decoder: orders arrive in the stream).  Per-lane
values are supported for 0, 1..16, and 31; 17..30 (format-legal but never
emitted by our encoder or the reference's) are rejected host-side and
routed to the oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..types import kALACMaxCoefs
from . import pallas
from .jaxutils import I32, sign_extend, sign_of_int

# Scan unroll factor.  The default of 4 dates from before the GPU port
# and has not been re-measured on the H100; the CPU test tier sets
# ALACJAX_SCAN_UNROLL=1 because XLA:CPU compile time scales with the
# unrolled body size (results are bit-identical either way).  Read
# lazily at trace time so an os.environ update after import still takes
# effect.
import os as _os


def _unroll() -> int:
    return int(_os.environ.get("ALACJAX_SCAN_UNROLL", "4"))


def _fir_den(denshift):
    """(den, denhalf) with den = max(denshift, 1): denshift == 0 is only
    reachable from invalid streams (flagged upstream).  A static int
    stays a Python int, so kernels see constants."""
    if isinstance(denshift, int):
        den = max(denshift, 1)
        return den, 1 << (den - 1)
    den = jnp.maximum(jnp.asarray(denshift, I32), 1)
    return den, jnp.left_shift(jnp.int32(1), den - 1).astype(I32)


def _general_carry0(coef_cols, zero, *, cost=None, dual=False):
    """Initial carry of the general-mode step: nk+1 lags, nk coefficient
    columns, the sample counter t, then (with ``cost``) the Rice cost
    machine state + running total, and (with ``dual``) the previous
    residual + a second machine + its total."""
    from . import rice as rice_mod
    nk = len(coef_cols)
    carry = (zero,) * (nk + 1) + tuple(coef_cols) + (jnp.int32(0),)
    if cost is not None:
        machine = rice_mod._init_state(zero.shape[0], cost[0]) + (zero,)
        carry = carry + machine
        if dual:
            carry = carry + (zero,) + machine
    return carry


def _general_step(carry, x_t, *, na, nk, den, denhalf, chanbits,
                  decode: bool, cost=None, dual: bool = False, S_eff=None):
    """One sample step of the general-mode scan, shared by the XLA scan
    (_scan_general) and the GPU cost kernel (pallas/cost_pallas.py).

    x_t: (L,) input sample (encode) or residual (decode).  ``na`` is a
    static int or a per-lane (L,) order; ``nk`` the static tap bound.
    With cost=(mb0, pb, kb, wb) on encode the adaptive-Rice bit cost of
    the residual stream accumulates in the same step
    (rice._encode_step_tokens' length logic; the codeword values are
    dead code), and with ``dual`` a second machine prices the
    residuals' first difference (the stage-2 / mode != 0 cascade,
    dp_enc.c :: pc_block numactive==31 applied to the FIR residuals).
    Returns (new_carry, out)."""
    static_na = isinstance(na, int)
    nw = nk + 1
    nc = nw + nk + 1
    lags, coefs, t = carry[:nw], carry[nw:nw + nk], carry[nc - 1]
    zero = jnp.zeros_like(lags[0])

    if static_na:
        top = lags[na]
        in_warm = t <= na
    else:
        top = zero
        for i in range(nk + 1):
            top = jnp.where(na == i, lags[i], top)
        in_warm = t <= na

    sum1 = denhalf
    for k in range(nk):
        term = coefs[k] * (lags[k] - top)
        sum1 = sum1 + (term if static_na else jnp.where(k < na, term, 0))
    pred_adj = jnp.right_shift(sum1, den)

    if decode:
        out_gen = sign_extend(x_t + top + pred_adj, chanbits)
        out_warm = sign_extend(x_t + lags[0], chanbits)
        err = x_t                      # residual drives adaptation
    else:
        out_gen = sign_extend(x_t - top - pred_adj, chanbits)
        out_warm = sign_extend(x_t - lags[0], chanbits)
        err = out_gen

    out = jnp.where(t == 0, x_t, jnp.where(in_warm, out_warm, out_gen))

    # sign-sign adaptation with branchless early exit
    adapt = ~in_warm
    sg = sign_of_int(err)
    del0 = err
    new_coefs = list(coefs)
    for k in range(nk - 1, -1, -1):
        going = jnp.where(sg > 0, del0 > 0, del0 < 0)
        active = adapt & (sg != 0) & going
        if not static_na:
            active = active & (k < na)
        dd = top - lags[k]
        sgn = sign_of_int(dd)
        upd = jnp.where(sg > 0, -sgn, sgn)
        new_coefs[k] = sign_extend(coefs[k] + jnp.where(active, upd, 0), 16)
        mag = sgn * dd                      # |dd|
        term = jnp.where(sg > 0,
                         jnp.right_shift(mag, den),
                         jnp.right_shift(-mag, den))
        del0 = del0 - jnp.where(active, (na - k) * term, 0)

    new_sample = out if decode else x_t
    new_lags = (new_sample,) + lags[:-1]   # SSA rotation: free
    new_carry = new_lags + tuple(new_coefs) + (t + 1,)
    if cost is None:
        return new_carry, out
    from . import rice as rice_mod
    _, pb, kb, wb = cost
    rice_state, total = carry[nc:nc + 5], carry[nc + 5]
    rice_state, _, lens = rice_mod._encode_step_tokens(
        out, t, rice_state, S=S_eff, bit_size=chanbits, pb=pb, kb=kb, wb=wb)
    tail = rice_state + (total + lens[0] + lens[1] + lens[2],)
    if dual:
        prev_out = carry[nc + 6]
        rice2, total2 = carry[nc + 7:nc + 12], carry[nc + 12]
        d = jnp.where(t == 0, out, sign_extend(out - prev_out, chanbits))
        rice2, _, lens2 = rice_mod._encode_step_tokens(
            d, t, rice2, S=S_eff, bit_size=chanbits, pb=pb, kb=kb, wb=wb)
        tail = tail + (out,) + rice2 + (total2 + lens2[0] + lens2[1]
                                        + lens2[2],)
    return new_carry + tail, out


def _general_costs(carry, *, nk, S: int, S_eff, chanbits, cost, dual):
    """Final cost totals: the virtual end step (t == S) flushes a pending
    zero-run token in each machine (rice.rice_cost's flush)."""
    from . import rice as rice_mod
    _, pb, kb, wb = cost
    nc = 2 * nk + 2
    ones = jnp.ones_like(carry[0])

    def flush(state, total):
        _, _, lens = rice_mod._encode_step_tokens(
            ones, jnp.int32(S), state, S=S_eff, bit_size=chanbits, pb=pb,
            kb=kb, wb=wb)
        return total + lens[0] + lens[1] + lens[2]

    totals = (flush(carry[nc:nc + 5], carry[nc + 5]),)
    if dual:
        totals = totals + (flush(carry[nc + 7:nc + 12], carry[nc + 12]),)
    return totals


def _scan_general(x_sb, coefs0, na, chanbits, denshift, *, decode: bool,
                  cost_params=None, dual_cost: bool = False,
                  na_max: int | None = None, num=None):
    """Shared general-mode scan.  x_sb: (S, B) time-major input (samples on
    encode, residuals on decode).  Returns (out (S, B), coefs (B, 16)),
    with cost_params=(mb0, pb, kb, wb) on encode also the Rice cost
    (B,) of the residuals, and with dual_cost also the cost of their
    first difference — the whole order x stage candidate grid then
    costs one scan per order (see _general_step).

    ``num`` (per-lane (B,), <= S) restricts the COST machines to the
    first ``num`` samples of each lane — partial (tail) frames batch
    with full frames (reference: ALACEncoder.cpp partial-frame Encode).
    The predictor walk itself needs no mask: residuals below num are
    causal in the input, and post-num adaptation only affects coefs_out,
    which tails (always a stream's last packet) never commit."""
    S, B = x_sb.shape
    static_na = isinstance(na, int)
    if not static_na:
        na = na.astype(I32)
    # per-lane na: the tap loop and the ``top`` lag select only need to
    # reach the static *maximum* order present (callers pass na_max; the
    # encoder's search grid is orders {4, 8}).  The carry is sized to
    # that bound too: nk+1 lags + nk coefficient columns; columns >= nk
    # are never touched by the adaptation walk and rejoin unchanged.
    # Bit-identical: lanes never index past their own na.
    nk = na if static_na else (na_max if na_max is not None
                               else kALACMaxCoefs)
    den, denhalf = _fir_den(denshift)
    coefs0_i = coefs0.astype(I32)
    zero = jnp.zeros((B,), dtype=I32)
    carry0 = _general_carry0([coefs0_i[:, k] for k in range(nk)], zero,
                             cost=cost_params, dual=dual_cost)
    S_eff = S if num is None else num.astype(I32)
    step = functools.partial(
        _general_step, na=na, nk=nk, den=den, denhalf=denhalf,
        chanbits=chanbits, decode=decode, cost=cost_params, dual=dual_cost,
        S_eff=S_eff)
    carry_out, out_sb = jax.lax.scan(step, carry0, x_sb, unroll=_unroll())
    cols = list(carry_out[nk + 1:2 * nk + 1])
    cols += [coefs0_i[:, k] for k in range(nk, coefs0_i.shape[1])]
    coefs_out = jnp.stack(cols, axis=1)
    if cost_params is None:
        return out_sb, coefs_out
    return (out_sb, coefs_out) + _general_costs(
        carry_out, nk=nk, S=S, S_eff=S_eff, chanbits=chanbits,
        cost=cost_params, dual=dual_cost)


def _mode31(x, chanbits, decode: bool):
    """First-order difference special mode (numactive == 31)."""
    x = x.astype(I32)
    if decode:
        # cumulative sum mod 2^32, then clamp to chanbits: equivalent to the
        # per-step sign-extend because both agree mod 2^chanbits
        return sign_extend(jnp.cumsum(x, axis=1, dtype=I32), chanbits)
    first = x[:, :1]
    diffs = sign_extend(x[:, 1:] - x[:, :-1], chanbits)
    return jnp.concatenate([first, diffs], axis=1)


def _run(x, coefs0, numactive, chanbits, denshift, decode: bool):
    x = x.astype(I32)
    B, S = x.shape
    if coefs0 is None:
        coefs0 = jnp.zeros((B, kALACMaxCoefs), dtype=I32)

    if isinstance(numactive, int):
        if numactive == 0:
            return x, coefs0.astype(I32)
        if numactive == 31:
            return _mode31(x, chanbits, decode), coefs0.astype(I32)
        out_sb, coefs = _scan_general(
            x.T, coefs0, numactive, chanbits, denshift, decode=decode)
        return out_sb.T, coefs

    # per-lane numactive: run the general scan with na clamped into range,
    # then overlay the special modes
    na = numactive.astype(I32)
    na_eff = jnp.clip(na, 1, kALACMaxCoefs)
    out_sb, coefs = _scan_general(
        x.T, coefs0, na_eff, chanbits, denshift, decode=decode)
    out = out_sb.T
    m31 = _mode31(x, chanbits, decode)
    is0 = (na == 0)[:, None]
    is31 = (na == 31)[:, None]
    out = jnp.where(is0, x, jnp.where(is31, m31, out))
    return out, coefs


def pc_block(x, coefs0, numactive, chanbits, denshift=9):
    """Batched forward prediction: (B, S) samples -> (residuals, coefs_out)."""
    return _run(x, coefs0, numactive, chanbits, denshift, decode=False)


def unpc_block(res, coefs0, numactive, chanbits, denshift=9):
    """Batched inverse prediction: (B, S) residuals -> (samples, coefs_out)."""
    return _run(res, coefs0, numactive, chanbits, denshift, decode=True)


def pc_block_cost(x, coefs0, numactive: int, chanbits: int, denshift: int,
                  mb0: int, pb: int, kb: int, wb: int, num=None):
    """Fused forward prediction + adaptive-Rice bit cost (one scan).

    (B, S) samples -> (residuals (B, S), rice_cost_bits (B,)).  Exactly
    pc_block followed by rice.rice_cost, but the cost state machine runs
    inside the predictor scan — the encoder search's hot path.
    """
    res, cost, _ = pc_block_cost_coefs(
        x, coefs0, numactive, chanbits, denshift, mb0, pb, kb, wb, num=num)
    return res, cost


def _cost_kernel_ok(numactive, denshift) -> bool:
    """Route the fused predict + cost scan to the GPU kernel
    (pallas/cost_pallas.py): on the GPU backend, with a static denshift
    and a general-mode order (orders 0 and 31 are closed forms).  Any S
    and lane count fit (lanes are padded to the kernel's block)."""
    if not pallas.gpu_kernels() or not isinstance(denshift, int):
        return False
    return not (isinstance(numactive, int) and numactive in (0, 31))


def _closed_form_costs(x, coefs0, numactive, chanbits, denshift, mb0, pb,
                       kb, wb, num, dual):
    """Orders 0 and 31 (no adaptive walk): residuals in closed form, then
    the Rice cost scan(s)."""
    from . import rice as rice_mod
    res, coefs = _run(x, coefs0, numactive, chanbits, denshift,
                      decode=False)
    costs = (rice_mod.rice_cost(res, chanbits, mb0, pb, kb, wb, num=num),)
    if dual:
        costs += (rice_mod.rice_cost(wrap_diff(res, chanbits), chanbits,
                                     mb0, pb, kb, wb, num=num),)
    return (res,) + costs + (coefs,)


def pc_block_cost_coefs(x, coefs0, numactive: int, chanbits: int,
                        denshift: int, mb0: int, pb: int, kb: int, wb: int,
                        num=None):
    """pc_block_cost that also returns the adapted coefficients (B, 16)
    (needed by the persistent-bank stream encoder, ALACEncoder.cpp's
    mCoefsU/V members surviving across packets)."""
    x = x.astype(I32)
    if coefs0 is None:
        coefs0 = jnp.zeros((x.shape[0], kALACMaxCoefs), dtype=I32)
    if isinstance(numactive, int) and numactive in (0, 31):
        return _closed_form_costs(x, coefs0, numactive, chanbits, denshift,
                                  mb0, pb, kb, wb, num, dual=False)
    if _cost_kernel_ok(numactive, denshift):
        from .pallas.cost_pallas import pc_block_cost2_pallas
        res, c1, _, coefs = pc_block_cost2_pallas(
            x, coefs0, numactive, chanbits, denshift, mb0, pb, kb, wb,
            na_max=numactive, num=num, dual=False)
        return res, c1, coefs
    out_sb, coefs, cost = _scan_general(
        x.T, coefs0, numactive, chanbits, denshift, decode=False,
        cost_params=(mb0, pb, kb, wb), num=num)
    return out_sb.T, cost, coefs


def wrap_diff(res, chanbits: int):
    """Stage-2 emission residual: pc_block(res, 31) == first difference
    with chanbits wraparound (dp_enc.c :: pc_block numactive==31)."""
    res = res.astype(I32)
    first = res[:, :1]
    diffs = sign_extend(res[:, 1:] - res[:, :-1], chanbits)
    return jnp.concatenate([first, diffs], axis=1)


def pc_block_cost2(x, coefs0, numactive, chanbits: int, denshift: int,
                   mb0: int, pb: int, kb: int, wb: int,
                   na_max: int | None = None, num=None):
    """Fused forward prediction + Rice cost of BOTH stage candidates.

    (B, S) samples -> (residuals (B, S), cost1 (B,), cost2 (B,),
    coefs (B, 16)) where cost1 prices the FIR residuals (mode 0) and
    cost2 prices their first difference (mode != 0, two-stage cascade) —
    one scan total.  The stage-2 residuals are wrap_diff(residuals);
    coefs are the adapted coefficients (stage 2's first-difference pass
    does not touch them).

    ``numactive`` may be a per-lane (B,) array of orders in 1..16 — the
    encoder stacks its whole (order x channel) candidate grid into ONE
    scan this way (fewer sequential scans beats the masked-tap overhead:
    the scans are latency-bound, not lane-bound).
    """
    x = x.astype(I32)
    if coefs0 is None:
        coefs0 = jnp.zeros((x.shape[0], kALACMaxCoefs), dtype=I32)
    static_na = isinstance(numactive, int)
    if static_na and numactive in (0, 31):
        return _closed_form_costs(x, coefs0, numactive, chanbits, denshift,
                                  mb0, pb, kb, wb, num, dual=True)
    na = numactive if static_na else numactive.astype(I32)
    nk = na if static_na else (na_max if na_max is not None
                               else kALACMaxCoefs)
    if _cost_kernel_ok(numactive, denshift):
        from .pallas.cost_pallas import pc_block_cost2_pallas
        return pc_block_cost2_pallas(
            x, coefs0, na, chanbits, denshift, mb0, pb, kb, wb, na_max=nk,
            num=num, dual=True)
    out_sb, coefs, cost, cost2 = _scan_general(
        x.T, coefs0, na, chanbits, denshift, decode=False,
        cost_params=(mb0, pb, kb, wb), dual_cost=True, na_max=nk, num=num)
    return out_sb.T, cost, cost2, coefs
