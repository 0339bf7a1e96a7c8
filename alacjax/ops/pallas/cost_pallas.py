"""GPU kernel for the fused predict + adaptive-Rice cost scan.

The encoder search's hot loop (ops/predict._scan_general with a cost
machine, optionally two): per lane, the adaptive FIR predictor walk plus
one or two Rice bit-cost machines, sequential over the sample axis.  As
an XLA while loop the step body splits into a dozen or more fusions, and
each fusion is a kernel launch per sample step.  Here one program owns a
block of lanes and runs the whole sample loop with the per-lane state
(2*nk+14 int32 at most) as its loop carry, in registers.

The body is ``predict._general_step``, the same function the XLA scan
runs, so the two are bit-identical by construction (the defining scalar
references are alacjax/oracle/dp.py :: pc_block and alacjax/oracle/ag.py
— dp_enc.c / ag_enc.c).

Envelope: static denshift; static or per-lane order (<= ``na_max``),
static or per-lane chanbits, optional per-lane sample counts ``num``
(partial tails); any S; lanes are padded to the block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ...types import kALACMaxCoefs
from .. import predict
from ..jaxutils import I32
from . import LANES, compiler_params, pad_lanes


def _cost_kernel(x_ref, c0_ref, na_ref, cb_ref, num_ref, res_ref, cost_ref,
                 cout_ref, *, na_static, nk, chanbits, denshift, cost, dual,
                 has_num):
    """One lane block: x (S, LANES) -> residuals (S, LANES), costs
    (2, LANES), adapted coefficients (16, LANES)."""
    S = x_ref.shape[0]
    na = na_static if na_static is not None else na_ref[0, :]
    cb = chanbits if chanbits is not None else cb_ref[0, :]
    S_eff = num_ref[0, :] if has_num else S
    den, denhalf = predict._fir_den(denshift)
    zero = jnp.zeros((x_ref.shape[1],), I32)
    carry0 = predict._general_carry0(
        [c0_ref[k, :] for k in range(nk)], zero, cost=cost, dual=dual)
    step = functools.partial(
        predict._general_step, na=na, nk=nk, den=den, denhalf=denhalf,
        chanbits=cb, decode=False, cost=cost, dual=dual, S_eff=S_eff)

    def body(t, carry):
        carry, out = step(carry, x_ref[t, :])
        res_ref[t, :] = out
        return carry

    carry = jax.lax.fori_loop(0, S, body, carry0)
    totals = predict._general_costs(carry, nk=nk, S=S, S_eff=S_eff,
                                    chanbits=cb, cost=cost, dual=dual)
    cost_ref[0, :] = totals[0]
    cost_ref[1, :] = totals[1] if dual else zero
    for k in range(kALACMaxCoefs):
        cout_ref[k, :] = carry[nk + 1 + k] if k < nk else c0_ref[k, :]


@functools.partial(
    jax.jit,
    static_argnames=("na_static", "nk", "chanbits", "denshift", "cost",
                     "dual", "has_num", "interpret"))
def _cost_call(x, coefs0, na_arr, cb_arr, num_arr, *, na_static, nk,
               chanbits, denshift, cost, dual, has_num, interpret):
    L, S = x.shape
    xt = pad_lanes(x.astype(I32).T, LANES)
    ct = pad_lanes(coefs0.astype(I32).T, LANES)
    Lp = xt.shape[1]
    # padding lanes: order/chanbits/num of a harmless real lane
    na_t = pad_lanes(na_arr.astype(I32)[None, :], LANES, nk)
    cb_t = pad_lanes(cb_arr.astype(I32)[None, :], LANES, 16)
    num_t = pad_lanes(num_arr.astype(I32)[None, :], LANES, S)

    def lane_spec(rows):
        return pl.BlockSpec((rows, LANES), lambda i: (0, i))

    kern = functools.partial(
        _cost_kernel, na_static=na_static, nk=nk, chanbits=chanbits,
        denshift=denshift, cost=cost, dual=dual, has_num=has_num)
    res, costs, cout = pl.pallas_call(
        kern,
        grid=(Lp // LANES,),
        in_specs=[lane_spec(S), lane_spec(kALACMaxCoefs), lane_spec(1),
                  lane_spec(1), lane_spec(1)],
        out_specs=[lane_spec(S), lane_spec(2), lane_spec(kALACMaxCoefs)],
        out_shape=[jax.ShapeDtypeStruct((S, Lp), jnp.int32),
                   jax.ShapeDtypeStruct((2, Lp), jnp.int32),
                   jax.ShapeDtypeStruct((kALACMaxCoefs, Lp), jnp.int32)],
        compiler_params=compiler_params(),
        interpret=interpret,
        name="alacjax_cost_scan",
    )(xt, ct, na_t, cb_t, num_t)
    return res[:, :L].T, costs[0, :L], costs[1, :L], cout[:, :L].T


def pc_block_cost2_pallas(x, coefs0, na, chanbits, denshift: int,
                          mb0: int, pb: int, kb: int, wb: int,
                          na_max: int, num=None, dual: bool = True,
                          interpret: bool = False):
    """(L, S) samples -> (res (L, S), cost1 (L,), cost2 (L,),
    coefs (L, 16)); bit-identical to ops/predict.pc_block_cost2 (cost2
    is zero with dual=False).  ``na`` and ``chanbits`` are static ints
    or per-lane (L,) arrays; ``na_max`` bounds a per-lane order."""
    L = x.shape[0]
    na_static = na if isinstance(na, int) else None
    cb_static = chanbits if isinstance(chanbits, int) else None
    zeros = jnp.zeros((L,), I32)
    return _cost_call(
        x, coefs0, zeros if na_static is not None else na,
        zeros if cb_static is not None else chanbits,
        zeros if num is None else num,
        na_static=na_static, nk=na_static if na_static is not None
        else na_max, chanbits=cb_static, denshift=denshift,
        cost=(mb0, int(pb), kb, wb), dual=dual, has_num=num is not None,
        interpret=interpret)
