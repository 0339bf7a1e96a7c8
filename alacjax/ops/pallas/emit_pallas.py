"""GPU kernel for the adaptive-Rice EMISSION scan (rice_encode_words).

Same reasoning as cost_pallas.py: as an XLA while loop the emission step
(token machine + word-accumulator appends + slot placement) splits into
a couple of dozen fusions, each a launch per sample step.  Here one
program owns a block of lanes and runs all S+1 steps (the last is the
virtual end step) with the emission state in registers, writing each
step's word slots time-major, so the stores are coalesced across lanes.

The body is ``rice._emit_step``, the same function the XLA scan runs, in
its production mode ``emit_flush=False`` (complete words in the chunk
streams, the final partial word returned as a per-lane tail for the
merger); the defining scalar reference is alacjax/oracle/ag.py
(ag_enc.c).  ``bit_size`` may be per-lane (stacked SCE/CPE channels, as
in 5.1), with ``bit_size_cap`` sizing the emission slots statically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from .. import rice
from ..jaxutils import I32, U32
from . import LANES, compiler_params, pad_lanes


def _emit_kernel(x_ref, start_ref, bs_ref, num_ref, w_ref, k_ref, end_ref,
                 tail_ref, *, bit_size_static, mb0, pb, kb, wb, n_slots,
                 has_num):
    """One lane block: x (S, lanes) -> words/keys (S+1, n_slots, lanes),
    end bits (1, lanes), tail value/key (2, lanes)."""
    S = x_ref.shape[0]
    start = start_ref[0, :]
    base_word = start >> 5
    bit_size = (bit_size_static if bit_size_static is not None
                else bs_ref[0, :])
    step = functools.partial(
        rice._emit_step, S=S, S_eff=num_ref[0, :] if has_num else S,
        bit_size=bit_size, pb=pb, kb=kb, wb=wb, base_word=base_word,
        n_slots=n_slots, emit_flush=False)

    def put(t, state, x):
        state, (ws, ks) = step(state, x, t)
        for si in range(n_slots):
            w_ref[t, si, :] = ws[si]
            k_ref[t, si, :] = ks[si]
        return state

    state = jax.lax.fori_loop(
        0, S, lambda t, st: put(t, st, x_ref[t, :]),
        rice._emit_state0(start, mb0))
    state = put(S, state, jnp.ones_like(start))     # virtual end step
    end_bits, tail_val, tail_key = rice._emit_finish(state, base_word)
    end_ref[0, :] = end_bits
    tail_ref[0, :] = tail_val
    tail_ref[1, :] = tail_key


@functools.partial(
    jax.jit,
    static_argnames=("bit_size_static", "cap", "mb0", "pb", "kb", "wb",
                     "has_num", "interpret"))
def _emit_call(x, start_bits, bs_arr, num_arr, *, bit_size_static, cap,
               mb0, pb, kb, wb, has_num, interpret):
    L, S = x.shape
    xt = pad_lanes(x.astype(I32).T, LANES)
    Lp = xt.shape[1]
    st_t = pad_lanes(start_bits.astype(I32)[None, :], LANES)
    bs_t = pad_lanes(bs_arr.astype(I32)[None, :], LANES, cap)
    num_t = pad_lanes(num_arr.astype(I32)[None, :], LANES, S)
    n_slots = rice._emit_slots(cap)

    def lane_spec(*rows):
        return pl.BlockSpec(rows + (LANES,),
                            lambda i: (0,) * len(rows) + (i,))

    kern = functools.partial(
        _emit_kernel, bit_size_static=bit_size_static, mb0=mb0, pb=pb,
        kb=kb, wb=wb, n_slots=n_slots, has_num=has_num)
    w, k, end, tail = pl.pallas_call(
        kern,
        grid=(Lp // LANES,),
        in_specs=[lane_spec(S), lane_spec(1), lane_spec(1), lane_spec(1)],
        out_specs=[lane_spec(S + 1, n_slots), lane_spec(S + 1, n_slots),
                   lane_spec(1), lane_spec(2)],
        out_shape=[jax.ShapeDtypeStruct((S + 1, n_slots, Lp), U32),
                   jax.ShapeDtypeStruct((S + 1, n_slots, Lp), U32),
                   jax.ShapeDtypeStruct((1, Lp), I32),
                   jax.ShapeDtypeStruct((2, Lp), U32)],
        compiler_params=compiler_params(),
        interpret=interpret,
        name="alacjax_rice_emit",
    )(xt, st_t, bs_t, num_t)
    # (S+1, n_slots, L) -> (L, (S+1)*n_slots) in stream order
    words = jnp.transpose(w[:, :, :L], (2, 0, 1)).reshape(L, -1)
    keys = jnp.transpose(k[:, :, :L], (2, 0, 1)).reshape(L, -1)
    return words, keys, end[0, :L], tail[0, :L], tail[1, :L]


def rice_encode_words_pallas(res, bit_size, mb0: int, pb, kb: int, wb: int,
                             start_bits, bit_size_cap: int | None = None,
                             num=None, interpret: bool = False):
    """Drop-in for ops/rice.rice_encode_words(emit_flush=False): returns
    (chunk_words (L, n_slots*(S+1)) u32, chunk_keys u32 with 0xFFFFFFFF
    empty slots, end_bits (L,) i32, tail_val (L,) u32, tail_key (L,) u32).
    """
    L = res.shape[0]
    cap = bit_size if isinstance(bit_size, int) else int(bit_size_cap)
    bss = bit_size if isinstance(bit_size, int) else None
    zeros = jnp.zeros((L,), I32)
    return _emit_call(
        res, jnp.broadcast_to(jnp.asarray(start_bits, I32), (L,)),
        zeros if bss is not None else bit_size,
        zeros if num is None else num,
        bit_size_static=bss, cap=cap, mb0=mb0, pb=int(pb), kb=kb, wb=wb,
        has_num=num is not None, interpret=interpret)
