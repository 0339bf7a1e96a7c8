"""GPU kernel for ONE fused-decode scan step (G substeps + refill shift).

As an XLA while loop the decode scan's step body splits into a couple of
dozen fusions, each a launch per scan step.  This kernel runs the whole
body — G Rice+FIR substeps and the cache shift — as one launch, while
the lax.scan and its per-lane row gather stay in XLA.  One program owns
a block of lanes, one lane per thread, and the state stacks are
lane-minor, so each row's loads and stores are coalesced.

Parity is by construction: the kernel calls the SAME
fused_decode._substep_core / _shift_cache functions the XLA step uses —
there is no second implementation of the decode arithmetic.  All refs
are i32 (u32 state rows are value-converted at the boundary).

Reference: codec/dp_dec.c :: unpc_block + codec/ag_dec.c :: dyn_decomp
per sample; the launch structure has no scalar counterpart.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ..jaxutils import I32, U32
from . import LANES, compiler_params

_N_ST = 6  # bitpos, mb, zmode, run_rem, c, err


def _step_kernel(st_ref, base_ref, blk_ref, ext_ref, pred_ref, par_ref,
                 st2_ref, base2_ref, blk2_ref, pred2_ref, y_ref, *,
                 nk, G, S, chanbits, cb_max, kb, wb, rel0, cache_words,
                 r_rows, has_num, P):
    from .. import fused_decode as fd

    st = (st_ref[0, :], st_ref[1, :].astype(U32), st_ref[2, :].astype(U32),
          st_ref[3, :].astype(U32), st_ref[4, :], st_ref[5, :] != 0)
    blk_base = base_ref[0, :]
    blk = tuple(blk_ref[i, :].astype(U32) for i in range(cache_words))
    ext = tuple(ext_ref[i, :].astype(U32) for i in range(8 * r_rows))
    pred = tuple(pred_ref[i, :] for i in range(P))
    num = par_ref[7, :] if has_num else None

    par = dict(pb_v=par_ref[6, :].astype(U32), na_eff=par_ref[0, :],
               den=par_ref[1, :], denhalf=par_ref[2, :],
               mode_nz=par_ref[3, :] != 0, is0=par_ref[4, :] != 0,
               is31=par_ref[5, :] != 0)

    def substep(g, carry):
        # one loop body for every substep: the window reach is sized for
        # the last one (G-1), so the kernel compiles one substep, not G
        st, pred = carry
        st, pred, out = fd._substep_core(
            st, pred, blk, blk_base, G - 1, nk=nk, S=S, chanbits=chanbits,
            cb_max=cb_max, kb=kb, wb=wb, rel0=rel0, cache_words=cache_words,
            num=num, **par)
        y_ref[g, :] = out
        return st, pred

    st, pred = jax.lax.fori_loop(0, G, substep, (st, pred))
    st, blk_base, blk = fd._shift_cache(
        st, blk + ext, blk_base, rel0=rel0, cache_words=cache_words,
        r_rows=r_rows)

    for i, v in enumerate(st):
        st2_ref[i, :] = v.astype(I32)
    base2_ref[0, :] = blk_base
    for i in range(cache_words):
        blk2_ref[i, :] = blk[i].astype(I32)
    for i in range(P):
        pred2_ref[i, :] = pred[i]


def decode_step_pallas(st6, base1, blkS, extS, predS, parS, *, nk, G, S,
                       chanbits, cb_max, kb, wb, rel0, cache_words,
                       r_rows, has_num, interpret: bool = False):
    """One scan step on (rows, B) i32 stacks: state (6, B), cache base
    (1, B), cache (cache_words, B), fetched rows (8*r_rows, B),
    predictor state (P, B), lane parameters (8, B) -> updated stacks +
    (G, B) decoded samples.  B must be a multiple of ``LANES``."""
    B = st6.shape[1]
    P = predS.shape[0]

    def spec(n):
        return pl.BlockSpec((n, LANES), lambda i: (0, i))

    kern = functools.partial(
        _step_kernel, nk=nk, G=G, S=S, chanbits=chanbits, cb_max=cb_max,
        kb=kb, wb=wb, rel0=rel0, cache_words=cache_words, r_rows=r_rows,
        has_num=has_num, P=P)
    return pl.pallas_call(
        kern,
        grid=(B // LANES,),
        in_specs=[spec(_N_ST), spec(1), spec(cache_words), spec(8 * r_rows),
                  spec(P), spec(parS.shape[0])],
        out_specs=[spec(_N_ST), spec(1), spec(cache_words), spec(P),
                   spec(G)],
        out_shape=[jax.ShapeDtypeStruct((n, B), jnp.int32)
                   for n in (_N_ST, 1, cache_words, P, G)],
        compiler_params=compiler_params(),
        interpret=interpret,
        name="alacjax_decode_step",
    )(st6, base1, blkS, extS, predS, parS)
