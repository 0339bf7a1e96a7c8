"""Small JAX helpers shared by the device ops.

Integer semantics here mirror the C reference exactly: int32/uint32 wrap,
arithmetic right shift on signed, logical on unsigned (see oracle modules
for the defining scalar versions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32


def sign_extend(x, bits):
    """Sign-extend the low ``bits`` bits of int32 ``x``; ``bits`` may be a
    scalar or a per-lane array with fewer dims than ``x`` (broadcast on the
    leading axes).  C idiom: ``(x << (32-bits)) >> (32-bits)``."""
    x = x.astype(I32)
    if isinstance(bits, int):
        shift = 32 - bits
    else:
        shift = (32 - jnp.asarray(bits, dtype=I32))
        if shift.ndim and shift.ndim < x.ndim:
            shift = shift.reshape(shift.shape + (1,) * (x.ndim - shift.ndim))
    return jnp.right_shift(jnp.left_shift(x, shift), shift)


def sign_of_int(x):
    """dp_enc.c :: sign_of_int — +1 / 0 / -1 as int32."""
    return jnp.sign(x).astype(I32)


def clz32(x):
    """Count leading zeros of uint32 (lead(); clz(0) == 32).  Counted on
    the int32 bit pattern: the GPU kernels lower an int32 clz only."""
    return jax.lax.clz(jax.lax.bitcast_convert_type(x.astype(U32), I32))


def lg3a(x):
    """ag_enc.c :: lg3a — 31 - clz(x + 3) on uint32."""
    return 31 - clz32(x.astype(U32) + 3)


def wrap_u32(x):
    return x.astype(U32)


def arith_shift_right(x, n):
    """C ``>>`` on int32 (arithmetic)."""
    return jnp.right_shift(x.astype(I32), n)


def iota1(n: int, dtype=I32):
    """1-D iota as an in-graph HLO op.

    Use instead of jnp.arange inside traced code: arange materializes a
    concrete host constant, and on this jax build hoisted constants are
    intermittently LOST on repeat executions ("Computation compiled for N
    inputs but called with 1" / "Execution supplied 1 buffers...").
    lax.broadcasted_iota stays inside the program.
    """
    return jax.lax.broadcasted_iota(dtype, (n,), 0)
