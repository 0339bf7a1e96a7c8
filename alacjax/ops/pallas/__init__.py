"""Pallas kernels on the Triton route for the GPU's three hot scans.

Each kernel runs a sequential recurrence with one thread per frame lane:
the grid covers lane blocks only, the whole sample loop runs inside one
program as a ``lax.fori_loop`` with the per-lane state as its carry, and
arrays are time-major ``(S, L)`` so every step's loads and stores are
coalesced across a warp.  As XLA while loops the same scans split into
a dozen or more fusions per sample step, each a kernel launch.

* ``cost_pallas.py``: fused predict + one or two adaptive-Rice cost
  machines (the encoder search).
* ``emit_pallas.py``: the Rice emission scan (phase-aligned word chunks).
* ``decode_step.py``: one fused-decode scan step (G Rice+FIR substeps and
  the cache shift); the scan and its per-lane row gather stay in XLA.

Every kernel body calls the same step function as its XLA scan
(``predict._general_step``, ``rice._emit_step``,
``fused_decode._substep_core``), so parity holds by construction and the
tests compare the two bit for bit.  Routing depends on the platform and
the shape only: ``gpu_kernels()`` is true on the GPU backend, and each
caller's envelope check adds the shape conditions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental.pallas import triton as plt

# Lanes per program: one lane per thread, one warp per program, so the
# grid is as wide as the lanes allow.  32, 64 and 128 timed the same on
# the H100 for the cost and emission kernels (PERF.md).
LANES = 32


def gpu_kernels() -> bool:
    """True where the Triton-route kernels run: the GPU backend."""
    return jax.default_backend() == "gpu"


def compiler_params() -> plt.CompilerParams:
    """Triton route, one lane per thread, no software pipelining (the
    loop body is a serial recurrence, not a stream of tile loads)."""
    return plt.CompilerParams(num_warps=LANES // 32, num_stages=1)


def pad_lanes(x, lanes: int, fill=0):
    """Pad the trailing (lane) axis of ``x`` up to a multiple of
    ``lanes`` with ``fill``."""
    pad = (-x.shape[-1]) % lanes
    if not pad:
        return x
    widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    return jnp.pad(x, widths, constant_values=fill)
