"""Test configuration.

Multi-device semantics are tested on a simulated 8-device CPU mesh
(SURVEY.md §4 item 6): JAX must be configured before first import, so this
conftest sets the env vars at collection time.  The tier runs on the CPU
(``JAX_PLATFORMS`` unset or ``cpu``).  Tests of kernels compiled for the
card carry the ``gpu`` marker and the ``gpu`` fixture, which skips them
unless the first device is a GPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

# XLA_FLAGS is read lazily at first backend init, so the host-device-count
# flag must be set before any jax use.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# XLA CPU compile time is superlinear in scan-body size; the test tier
# doesn't need the throughput defaults (results are bit-identical at any
# unroll/G), and shrinking them cuts device-test compiles from minutes to
# seconds per program.
os.environ.setdefault("ALACJAX_SCAN_UNROLL", "1")
os.environ.setdefault("ALACJAX_DECODE_G", "2")

# get_codec auto-shards over all visible devices (codec._default_mesh),
# which on the simulated 8-device mesh would silently turn EVERY device
# test into an 8-way SPMD compile.  The general tiers pin 1 device; the
# sharding tests opt in explicitly (get_codec(devices=...), ShardedCodec,
# CLI --devices).
os.environ.setdefault("ALACJAX_DEVICES", "1")

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# NOTE: the persistent compilation cache stays OFF in the tests.  With it
# on, long multi-config runs intermittently executed the WRONG cached
# program ("Execution supplied 1 buffers but compiled program expected
# 3") or returned corrupt results — an XLA cache-key collision.
# utils.compile_cache.place_compile_cache() honours this switch.
jax.config.update("jax_enable_compilation_cache", False)

import hashlib

import numpy as np
import pytest


@pytest.fixture()
def gpu():
    """Skip unless JAX's first device is a GPU (tests marked ``gpu``)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture()
def rng(request):
    # deterministic PER TEST (seeded from the test id), so failures
    # reproduce in isolation regardless of execution order
    seed = int.from_bytes(
        hashlib.sha256(request.node.nodeid.encode()).digest()[:4], "big")
    return np.random.default_rng(seed)


def gen_pcm(rng, kind: str, nch: int, n: int, depth: int) -> np.ndarray:
    """Deterministic fixture PCM (SURVEY.md §4 workload fixtures):
    white noise (escape stress), sine mixtures (zero-run friendly),
    silence (pure zero-run), impulse trains."""
    full = 1 << (depth - 1)
    if kind == "noise":
        return rng.integers(-full, full, (nch, n))
    if kind == "sine":
        t = np.arange(n)
        base = (np.sin(t * 0.01)[None, :] * (full // 4)
                + np.sin(t * 0.1)[None, :] * 200).astype(np.int64)
        return np.clip(base + rng.integers(-3, 4, (nch, n)), -full, full - 1)
    if kind == "silence":
        return np.zeros((nch, n), dtype=np.int64)
    if kind == "impulse":
        x = np.zeros((nch, n), dtype=np.int64)
        x[:, ::211] = full - 1
        x[:, 7::401] = -full
        return x
    raise ValueError(kind)
