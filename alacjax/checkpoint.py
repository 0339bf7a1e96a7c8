"""Checkpoint / resume for long batch conversions (SURVEY.md §5).

The reference has no checkpointing; the batched rebuild's unit of recovery is
the packet shard: a preempted job resumes at chunk granularity.  The
journal design keeps the invariant that everything written is complete:

    <out>.journal        json header: config, chunk size, frames done
    <out>.packets        concatenated finished packets (append-only)
    <out>.sizes          u32 little-endian per-packet byte sizes

``resumable_encode`` appends a chunk of packets + sizes, fsyncs, then
updates the journal; a crash between steps loses at most one chunk of
work and never corrupts output.  ``finalize`` assembles the real
container (CAF, or M4A by output extension) and removes the sidecars.
Works with any packet-codec backend.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np

from .containers.caf import CafFile, write_caf
from .containers.pcm import unpack_pcm
from .containers.wav import read_wav
from .cookie import serialize_cookie
from .types import AlacConfig, AlacParamError

JOURNAL_VERSION = 1


@dataclasses.dataclass
class EncodeState:
    frames_done: int          # full frames encoded so far
    num_frames: int           # total full frames
    num_samples: int          # total samples (incl. partial tail)
    config: AlacConfig


def _paths(out_path: str):
    return out_path + ".journal", out_path + ".packets", out_path + ".sizes"


def load_state(out_path: str) -> EncodeState | None:
    jp, pp, sp = _paths(out_path)
    if not os.path.exists(jp):
        return None
    with open(jp) as f:
        j = json.load(f)
    if j.get("version") != JOURNAL_VERSION:
        raise AlacParamError("unknown journal version")
    cfg = AlacConfig(**j["config"])
    st = EncodeState(frames_done=j["frames_done"], num_frames=j["num_frames"],
                     num_samples=j["num_samples"], config=cfg)
    # consistency: sizes file must contain exactly frames_done entries and
    # the packets file their total bytes; truncate any torn tail
    n_sizes = os.path.getsize(sp) // 4 if os.path.exists(sp) else 0
    if n_sizes < st.frames_done:
        st.frames_done = n_sizes
    sizes = _read_sizes(sp, st.frames_done)
    want = int(sizes.sum())
    have = os.path.getsize(pp) if os.path.exists(pp) else 0
    while st.frames_done and have < want:
        st.frames_done -= 1
        want -= int(sizes[st.frames_done])
    return st


def _read_sizes(sp: str, n: int) -> np.ndarray:
    if not os.path.exists(sp) or n == 0:
        return np.zeros(0, dtype=np.uint32)
    with open(sp, "rb") as f:
        return np.frombuffer(f.read(4 * n), dtype="<u4").copy()


def _write_journal(out_path: str, st: EncodeState) -> None:
    jp, _, _ = _paths(out_path)
    cfg = dataclasses.asdict(st.config)
    tmp = jp + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": JOURNAL_VERSION, "frames_done": st.frames_done,
                   "num_frames": st.num_frames,
                   "num_samples": st.num_samples, "config": cfg}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, jp)


def resumable_encode(wav_path: str, out_path: str,
                     frame_length: int = 4096, backend: str = "jax",
                     chunk_frames: int = 256, fast_mode: bool = False,
                     _fail_after_chunks: int | None = None) -> EncodeState:
    """Encode WAV -> CAF with chunk-level checkpointing.

    Safe to re-invoke after interruption: finished chunks are never
    redone.  ``_fail_after_chunks`` is a fault-injection hook for tests.
    Returns the final state (call ``finalize`` when frames_done ==
    num_frames).
    """
    from .convert import get_backend
    encode_stream, _ = get_backend(backend)

    wav = read_wav(wav_path)
    config = AlacConfig(frame_length=frame_length, bit_depth=wav.bit_depth,
                        num_channels=wav.num_channels,
                        sample_rate=wav.sample_rate, fast_mode=fast_mode)
    pcm = unpack_pcm(wav.data, wav.bit_depth, wav.num_channels)
    n = pcm.shape[1]
    nf = n // frame_length

    st = load_state(out_path)
    if st is None or st.config != config or st.num_samples != n:
        st = EncodeState(frames_done=0, num_frames=nf, num_samples=n,
                         config=config)
        jp, pp, sp = _paths(out_path)
        for p in (pp, sp):
            open(p, "wb").close()
        _write_journal(out_path, st)

    jp, pp, sp = _paths(out_path)
    # drop any torn tail past the consistent prefix
    sizes = _read_sizes(sp, st.frames_done)
    with open(pp, "r+b") as f:
        f.truncate(int(sizes.sum()))
    with open(sp, "r+b") as f:
        f.truncate(4 * st.frames_done)

    chunks_done = 0
    while st.frames_done < st.num_frames:
        lo = st.frames_done
        hi = min(lo + chunk_frames, st.num_frames)
        frames = np.transpose(
            pcm[:, lo * frame_length: hi * frame_length]
            .reshape(config.num_channels, hi - lo, frame_length), (1, 0, 2))
        packets = _encode_frames(encode_stream, config, frames, frame_length)
        with open(pp, "ab") as f:
            for p in packets:
                f.write(p)
            f.flush()
            os.fsync(f.fileno())
        with open(sp, "ab") as f:
            f.write(np.asarray([len(p) for p in packets],
                               dtype="<u4").tobytes())
            f.flush()
            os.fsync(f.fileno())
        st.frames_done = hi
        _write_journal(out_path, st)
        chunks_done += 1
        if _fail_after_chunks is not None and chunks_done >= _fail_after_chunks:
            raise RuntimeError("injected failure (checkpoint test)")
    return st


def _encode_frames(encode_stream, config, frames, frame_length):
    flat = np.transpose(frames, (1, 0, 2)).reshape(
        config.num_channels, -1)
    return encode_stream(config, flat)


def finalize(wav_path: str, out_path: str, backend: str = "jax") -> None:
    """Assemble the final CAF from the journal (plus the partial tail)."""
    st = load_state(out_path)
    if st is None:
        raise AlacParamError("no journal to finalize")
    if st.frames_done != st.num_frames:
        raise AlacParamError(
            f"encode incomplete: {st.frames_done}/{st.num_frames} frames")
    wav = read_wav(wav_path)
    pcm = unpack_pcm(wav.data, wav.bit_depth, wav.num_channels)
    cfg = st.config
    jp, pp, sp = _paths(out_path)
    sizes = _read_sizes(sp, st.frames_done)
    with open(pp, "rb") as f:
        blob = f.read()
    packets = []
    off = 0
    for s in sizes:
        packets.append(blob[off:off + int(s)])
        off += int(s)

    rem = st.num_samples - st.num_frames * cfg.frame_length
    if rem:
        from .oracle import ALACEncoder
        enc = ALACEncoder(cfg, independent_frames=True)
        packets.append(enc.encode_packet(pcm[:, -rem:]))

    import dataclasses as dc
    total = sum(map(len, packets))
    cfg_out = dc.replace(
        cfg, max_frame_bytes=max(map(len, packets)) if packets else 0,
        avg_bit_rate=int(total * 8 * cfg.sample_rate // st.num_samples)
        if st.num_samples else 0)
    caf = CafFile(sample_rate=cfg.sample_rate, bit_depth=cfg.bit_depth,
                  num_channels=cfg.num_channels,
                  frames_per_packet=cfg.frame_length,
                  cookie=serialize_cookie(cfg_out), packets=packets,
                  num_valid_frames=st.num_samples)
    if out_path.lower().endswith((".m4a", ".mp4")):
        from .containers.mp4 import write_m4a
        write_m4a(caf, out_path)
    else:
        write_caf(caf, out_path)
    for p in _paths(out_path):
        if os.path.exists(p):
            os.remove(p)
