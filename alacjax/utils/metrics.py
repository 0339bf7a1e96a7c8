"""Per-run structured metrics and profiling annotations (SURVEY.md §5:
metrics/observability row).

StreamReport aggregates what the reference tracked internally
(mTotalBytesGenerated / mMaxFrameBytes / mAvgBitRate) plus the
device counters: frames/sec/chip, escape-frame rate, compression
ratio, and per-stage wall-clock shares.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time


def stage_annotation(name: str):
    """jax.profiler trace annotation for a pipeline stage (mix / predict /
    rice / pack); no-op outside profiling sessions."""
    try:
        import jax
        return jax.profiler.TraceAnnotation(f"alacjax.{name}")
    except Exception:  # profiling unavailable — stay silent
        return contextlib.nullcontext()


class StageTimer:
    """Accumulates wall-clock per named stage (host-side timing)."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def shares(self) -> dict[str, float]:
        total = sum(self.totals.values()) or 1.0
        return {k: round(v / total, 4) for k, v in self.totals.items()}


@dataclasses.dataclass
class StreamReport:
    """Structured per-run report for one encode or decode stream."""

    frames: int = 0
    samples: int = 0
    channels: int = 0
    bit_depth: int = 0
    sample_rate: int = 0
    pcm_bytes: int = 0
    packet_bytes: int = 0
    escape_frames: int = 0
    max_frame_bytes: int = 0
    seconds: float = 0.0
    stage_seconds: dict = dataclasses.field(default_factory=dict)

    def add_packet(self, nbytes: int, escaped: bool = False):
        self.frames += 1
        self.packet_bytes += nbytes
        self.max_frame_bytes = max(self.max_frame_bytes, nbytes)
        if escaped:
            self.escape_frames += 1

    @property
    def compression_ratio(self) -> float:
        return self.packet_bytes / self.pcm_bytes if self.pcm_bytes else 0.0

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    @property
    def avg_bit_rate(self) -> int:
        if not self.samples:
            return 0
        return int(self.packet_bytes * 8 * self.sample_rate // self.samples)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            compression_ratio=round(self.compression_ratio, 4),
            frames_per_sec=round(self.frames_per_sec, 1),
            avg_bit_rate=self.avg_bit_rate,
            escape_rate=round(self.escape_frames / self.frames, 4)
            if self.frames else 0.0,
        )
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
