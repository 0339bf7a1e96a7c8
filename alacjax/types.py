"""Shared types, enums, constants and error codes for the ALAC codec.

Rebuild of the vocabulary defined by the reference header
``codec/ALACAudioTypes.h`` (see SURVEY.md §2 row 1).  Everything here is
host-side configuration; device code receives plain integers derived from
these values so that jit specialization stays static.
"""

from __future__ import annotations

import dataclasses
import enum

# ---------------------------------------------------------------------------
# Limits (reference: codec/ALACAudioTypes.h)
# ---------------------------------------------------------------------------
kALACMaxChannels = 8
kALACMaxEscapeHeaderBytes = 8
kALACMaxSearches = 16
kALACMaxCoefs = 16
kALACDefaultFramesPerPacket = 4096
kALACMaxSampleSize = 32
kALACDefaultFrameSize = 4096

# ---------------------------------------------------------------------------
# Error codes (reference: codec/ALACAudioTypes.h)
# ---------------------------------------------------------------------------
kALAC_noErr = 0
kALAC_UnimplementedError = -4
kALAC_FileNotFoundError = -43
kALAC_ParamError = -50
kALAC_MemFullError = -108


class AlacError(Exception):
    """Typed exception carrying the reference status-code contract."""

    def __init__(self, status: int, msg: str = ""):
        super().__init__(f"ALAC error {status}: {msg}" if msg else f"ALAC error {status}")
        self.status = status


class AlacParamError(AlacError):
    def __init__(self, msg: str = ""):
        super().__init__(kALAC_ParamError, msg)


class AlacUnimplementedError(AlacError):
    def __init__(self, msg: str = ""):
        super().__init__(kALAC_UnimplementedError, msg)


# ---------------------------------------------------------------------------
# Element tags (reference: codec/ALACAudioTypes.h element ID enum)
# ---------------------------------------------------------------------------
class ElementTag(enum.IntEnum):
    SCE = 0   # single channel element
    CPE = 1   # channel pair element
    CCE = 2   # coupling channel element (unsupported)
    LFE = 3   # LFE channel element
    DSE = 4   # data stream element (skipped)
    PCE = 5   # program config element (unsupported)
    FIL = 6   # fill element (skipped)
    END = 7   # end of frame


ID_SCE = int(ElementTag.SCE)
ID_CPE = int(ElementTag.CPE)
ID_CCE = int(ElementTag.CCE)
ID_LFE = int(ElementTag.LFE)
ID_DSE = int(ElementTag.DSE)
ID_PCE = int(ElementTag.PCE)
ID_FIL = int(ElementTag.FIL)
ID_END = int(ElementTag.END)

# ---------------------------------------------------------------------------
# Channel layout tags (reference: codec/ALACAudioTypes.h channel layout enum;
# value = (AudioChannelLayoutTag id << 16) | nChannels)
# ---------------------------------------------------------------------------
kALACChannelLayoutTag_Mono = (100 << 16) | 1
kALACChannelLayoutTag_Stereo = (101 << 16) | 2
kALACChannelLayoutTag_MPEG_3_0_B = (113 << 16) | 3
kALACChannelLayoutTag_MPEG_4_0_B = (116 << 16) | 4
kALACChannelLayoutTag_MPEG_5_0_D = (120 << 16) | 5
kALACChannelLayoutTag_MPEG_5_1_D = (124 << 16) | 6
kALACChannelLayoutTag_AAC_6_1 = (142 << 16) | 7
kALACChannelLayoutTag_MPEG_7_1_B = (127 << 16) | 8

# index = numChannels, entry = layout tag (reference: ALACChannelLayoutTags[])
ALAC_CHANNEL_LAYOUT_TAGS = (
    None,
    kALACChannelLayoutTag_Mono,
    kALACChannelLayoutTag_Stereo,
    kALACChannelLayoutTag_MPEG_3_0_B,
    kALACChannelLayoutTag_MPEG_4_0_B,
    kALACChannelLayoutTag_MPEG_5_0_D,
    kALACChannelLayoutTag_MPEG_5_1_D,
    kALACChannelLayoutTag_AAC_6_1,
    kALACChannelLayoutTag_MPEG_7_1_B,
)

# Element composition per channel count (reference: ALACEncoder.cpp channel
# maps / ALACDecoder.cpp element dispatch; SURVEY.md §2 row 10).
# Each entry: tuple of (ElementTag, n_channels_in_element).
ELEMENT_LAYOUTS = {
    1: ((ElementTag.SCE, 1),),
    2: ((ElementTag.CPE, 2),),
    3: ((ElementTag.SCE, 1), (ElementTag.CPE, 2)),
    4: ((ElementTag.SCE, 1), (ElementTag.CPE, 2), (ElementTag.SCE, 1)),
    5: ((ElementTag.SCE, 1), (ElementTag.CPE, 2), (ElementTag.CPE, 2)),
    6: ((ElementTag.SCE, 1), (ElementTag.CPE, 2), (ElementTag.CPE, 2),
        (ElementTag.LFE, 1)),
    7: ((ElementTag.SCE, 1), (ElementTag.CPE, 2), (ElementTag.CPE, 2),
        (ElementTag.SCE, 1), (ElementTag.LFE, 1)),
    8: ((ElementTag.SCE, 1), (ElementTag.CPE, 2), (ElementTag.CPE, 2),
        (ElementTag.CPE, 2), (ElementTag.LFE, 1)),
}

# ---------------------------------------------------------------------------
# Rice / adaptive-Golomb tuning constants (reference: codec/aglib.h)
# ---------------------------------------------------------------------------
QBSHIFT = 9
QB = 1 << QBSHIFT
PBSHIFT = 9
PB0 = 40
MB0 = 10
KB0 = 14
MAX_RUN_DEFAULT = 255
MMULSHIFT = 2
MDENSHIFT = QBSHIFT - MMULSHIFT - 1          # = 6
MOFF = 1 << (MDENSHIFT - 2)                  # = 16
BITOFF = 24
MAX_PREFIX_16 = 9
MAX_PREFIX_32 = 9
MAX_DATATYPE_BITS_16 = 16
N_MAX_MEAN_CLAMP = 0xFFFF
N_MEAN_CLAMP_VAL = 0xFFFF
MAX_RICE_NUMBITS = 25        # non-escape Rice codeword cap (ag_enc.c :: dyn_code_32bit)

# ---------------------------------------------------------------------------
# Predictor tuning constants (reference: codec/dplib.h)
# ---------------------------------------------------------------------------
DENSHIFT_DEFAULT = 9
DENSHIFT_MAX = 15
AINIT = 38
BINIT = -29
CINIT = -2


@dataclasses.dataclass(frozen=True)
class AlacConfig:
    """Frozen codec configuration == the ``ALACSpecificConfig`` wire struct.

    Field order and widths mirror the 24-byte magic-cookie core
    (reference: codec/ALACAudioTypes.h :: ALACSpecificConfig; serialized
    big-endian by cookie.py).  Extra, non-wire knobs live at the bottom.
    """

    frame_length: int = kALACDefaultFrameSize   # u32
    compatible_version: int = 0                 # u8, must be 0
    bit_depth: int = 16                         # u8: 16/20/24/32
    pb: int = PB0                               # u8 rice modifier
    mb: int = MB0                               # u8 rice history mult
    kb: int = KB0                               # u8 rice k limit
    num_channels: int = 2                       # u8: 1..8
    max_run: int = MAX_RUN_DEFAULT              # u16
    max_frame_bytes: int = 0                    # u32 (0 = unknown)
    avg_bit_rate: int = 0                       # u32 (0 = unknown)
    sample_rate: int = 44100                    # u32

    # --- rebuild-only knobs (not serialized in the cookie) ---
    fast_mode: bool = False
    # encoder parameter search: "standard" (dilated mixres trial, the
    # reference dialect) or "exhaustive" (every mixres priced at full
    # rate — best rate; device-batched in codec.py, host in oracle/native)
    search: str = "standard"

    def __post_init__(self):
        if self.search not in ("standard", "exhaustive"):
            raise AlacParamError(f"unknown search mode {self.search!r}")
        if self.bit_depth not in (16, 20, 24, 32):
            raise AlacParamError(f"unsupported bit depth {self.bit_depth}")
        if not (1 <= self.num_channels <= kALACMaxChannels):
            raise AlacParamError(f"unsupported channel count {self.num_channels}")
        if self.compatible_version != 0:
            raise AlacParamError("compatibleVersion must be 0")
        if self.frame_length <= 0:
            raise AlacParamError("frameLength must be positive")

    @property
    def channel_layout_tag(self) -> int:
        return ALAC_CHANNEL_LAYOUT_TAGS[self.num_channels]

    @property
    def elements(self):
        return ELEMENT_LAYOUTS[self.num_channels]

    def max_escape_packet_bytes(self, num_samples: int | None = None) -> int:
        """Upper bound on one packet's encoded size (escape frame + headers)."""
        n = self.frame_length if num_samples is None else num_samples
        per_elem_overhead = 16  # header + partial-frame field, generous
        return (
            n * self.num_channels * ((self.bit_depth + 7) // 8 + 1)
            + len(self.elements) * per_elem_overhead
            + kALACMaxEscapeHeaderBytes
        )


def sign_extend(value: int, bits: int) -> int:
    """Sign-extend the low ``bits`` bits of ``value`` (python int) — the
    portable equivalent of the reference's ``(x << (32-bits)) >> (32-bits)``
    arithmetic-shift idiom."""
    value &= (1 << bits) - 1
    if value & (1 << (bits - 1)):
        value -= 1 << bits
    return value


def lead(m: int) -> int:
    """Number of leading zero bits in the 32-bit value ``m``.

    Reference: codec/aglib.h-adjacent helper ``lead()`` in ag_enc.c/ag_dec.c
    (loop over bit 31..0; lead(0) == 32).
    """
    m &= 0xFFFFFFFF
    for j in range(32):
        if m & (0x80000000 >> j):
            return j
    return 32


def lg3a(x: int) -> int:
    """floor(log2(x + 3)) — Rice parameter from mean estimate.

    Reference: ag_enc.c :: lg3a() — ``31 - lead(x + 3)``.
    """
    return 31 - lead((x + 3) & 0xFFFFFFFF)
