"""alacjax — batched Apple Lossless (ALAC) codec on the GPU.

From-scratch JAX/Pallas rebuild of the ALAC encoder/decoder pipeline
(see SURVEY.md for the structural analysis of the reference).

Public surface:
  * AlacConfig              — codec configuration (== magic-cookie fields)
  * ALACEncoder/ALACDecoder — packet codec (oracle/host path today;
                              device-batched path in alacjax.codec)
  * serialize_cookie/parse_cookie — the 24/48-byte config contract
  * BitBuffer               — MSB-first bitstream cursor
"""

from .types import (
    AlacConfig, AlacError, AlacParamError, AlacUnimplementedError,
    ElementTag,
)
from .cookie import parse_cookie, serialize_cookie
from .bitbuffer import BitBuffer
from .oracle import ALACDecoder, ALACEncoder
from .reader import AlacReader

__version__ = "0.1.0"

__all__ = [
    "AlacConfig", "AlacError", "AlacParamError", "AlacUnimplementedError",
    "ElementTag", "parse_cookie", "serialize_cookie", "BitBuffer",
    "ALACEncoder", "ALACDecoder", "AlacReader", "__version__",
]
