from gzp_tpu_torch.formats.base import BlockFormatSpec, FooterValues, FormatSpec  # noqa: F401
from gzp_tpu_torch.formats.deflate_formats import (  # noqa: F401
    Bgzf,
    Gzip,
    Mgzip,
    RawDeflate,
    Zlib,
)
from gzp_tpu_torch.formats.snap import Snap  # noqa: F401

ALL_FORMATS = {f.name: f for f in (Gzip, Zlib, RawDeflate, Mgzip, Bgzf, Snap)}
