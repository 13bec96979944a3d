"""zstd frame header (RFC 8878 §3.1.1): a copy of the JAX package's
``zstd/frame.py`` writer."""

from __future__ import annotations

MAGIC = 0xFD2FB528

MIN_WINDOW_LOG = 10
MAX_WINDOW_LOG = 31


class FrameError(ValueError):
    pass


def window_descriptor(window_size: int) -> int:
    """Smallest descriptor byte whose window >= window_size."""
    for exp in range(MIN_WINDOW_LOG, MAX_WINDOW_LOG + 1):
        base = 1 << exp
        for mantissa in range(8):
            if base + (base // 8) * mantissa >= window_size:
                return ((exp - MIN_WINDOW_LOG) << 3) | mantissa
    raise FrameError("window too large")


def write_frame_header(content_size: int | None, window_size: int,
                       single_segment: bool, checksum: bool,
                       dict_id: int = 0) -> bytes:
    """Serialize magic + frame header."""
    out = bytearray(MAGIC.to_bytes(4, "little"))
    fhd = 0
    if checksum:
        fhd |= 1 << 2
    did_bytes = 0
    if dict_id:
        if dict_id < 1 << 8:
            did_bytes = 1
        elif dict_id < 1 << 16:
            did_bytes = 2
        else:
            did_bytes = 4
        fhd |= {1: 1, 2: 2, 4: 3}[did_bytes]
    fcs_code = 0
    fcs_bytes = 0
    if single_segment:
        if content_size is None:
            raise FrameError("single segment requires known content size")
        fhd |= 1 << 5
        if content_size >= 256 and content_size < 65536 + 256:
            fcs_code, fcs_bytes = 1, 2
        elif content_size < 256:
            fcs_code, fcs_bytes = 0, 1
        elif content_size <= 0xFFFFFFFF:
            fcs_code, fcs_bytes = 2, 4
        else:
            fcs_code, fcs_bytes = 3, 8
    elif content_size is not None:
        if content_size >= 256 and content_size < 65536 + 256:
            fcs_code, fcs_bytes = 1, 2
        elif content_size <= 0xFFFFFFFF:
            fcs_code, fcs_bytes = 2, 4
        elif content_size > 0xFFFFFFFF:
            fcs_code, fcs_bytes = 3, 8
        else:
            fcs_code, fcs_bytes = 0, 0  # < 256 but not single segment: omit
            content_size = None
    fhd |= fcs_code << 6
    out.append(fhd)
    if not single_segment:
        out.append(window_descriptor(window_size))
    if did_bytes:
        out += dict_id.to_bytes(did_bytes, "little")
    if content_size is not None and fcs_bytes:
        v = content_size - 256 if fcs_code == 1 else content_size
        out += v.to_bytes(fcs_bytes, "little")
    return bytes(out)
