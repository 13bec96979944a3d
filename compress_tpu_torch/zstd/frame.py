"""zstd frame header (RFC 8878 §3.1.1): a copy of the JAX package's
``zstd/frame.py`` writer and parser (skippable frames included)."""

from __future__ import annotations

from dataclasses import dataclass

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


SKIPPABLE_MAGIC_BASE = 0x184D2A50  # low nibble 0..F


def descriptor_window(wd: int) -> int:
    exp = (wd >> 3) + MIN_WINDOW_LOG
    base = 1 << exp
    return base + (base // 8) * (wd & 7)


@dataclass
class Header:
    """A decoded frame header (the reference's ``Header`` record)."""

    single_segment: bool = False
    window_size: int = 0
    dict_id: int = 0
    has_checksum: bool = False
    frame_content_size: int | None = None
    skippable: bool = False
    skippable_id: int = 0
    skippable_size: int = 0
    header_size: int = 0
    # first-block info
    first_block_ok: bool = False
    first_block_last: bool = False
    first_block_type: int = 0
    first_block_size: int = 0


def parse_frame_header(buf: bytes, pos: int = 0) -> Header:
    """Parse magic + header; raises FrameError on anything invalid.

    header_size is relative to pos (magic included)."""
    h = Header()
    start = pos
    if pos + 4 > len(buf):
        raise FrameError("truncated magic")
    magic = int.from_bytes(buf[pos:pos + 4], "little")
    pos += 4
    if (magic & 0xFFFFFFF0) == SKIPPABLE_MAGIC_BASE:
        if pos + 4 > len(buf):
            raise FrameError("truncated skippable size")
        h.skippable = True
        h.skippable_id = magic & 0xF
        h.skippable_size = int.from_bytes(buf[pos:pos + 4], "little")
        h.header_size = pos + 4 - start
        return h
    if magic != MAGIC:
        raise FrameError("bad magic")
    if pos >= len(buf):
        raise FrameError("truncated FHD")
    fhd = buf[pos]
    pos += 1
    if fhd & 0x08:
        raise FrameError("reserved FHD bit set")
    h.single_segment = bool(fhd & 0x20)
    h.has_checksum = bool(fhd & 0x04)
    did_bytes = [0, 1, 2, 4][fhd & 0x03]
    fcs_code = fhd >> 6
    fcs_bytes = [0, 2, 4, 8][fcs_code]
    if h.single_segment and fcs_code == 0:
        fcs_bytes = 1
    if not h.single_segment:
        if pos >= len(buf):
            raise FrameError("truncated window descriptor")
        h.window_size = descriptor_window(buf[pos])
        pos += 1
    if did_bytes:
        if pos + did_bytes > len(buf):
            raise FrameError("truncated dict id")
        h.dict_id = int.from_bytes(buf[pos:pos + did_bytes], "little")
        pos += did_bytes
    if fcs_bytes:
        if pos + fcs_bytes > len(buf):
            raise FrameError("truncated FCS")
        v = int.from_bytes(buf[pos:pos + fcs_bytes], "little")
        if fcs_bytes == 2:
            v += 256
        h.frame_content_size = v
        pos += fcs_bytes
    if h.single_segment:
        h.window_size = h.frame_content_size or 0
    h.header_size = pos - start
    # peek at the first block header
    if pos + 3 <= len(buf):
        bh = int.from_bytes(buf[pos:pos + 3], "little")
        h.first_block_ok = True
        h.first_block_last = bool(bh & 1)
        h.first_block_type = (bh >> 1) & 3
        h.first_block_size = bh >> 3
    return h


def write_skippable_frame(payload: bytes, magic_id: int = 0) -> bytes:
    if not 0 <= magic_id <= 0xF:
        raise FrameError("skippable id must be 0..15")
    out = bytearray((SKIPPABLE_MAGIC_BASE | magic_id).to_bytes(4, "little"))
    out += len(payload).to_bytes(4, "little")
    out += payload
    return bytes(out)


def calc_skippable_frame(written: int, pad_to: int) -> int:
    """Size of the skippable frame that pads ``written`` to a multiple of
    ``pad_to`` (reference: frameenc.go calcSkippableFrame): 0 where it is
    aligned already, else at least 8 bytes."""
    if pad_to <= 0:
        return 0
    rem = written % pad_to
    if rem == 0:
        return 0
    pad = pad_to - rem
    while pad < 8:
        pad += pad_to
    return pad
