"""zstd of the port: the host frame codec (RFC 8878) that the device
encoder and the batched device decoder need beside them.

``decompress`` is a copy of the JAX package's decoder
(``zstd/__init__.py``): the whole stream in one call of the host core
(``native_dec.decode_all``), else frame by frame, each frame's blocks on
the host core (``native_dec.decode_frame_body``) or, where it refuses
them, through the pure-Python block decoder, which gives the precise
error.  ``decompress_py`` runs the pure-Python decoder alone: the plain
version.  With ``dicts`` (``zstd.dict.Dict`` objects or their blobs, keyed
by id) every frame goes through the Python block decoder, its history
and tables started from the dictionary the frame names, as the
reference's do; without them a frame that names a dictionary raises
``ZstdError``.  ``split_frames`` walks the frame boundaries and
``decode_concurrent`` decodes the frames on a thread pool (the host core
releases the GIL).  ``compress`` is the host encoder
(``zstd/encoder.py``); the streaming Writer and Reader are in
``zstd/stream.py``.
"""

from __future__ import annotations

from compress_tpu_torch.utils.debuglog import dbg
from compress_tpu_torch.utils.xxhash64 import xxh64
from compress_tpu_torch.zstd import block as B
from compress_tpu_torch.zstd import native_dec
from compress_tpu_torch.zstd.block import BlockError, History
from compress_tpu_torch.zstd.frame import (FrameError, Header,
                                           parse_frame_header)

MAX_DECODED_SIZE = 64 << 30

__all__ = ["compress", "decompress", "decompress_py", "predef_seq_tables",
           "decode_concurrent", "split_frames", "ZstdError", "FrameError",
           "BlockError", "Header", "History", "parse_frame_header",
           "MAX_DECODED_SIZE", "compress_accel", "decompress_accel",
           "max_encoded_size", "encode_to", "decode_to"]


class ZstdError(ValueError):
    pass


def _dict_map(dicts) -> dict:
    from compress_tpu_torch.zstd.dict import Dict, load_dict

    out = {}
    for d in dicts or ():
        if not isinstance(d, Dict):
            d = load_dict(d)
        out[d.id] = d
    return out


def decompress(data, max_size: int = MAX_DECODED_SIZE,
               max_window: int = 1 << 31, dicts=None,
               ignore_checksum: bool = False) -> bytes:
    """Decode all frames in data (skippable frames are skipped); dicts as
    the reference's WithDecoderDicts (the module docstring)."""
    dict_map = _dict_map(dicts)
    data = bytes(data)
    if data and not dict_map:
        res = native_dec.decode_all(data, max_size, max_window,
                                    ignore_checksum)
        if res is not None:
            return res
    return _decode_frames(data, max_size, max_window, ignore_checksum, True,
                          dict_map)


def decompress_py(data, max_size: int = MAX_DECODED_SIZE,
                  max_window: int = 1 << 31,
                  ignore_checksum: bool = False) -> bytes:
    """``decompress`` in Python alone (the reference's Python decoder)."""
    return _decode_frames(bytes(data), max_size, max_window,
                          ignore_checksum, False)


def _decode_frames(data: bytes, max_size: int, max_window: int,
                   ignore_checksum: bool, native: bool,
                   dict_map=None) -> bytes:
    """Frame by frame; with ``native`` and no dictionaries, each frame's
    blocks on the host core where it takes them."""
    pos = 0
    out_all = bytearray()
    # empty input decodes to empty output
    while pos < len(data):
        try:
            h = parse_frame_header(data, pos)
        except FrameError as e:
            raise ZstdError(str(e)) from e
        if h.skippable:
            pos += h.header_size + h.skippable_size
            if pos > len(data):
                raise ZstdError("skippable frame overruns input")
            continue
        pos += h.header_size
        if h.window_size > max_window:
            raise ZstdError("window size exceeds limit")
        if (h.frame_content_size is not None
                and h.frame_content_size > max_size):
            raise ZstdError("decoded size exceeds limit")
        d = None
        if h.dict_id:
            d = (dict_map or {}).get(h.dict_id)
            if d is None:
                raise ZstdError(f"frame needs dictionary id {h.dict_id}")
        elif dict_map and 0 in dict_map:
            d = dict_map[0]
        res = None
        if native and not h.dict_id and not dict_map:
            res = native_dec.decode_frame_body(
                data, pos, max(h.window_size, 1024), max_size - len(out_all),
                expected=h.frame_content_size)
            dbg("zstd", "decompress frame@%d window=%d native=%s",
                pos, h.window_size, res is not None)
        if res is not None:
            frame_out, pos = res
        else:
            frame_out, pos = _decode_blocks(data, pos, h, max_size
                                            - len(out_all), d)
        if (h.frame_content_size is not None
                and len(frame_out) != h.frame_content_size):
            raise ZstdError("frame content size mismatch")
        if h.has_checksum:
            if pos + 4 > len(data):
                raise ZstdError("truncated checksum")
            if not ignore_checksum:
                want = int.from_bytes(data[pos:pos + 4], "little")
                if want != xxh64(bytes(frame_out)) & 0xFFFFFFFF:
                    raise ZstdError("checksum mismatch")
            pos += 4
        out_all += frame_out
    return bytes(out_all)


def _decode_blocks(data: bytes, pos: int, h: Header, max_size: int,
                   d=None):
    """(output, position after the last block) of the frame whose first
    block header is at pos, in Python; ``max_size`` is what the output
    may still hold.  A dictionary ``d`` starts the history: its content
    and repeat offsets, and, for a frame that names it, its tables."""
    hist = History(window_size=max(h.window_size, 1024))
    if d is not None:
        hist.window = bytearray(d.content)
        hist.rep_offsets = d.reps
        if h.dict_id:
            hist.huf_table = d.huf
            hist.t_ll, hist.t_of, hist.t_ml = d.t_ll, d.t_of, d.t_ml
    frame_out = bytearray()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last = bh & 1
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        max_out = min(B.MAX_BLOCK_SIZE, h.window_size or B.MAX_BLOCK_SIZE)
        if h.frame_content_size is not None:
            max_out = min(max(max_out, 1), B.MAX_BLOCK_SIZE)
        if btype == B.BLOCK_RAW:
            if pos + bsize > len(data):
                raise ZstdError("truncated raw block")
            out = data[pos:pos + bsize]
            pos += bsize
        elif btype == B.BLOCK_RLE:
            if pos >= len(data):
                raise ZstdError("truncated RLE block")
            if bsize > B.MAX_BLOCK_SIZE:
                raise ZstdError("RLE block too large")
            out = bytes([data[pos]]) * bsize
            pos += 1
        elif btype == B.BLOCK_COMPRESSED:
            if bsize > B.MAX_BLOCK_SIZE:
                raise ZstdError("compressed block too large")
            if pos + bsize > len(data):
                raise ZstdError("truncated compressed block")
            try:
                out = B.decode_block(data[pos:pos + bsize], hist,
                                     B.MAX_BLOCK_SIZE)
            except (ValueError, IndexError) as e:
                raise ZstdError(f"block decode failed: {e}") from e
            pos += bsize
        else:
            raise ZstdError("reserved block type")
        # Block_Maximum_Size = min(Window_Size, 128 KiB)
        if len(out) > max_out:
            raise ZstdError("block exceeds window maximum")
        hist.append(out)
        frame_out += out
        if len(frame_out) > max_size:
            raise ZstdError("decoded size exceeds limit")
        if last:
            break
    return frame_out, pos


def _frame_extent(data: bytes, pos: int):
    """(end offset past the checksum of the frame at pos, skippable?): a
    structural walk over the block headers, no decoding."""
    try:
        h = parse_frame_header(data, pos)
    except FrameError as e:
        raise ZstdError(str(e)) from e
    if h.skippable:
        end = pos + h.header_size + h.skippable_size
        if end > len(data):
            raise ZstdError("skippable frame overruns input")
        return end, True
    p = pos + h.header_size
    while True:
        if p + 3 > len(data):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[p:p + 3], "little")
        p += 3
        btype = (bh >> 1) & 3
        if btype == 3:
            raise ZstdError("reserved block type")
        p += 1 if btype == B.BLOCK_RLE else bh >> 3
        if p > len(data):
            raise ZstdError("truncated block")
        if bh & 1:
            break
    if h.has_checksum:
        p += 4
        if p > len(data):
            raise ZstdError("truncated checksum")
    return p, False


def split_frames(data) -> list:
    """Byte spans [(start, end), ...] of the non-skippable frames in data."""
    data = bytes(data)
    spans = []
    pos = 0
    while pos < len(data):
        end, skippable = _frame_extent(data, pos)
        if not skippable:
            spans.append((pos, end))
        pos = end
    return spans


def decode_concurrent(data, workers: int = 4,
                      max_size: int = MAX_DECODED_SIZE,
                      max_window: int = 1 << 31,
                      ignore_checksum: bool = False) -> bytes:
    """Decode a multi-frame stream on a thread pool, a frame a task
    (reference: Decoder.DecodeAll used concurrently; the host core
    releases the GIL, so the frames decode in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    data = bytes(data)
    spans = split_frames(data)
    if len(spans) <= 1 or workers <= 1:
        return decompress(data, max_size=max_size, max_window=max_window,
                          ignore_checksum=ignore_checksum)

    def one(span):
        lo, hi = span
        return decompress(data[lo:hi], max_size=max_size,
                          max_window=max_window,
                          ignore_checksum=ignore_checksum)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(one, spans))
    if sum(len(p) for p in parts) > max_size:
        raise ZstdError("decoded size exceeds limit")
    return b"".join(parts)


from compress_tpu_torch.zstd.encoder import (compress,  # noqa: E402
                                             predef_seq_tables)


def encode_to(dst, src, level: int = 1) -> bytes:
    """dst followed by one zstd frame of src (reference: zstd.EncodeTo)."""
    out = bytearray(dst) if dst is not None else bytearray()
    out += compress(src, level=level)
    return bytes(out)


def decode_to(dst, src, max_size: int = MAX_DECODED_SIZE) -> bytes:
    """dst followed by the decoded frames of src (reference:
    zstd.DecodeTo)."""
    out = bytearray(dst) if dst is not None else bytearray()
    out += decompress(src, max_size=max_size)
    return bytes(out)


def max_encoded_size(n: int) -> int:
    """Worst-case one-frame size for an n-byte input (reference:
    Encoder.MaxEncodedSize): a frame header of at most 14 bytes, n bytes in
    raw blocks of 128 KiB with 3-byte headers (at least one), a 4-byte
    checksum."""
    if n < 0:
        raise ValueError("negative size")
    blocks = max((n + (1 << 17) - 1) >> 17, 1)
    return n + 14 + 3 * blocks + 4


def compress_accel(data, level: int = 1, max_rounds: int = 4,
                   multi_block: bool = False) -> bytes:
    """Encode with the device-decode accel sidecars before the frames
    (``zstd/accel.py``); the result is a standard zstd stream.
    ``multi_block`` writes one frame of 64 KiB blocks with matches across
    blocks (decoded with a carried history)."""
    from compress_tpu_torch.zstd.accel import compress_accel as _ca

    return _ca(data, level=level, max_rounds=max_rounds,
               multi_block=multi_block)


def decompress_accel(blob, mesh=None, device=None) -> bytes:
    """Decode a ``compress_accel`` stream with the batched device decoder
    (no per-symbol host work for frames with a sidecar, the host decoder
    for shapes it does not take).  mesh: an optional
    ``parallel.BlockMesh`` to decode its items over the ranks; device as
    for ``decompress_frames_device``."""
    from compress_tpu_torch.zstd.accel import split_stream_accel
    from compress_tpu_torch.zstd.device_dec import decompress_frames_device

    items = split_stream_accel(blob)
    if not items:
        return b""
    return b"".join(decompress_frames_device(items, device=device,
                                             mesh=mesh))
