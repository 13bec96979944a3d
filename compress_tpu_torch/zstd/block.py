"""zstd block codec on the host: the literals and sequences sections, and
their execution against the frame's history (RFC 8878 §3.1.1.2-3).  A
copy of the JAX package's ``zstd/block.py``."""

from __future__ import annotations

from dataclasses import dataclass, field

from compress_tpu_torch.fse import core as fse_core
from compress_tpu_torch.huff0.batch import _decode_stream
from compress_tpu_torch.huff0.table import read_table
from compress_tpu_torch.zstd import seqs as S

MAX_BLOCK_SIZE = 1 << 17  # 128 KiB compressed-block ceiling

BLOCK_RAW = 0
BLOCK_RLE = 1
BLOCK_COMPRESSED = 2

LIT_RAW = 0
LIT_RLE = 1
LIT_COMPRESSED = 2
LIT_TREELESS = 3


class BlockError(ValueError):
    pass


@dataclass
class History:
    """Inter-block state of a frame."""

    window: bytearray = field(default_factory=bytearray)
    window_size: int = 1 << 22
    rep_offsets: tuple = (1, 4, 8)
    huf_table: tuple | None = None  # (sym_t, nb_t, max_bits)
    t_ll: S.STable | None = None
    t_of: S.STable | None = None
    t_ml: S.STable | None = None

    def append(self, data: bytes):
        self.window += data
        keep = self.window_size
        if len(self.window) > 2 * keep:
            del self.window[:len(self.window) - keep]


def raw_lit_size(block: bytes, pos: int, sf: int):
    """(regen, header bytes) of a raw or RLE literals section at pos."""
    b0 = block[pos]
    if sf in (0, 2):
        return b0 >> 3, 1
    if sf == 1:
        return (b0 >> 4) | (block[pos + 1] << 4), 2
    return (b0 >> 4) | (block[pos + 1] << 4) | (block[pos + 2] << 12), 3


def huff_lit_sizes(block: bytes, pos: int, sf: int):
    """(regen, compressed size, header bytes) of a Huffman literals
    section at pos."""
    hdr, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[sf]
    v = int.from_bytes(block[pos:pos + hdr], "little")
    return (v >> 4) & ((1 << bits) - 1), v >> (4 + bits), hdr


def decode_literals(block: bytes, pos: int, hist: History):
    """Parse and decode the literals section: (literals, new_pos)."""
    if pos >= len(block):
        raise BlockError("literals: empty")
    b0 = block[pos]
    lit_type = b0 & 3
    size_format = (b0 >> 2) & 3

    if lit_type in (LIT_RAW, LIT_RLE):
        if pos + {0: 1, 2: 1, 1: 2, 3: 3}[size_format] > len(block):
            raise BlockError("literals: truncated header")
        regen, hdr = raw_lit_size(block, pos, size_format)
        pos += hdr
        if regen > MAX_BLOCK_SIZE:
            raise BlockError("literals too large")
        if lit_type == LIT_RAW:
            if pos + regen > len(block):
                raise BlockError("literals: truncated raw")
            return block[pos:pos + regen], pos + regen
        if pos + 1 > len(block):
            raise BlockError("literals: truncated RLE")
        return bytes([block[pos]]) * regen, pos + 1

    # compressed / treeless
    streams = 1 if size_format == 0 else 4
    if pos + {0: 3, 1: 3, 2: 4, 3: 5}[size_format] > len(block):
        raise BlockError("literals: truncated header")
    regen, comp, hdr = huff_lit_sizes(block, pos, size_format)
    pos += hdr
    if regen > MAX_BLOCK_SIZE or comp > MAX_BLOCK_SIZE:
        raise BlockError("literals sizes out of range")
    if pos + comp > len(block):
        raise BlockError("literals: truncated body")
    body = block[pos:pos + comp]
    pos += comp

    bpos = 0
    if lit_type == LIT_COMPRESSED:
        sym_t, nb_t, max_bits, bpos = read_table(body, 0)
        hist.huf_table = (sym_t, nb_t, max_bits)
    else:
        if hist.huf_table is None:
            raise BlockError("treeless literals without a previous table")
        sym_t, nb_t, max_bits = hist.huf_table

    if streams == 1:
        lits = _decode_stream(body[bpos:], sym_t, nb_t, max_bits, regen)
        return lits.tobytes(), pos
    if bpos + 6 > len(body):
        raise BlockError("literals: truncated jump table")
    sizes = [int.from_bytes(body[bpos + 2 * k:bpos + 2 * k + 2], "little")
             for k in range(3)]
    bpos += 6
    seg = (regen + 3) // 4
    lens = [seg, seg, seg, regen - 3 * seg]
    if lens[3] < 0:
        raise BlockError("literals: bad stream split")
    out = bytearray()
    for k in range(4):
        size = sizes[k] if k < 3 else len(body) - bpos
        if size < 0 or bpos + size > len(body):
            raise BlockError("literals: stream truncated")
        out += _decode_stream(body[bpos:bpos + size], sym_t, nb_t, max_bits,
                              lens[k]).tobytes()
        bpos += size
    return bytes(out), pos


def _read_table(block: bytes, pos: int, mode: int, which: str, hist: History,
                prev: S.STable | None):
    max_sym, max_log, pnorm, plog = S.TABLE_PARAMS[which]
    if mode == S.MODE_PREDEFINED:
        return S.STable(pnorm, plog, S.MODE_PREDEFINED), pos
    if mode == S.MODE_RLE:
        if pos >= len(block):
            raise BlockError("seq RLE symbol truncated")
        sym = block[pos]
        if sym > max_sym:
            raise BlockError("seq RLE symbol out of range")
        return S.STable(None, 0, S.MODE_RLE, rle_symbol=sym), pos + 1
    if mode == S.MODE_FSE:
        norm, tl, pos = fse_core.read_ncount(block, pos, max_symbol=max_sym,
                                             max_table_log=max_log)
        return S.STable(norm, tl, S.MODE_FSE), pos
    if prev is None:
        raise BlockError("repeat mode without previous table")
    return prev, pos


def decode_sequences_section(block: bytes, pos: int, hist: History):
    """Parse the sequences section: (lls, mls, ofvals, new_pos)."""
    if pos >= len(block):
        raise BlockError("sequences: empty")
    b0 = block[pos]
    pos += 1
    if b0 == 0:
        return None, None, None, pos
    if b0 < 128:
        n_seqs = b0
    elif b0 < 255:
        if pos >= len(block):
            raise BlockError("sequences: truncated count")
        n_seqs = ((b0 - 128) << 8) + block[pos]
        pos += 1
    else:
        if pos + 2 > len(block):
            raise BlockError("sequences: truncated count")
        n_seqs = int.from_bytes(block[pos:pos + 2], "little") + 0x7F00
        pos += 2
    if pos >= len(block):
        raise BlockError("sequences: truncated modes")
    modes = block[pos]
    pos += 1
    if modes & 3:
        raise BlockError("sequences: reserved mode bits set")
    t_ll, pos = _read_table(block, pos, (modes >> 6) & 3, "ll", hist,
                            hist.t_ll)
    t_of, pos = _read_table(block, pos, (modes >> 4) & 3, "of", hist,
                            hist.t_of)
    t_ml, pos = _read_table(block, pos, (modes >> 2) & 3, "ml", hist,
                            hist.t_ml)
    hist.t_ll, hist.t_of, hist.t_ml = t_ll, t_of, t_ml
    lls, mls, ofvals = S.decode_sequences(block[pos:], n_seqs, t_ll, t_of,
                                          t_ml)
    return lls, mls, ofvals, len(block)


def execute_sequences(literals: bytes, lls, mls, ofvals, hist: History,
                      max_out: int) -> bytes:
    """Resolve repeat offsets and run the LZ copies against the history."""
    out = bytearray()
    hist_len = len(hist.window)
    lit_pos = 0
    r1, r2, r3 = hist.rep_offsets
    if lls is not None:
        for ll, ml, ofv in zip(lls.tolist(), mls.tolist(), ofvals.tolist()):
            if ofv > 3:
                offset = ofv - 3
                r1, r2, r3 = offset, r1, r2
            else:
                if ll == 0:
                    ofv += 1
                if ofv == 1:
                    offset = r1
                elif ofv == 2:
                    offset = r2
                    r1, r2 = r2, r1
                elif ofv == 3:
                    offset = r3
                    r1, r2, r3 = r3, r1, r2
                else:  # ofv == 4: rep1 - 1 (ll == 0 bumped a 3)
                    offset = r1 - 1
                    if offset <= 0:
                        raise BlockError("repeat offset underflow")
                    r1, r2, r3 = offset, r1, r2
            if lit_pos + ll > len(literals):
                raise BlockError("literal run overruns literals")
            out += literals[lit_pos:lit_pos + ll]
            lit_pos += ll
            # match copy
            cur = len(out)
            if offset > cur + hist_len:
                raise BlockError("match offset beyond history")
            if len(out) + ml > max_out:
                raise BlockError("output exceeds block limit")
            if offset > cur:
                # part (or all) comes from the history window
                take_hist = min(offset - cur, ml)
                start = hist_len - (offset - cur)
                out += hist.window[start:start + take_hist]
                ml -= take_hist
            while ml > 0:
                src = len(out) - offset
                take = min(ml, offset, len(out) - src)
                out += out[src:src + take]
                ml -= take
    # trailing literals
    out += literals[lit_pos:]
    hist.rep_offsets = (r1, r2, r3)
    return bytes(out)


def decode_block(block_body: bytes, hist: History, max_out: int) -> bytes:
    literals, pos = decode_literals(block_body, 0, hist)
    lls, mls, ofvals, pos = decode_sequences_section(block_body, pos, hist)
    out = execute_sequences(literals, lls, mls, ofvals, hist, max_out)
    if len(out) > max_out:
        raise BlockError("block output too large")
    return out
