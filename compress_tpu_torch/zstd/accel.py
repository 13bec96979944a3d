"""The accel sidecar: a copy of the JAX package's ``zstd/accel.py``.
``build_sidecar`` writes it (its payload from the host core's
``ct_zstd_build_sidecar``, ``sidecar_payload``; ``zstd/sidecar.py``
``build_payload`` is its plain version), ``compress_accel`` and
``split_stream_accel`` encode a stream with sidecars and cut it into the
items of the batched device decode, and ``split_sidecar``,
``parse_sidecar`` and ``accel_plan`` read it back.

An encoder may write, before a zstd frame, a skippable frame whose
payload carries the frame's decode checkpoints: per block the huff0
stream bit offsets every 32 literals, optionally the sequence checkpoints
(bit offset, 3 FSE states, 3 repeat offsets) every 8 sequences, and the
round-annotated execute plan.  Any zstd decoder skips it; the batched
device decoder (``zstd/device_dec.py``) then needs no per-symbol host
walk.  The payload may be S2-compressed ('CTA2') and is CRC-32C wrapped
('CTAC'): a corrupt sidecar is ignored.

Payload (little-endian): 'CTA3' u16 n_blocks, u16 hist_blocks, then per
block u8 flags (bit0 = device-eligible, bit1 = sequence checkpoints), u8
lit_kind (0 = 4X, 1 = raw, 2 = RLE, 3 = 1X), u32 regen, n_seqs,
total_out; per literal stream {u16 n; u32 cks[n]}; [bit1] u16 seq_nch;
seq_nch x {u32 bitpos; u16 s_ll, s_of, s_ml; u32 r1, r2, r3}; u32
n_pieces; u8 n_rounds; i32 src[n]; u8 len[n]; u8 round[n].
"""

from __future__ import annotations

import numpy as np

from compress_tpu_torch import _native
from compress_tpu_torch.ops.execute import ARENA_ROWS, HIST_BASE, OUT_BASE
from compress_tpu_torch.s2 import block as s2block
from compress_tpu_torch.utils.crc import crc32c
from compress_tpu_torch.zstd import _frame_extent
from compress_tpu_torch.zstd.encoder import compress, compress_frame_bs
from compress_tpu_torch.zstd.frame import parse_frame_header

SKIP_MAGIC = 0x184D2A50  # first of the 16 skippable magics
ACCEL_MAGIC = b"CTA3"
SEG = 1 << 16  # one 64 KiB block per execute step


def sidecar_payload(body: bytes, max_rounds: int = 4, seq_cks: bool = False,
                    hist_blocks: int = 0) -> bytes | None:
    """The sidecar payload ('CTA3') of a frame's body (the bytes after its
    header), from one call of ``ct_zstd_build_sidecar`` (retried with 4
    times the room while it reports too little), or None where it refuses
    the frame.  ``sidecar.build_payload`` is its plain version."""
    body = bytes(body)
    padded = body + b"\x00" * 16     # the native bit readers' over-read
    cap = 16 * len(body) + (1 << 16)
    lib = _native.library()
    while True:
        oarr, out = _native.out_buf(cap)
        r = lib.ct_zstd_build_sidecar(padded, len(body), int(max_rounds),
                                      1 if seq_cks else 0, int(hist_blocks),
                                      out, cap)
        if r != -3:           # E_SPACE
            break
        cap *= 4
    return oarr[:r].tobytes() if r > 0 else None


def build_sidecar(frame: bytes, max_rounds: int = 4, seq_cks: bool = False,
                  hist_blocks: int = 0) -> bytes | None:
    """The accel sidecar of one zstd frame, as a whole skippable frame, or
    None where the frame is not eligible (``sidecar_payload``).  A
    multi-block frame is eligible when every block but the last decodes
    to exactly 64 KiB and every offset reaches back at most
    ``hist_blocks`` blocks; ``seq_cks`` also writes the sequence
    checkpoints.  The payload is S2-packed ('CTA2') where that is shorter,
    then CRC-32C wrapped ('CTAC'): a corrupt sidecar is ignored, never
    planned."""
    h = parse_frame_header(frame)
    payload = sidecar_payload(frame[h.header_size:], max_rounds, seq_cks,
                              hist_blocks)
    if payload is None or not payload[8] & 1:   # first block not eligible
        return None
    packed = b"CTA2" + s2block.encode(payload)
    if len(packed) < len(payload):
        payload = packed
    payload = (b"CTAC" + (crc32c(payload) & 0xFFFFFFFF).to_bytes(4, "little")
               + payload)
    return ((SKIP_MAGIC | 0xA).to_bytes(4, "little")
            + len(payload).to_bytes(4, "little") + payload)


def compress_accel(data, level: int = 1, max_rounds: int = 4,
                   multi_block: bool = False, hist_blocks: int = 8) -> bytes:
    """One-shot encode with the device-decode sidecars before the frames:
    a standard zstd stream (the sidecars are skippable frames).

    By default an input over 64 KiB is cut into independent single-block
    frames, each with its sidecar.  ``multi_block`` instead writes one
    frame of 64 KiB blocks whose matches reach back ``hist_blocks`` blocks
    (at most the frame's blocks less one), which the device decodes with a
    carried history; where that frame has no sidecar the input is cut as
    by default.  The frames are the host core's ladder's, as the
    reference's are."""
    data = bytes(data)
    if multi_block and len(data) > SEG:
        n_blocks = -(-len(data) // SEG)
        hist_blocks = max(1, min(int(hist_blocks), n_blocks - 1))
        frame = compress_frame_bs(data, level, 16, hist_blocks << 16)
        side = build_sidecar(frame, max_rounds, hist_blocks=hist_blocks)
        if side is not None:
            return side + frame
    out = bytearray()
    for lo in range(0, max(len(data), 1), SEG):
        frame = compress(data[lo:lo + SEG], level=level)
        out += (build_sidecar(frame, max_rounds) or b"") + frame
    return bytes(out)


def split_stream_accel(blob: bytes) -> list:
    """Cut a ``compress_accel`` stream into items of
    ``decompress_frames_device``: each frame with the skippable frames
    before it (its sidecar); trailing skippable frames join the last item.
    A structural walk of the block headers, no decoding."""
    blob = bytes(blob)
    items = []
    pos = cur = 0
    while pos < len(blob):
        end, skippable = _frame_extent(blob, pos)
        if not skippable:
            items.append(blob[cur:end])
            cur = end
        pos = end
    if cur < len(blob):
        if items:
            items[-1] += blob[cur:]
        else:
            items.append(blob[cur:])
    return items


def split_sidecar(blob: bytes):
    """Strip all leading skippable frames of blob (foreign ones are
    ignored): (sidecar payload or None, the rest)."""
    found = None
    pos = 0
    while len(blob) - pos >= 8:
        magic = int.from_bytes(blob[pos:pos + 4], "little")
        if (magic & 0xFFFFFFF0) != SKIP_MAGIC:
            break
        size = int.from_bytes(blob[pos + 4:pos + 8], "little")
        payload = blob[pos + 8:pos + 8 + size]
        pos += 8 + size
        if payload[:4] == b"CTAC":  # CRC-wrapped sidecar
            want = int.from_bytes(payload[4:8], "little")
            payload = payload[8:]
            if (crc32c(payload) & 0xFFFFFFFF) != want:
                continue  # corrupt: ignore, keep scanning
        if payload[:4] == b"CTA2":  # S2-compressed sidecar
            try:
                payload = s2block.decode(payload[4:])
            except (ValueError, IndexError):  # foreign: ignore
                continue
        if payload[:4] == ACCEL_MAGIC:
            found = payload
    return found, blob[pos:]


class BlockAccel:
    """One block's parsed accel arrays."""

    __slots__ = ("lit_kind", "regen", "n_seqs", "total_out", "lit_cks",
                 "seq_bits", "seq_states", "seq_reps", "src", "length",
                 "round", "n_rounds")


def parse_sidecar(payload: bytes):
    """(hist_blocks, [BlockAccel or None per block]): numpy slicing of the
    payload, no per-symbol work."""
    if payload[:4] != ACCEL_MAGIC:
        raise ValueError("bad sidecar magic")
    n_blocks = int.from_bytes(payload[4:6], "little")
    hist_blocks = int.from_bytes(payload[6:8], "little")
    pos = 8
    out = []
    for _ in range(n_blocks):
        flags = payload[pos]
        pos += 1
        if not (flags & 1):
            out.append(None)
            continue
        a = BlockAccel()
        a.lit_kind = payload[pos]
        pos += 1
        a.regen, a.n_seqs, a.total_out = np.frombuffer(payload, np.uint32, 3,
                                                       pos)
        pos += 12
        a.lit_cks = []
        for _q in range({0: 4, 3: 1}.get(a.lit_kind, 0)):
            nch = int.from_bytes(payload[pos:pos + 2], "little")
            pos += 2
            a.lit_cks.append(np.frombuffer(payload, np.uint32, nch, pos)
                             .astype(np.int64))
            pos += 4 * nch
        if flags & 2:  # optional sequence-checkpoint section
            seq_nch = int.from_bytes(payload[pos:pos + 2], "little")
            pos += 2
            rec = np.frombuffer(payload, np.uint8, seq_nch * 22, pos
                                ).reshape(seq_nch, 22)
            pos += 22 * seq_nch
            a.seq_bits = rec[:, 0:4].copy().view(np.uint32)[:, 0].astype(
                np.int64)
            a.seq_states = rec[:, 4:10].copy().view(np.uint16).astype(
                np.int32)                                  # ll, of, ml
            a.seq_reps = rec[:, 10:22].copy().view(np.uint32).astype(
                np.int64)
        else:
            a.seq_bits = np.zeros(0, np.int64)
            a.seq_states = np.zeros((0, 3), np.int32)
            a.seq_reps = np.zeros((0, 3), np.int64)
        n_pieces = int.from_bytes(payload[pos:pos + 4], "little")
        pos += 4
        a.n_rounds = payload[pos]
        pos += 1
        a.src = np.frombuffer(payload, np.int32, n_pieces, pos).copy()
        pos += 4 * n_pieces
        a.length = np.frombuffer(payload, np.uint8, n_pieces, pos
                                 ).astype(np.int32)
        pos += n_pieces
        a.round = np.frombuffer(payload, np.uint8, n_pieces, pos
                                ).astype(np.int32)
        pos += n_pieces
        out.append(a)
    return hist_blocks, out


def accel_plan(a: BlockAccel, hist_blocks: int = 0):
    """BlockAccel -> a ``ops/execute.pack_plans`` plan dict (dst is the
    exclusive cumsum of the piece lengths).  Raises ValueError on an
    inconsistent (hostile or corrupt) sidecar; callers decode that frame
    on the host."""
    total = int(a.length.sum())
    if total != int(a.total_out) or total > (1 << 16):
        raise ValueError("sidecar plan length mismatch")
    # pieces must fit their dst row (the kernel masks per 128-byte row)
    dst_rel = np.concatenate([[0], np.cumsum(a.length[:-1], dtype=np.int64)])
    if len(a.length) and int(((dst_rel & 127) + a.length).max()) > 128:
        raise ValueError("sidecar plan piece crosses a row boundary")
    hist_top = HIST_BASE + (int(hist_blocks) << 16)
    if int(a.n_rounds) < 1 or int(a.n_rounds) > 64:
        raise ValueError("sidecar plan rounds out of range")
    if len(a.src):
        s = a.src.astype(np.int64)
        is_hist = s >= HIST_BASE
        bad = ((s < 0)
               | (~is_hist & (s + a.length > ARENA_ROWS * 128))
               | (is_hist & (s + a.length > hist_top)))
        if bool(bad.any()):
            raise ValueError("sidecar plan source out of range")
        # history sources are resolved at block start: round 0 only
        if bool((is_hist & (a.round != 0)).any()):
            raise ValueError("sidecar history piece beyond round 0")
        if bool(((a.round < 0) | (a.round >= int(a.n_rounds))).any()):
            raise ValueError("sidecar plan piece round out of range")
    dst = (OUT_BASE + dst_rel).astype(np.int32)
    return {"src": a.src, "dst": dst, "len": a.length, "round": a.round,
            "n_rounds": int(a.n_rounds)}
