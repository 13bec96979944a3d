"""dictbuilder — cross-format dictionary trainer.

Reference parity: dict/ package (BuildZstdDict/BuildS2Dict/BuildRawDict,
dict/builder.go:68-93), the JAX package's ``dictbuilder`` on the port.
The trainer collects real LZ matches across samples (the reference's
buildDict match-collection role, dict/builder.go:93-530): it encodes the
concatenated corpus with the host core's S2 matcher (``s2.encode_better``),
parses the op stream, and accumulates per-byte match coverage;
high-coverage segments become the dictionary content, packed hottest-last
(small offsets for hot strings). The fragment-frequency heuristic serves
samples without cross-sample matches. Format serialization is
delegated to the codec packages (zstd.build_dict derives entropy tables +
rep offsets by encoding every sample against the content, zstd/dict.py).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

FRAG = 32
STRIDE = 8
MIN_COUNT = 2


def _iter_copy_ops(body: bytes):
    """Yield (out_pos, offset, length) for every copy in an s2 block body
    (repeat extension included; literals advance out_pos only)."""
    s, d = 0, 0
    offset = 0
    n = len(body)
    while s < n:
        tag = body[s]
        kind = tag & 3
        if kind == 0:
            x = tag >> 2
            if x < 60:
                s += 1
            else:
                nb = x - 59
                x = int.from_bytes(body[s + 1 : s + 1 + nb], "little")
                s += 1 + nb
            d += x + 1
            s += x + 1
            continue
        if kind == 1:
            toff = ((tag & 0xE0) << 3) | body[s + 1]
            length = (tag >> 2) & 7
            s += 2
            if toff == 0:  # repeat
                if length == 5:
                    length = body[s] + 4
                    s += 1
                elif length == 6:
                    length = int.from_bytes(body[s : s + 2], "little") + 256
                    s += 2
                elif length == 7:
                    length = int.from_bytes(body[s : s + 3], "little") + 65536
                    s += 3
            else:
                offset = toff
            length += 4
        elif kind == 2:
            offset = int.from_bytes(body[s + 1 : s + 3], "little")
            length = 1 + (tag >> 2)
            s += 3
        else:
            offset = int.from_bytes(body[s + 1 : s + 5], "little")
            length = 1 + (tag >> 2)
            s += 5
        yield d, offset, length
        d += length


def _match_segments(samples, max_size: int, min_cov: int = 2,
                    min_len: int = 12):
    """Match-coverage content selection. Returns content bytes or None
    when no cross-sample matches exist."""
    from compress_tpu_torch import s2
    from compress_tpu_torch.utils.varint import read_uvarint

    concat = b"".join(bytes(x) for x in samples)
    if len(concat) < 64:
        return None
    # chunk at 1 MiB so the native block matcher's window spans many
    # samples; coverage accumulates over the whole corpus
    cov_diff = np.zeros(len(concat) + 1, np.int64)
    step = 1 << 20
    for lo in range(0, len(concat), step):
        chunk = concat[lo : lo + step]
        blk = s2.encode_better(chunk)
        dlen, pos = read_uvarint(blk)
        starts, lens = [], []
        for d, off, ln in _iter_copy_ops(blk[pos:]):
            starts.append(lo + d - off)
            lens.append(ln)
        if starts:
            st = np.array(starts, np.int64)
            ln = np.array(lens, np.int64)
            np.add.at(cov_diff, st, 1)
            np.add.at(cov_diff, st + ln, -1)
    cov = np.cumsum(cov_diff[:-1])
    good = cov >= min_cov
    if not good.any():
        return None
    # contiguous high-coverage runs >= min_len, scored by coverage mass
    edges = np.flatnonzero(np.diff(np.concatenate([[0], good.view(np.int8),
                                                   [0]])))
    runs = edges.reshape(-1, 2)
    segs = []
    for a, b in runs:
        if b - a < min_len:
            continue
        segs.append((int(cov[a:b].sum()), int(a), int(b)))
    if not segs:
        return None
    segs.sort()  # ascending score: hottest segments pack LAST
    # take the highest-scoring segments that fit
    chosen = []
    used = 0
    for score, a, b in reversed(segs):
        take = min(b - a, max_size - used)
        if take < min_len:
            continue
        chosen.append((score, concat[a : a + take]))
        used += take
        if used >= max_size:
            break
    if not chosen:
        return None
    chosen.sort(key=lambda t: t[0])  # hottest last
    out = b"".join(c for _, c in chosen)
    if len(out) < 16:
        return None
    return out


def _fragments(samples, max_table: int = 1 << 20) -> Counter:
    counts: Counter = Counter()
    for s in samples:
        s = bytes(s)
        for i in range(0, max(len(s) - FRAG, 0), STRIDE):
            counts[s[i : i + FRAG]] += 1
        if len(counts) > max_table:
            counts = Counter(dict(counts.most_common(max_table // 2)))
    return counts


def build_raw_dict(samples, max_size: int = 64 << 10) -> bytes:
    """Content-only dictionary: real-match coverage segments (hottest at
    the end); fragment frequency where no cross-sample matches exist."""
    seg = _match_segments(samples, max_size)
    if seg is not None:
        return seg
    counts = _fragments(samples)
    chosen = []
    used = 0
    seen_content = bytearray()
    for frag, c in counts.most_common():
        if c < MIN_COUNT:
            break
        if used + len(frag) > max_size:
            continue
        if bytes(frag) in bytes(seen_content):
            continue
        chosen.append((c, frag))
        seen_content += frag
        used += len(frag)
        if used >= max_size - FRAG:
            break
    if not chosen:
        # degenerate: use the first sample's head
        head = bytes(samples[0])[:max_size] if samples else b"\x00" * 16
        return head if len(head) >= 16 else head + bytes(16 - len(head))
    chosen.sort(key=lambda t: t[0])  # ascending count: hottest last
    out = b"".join(f for _, f in chosen)
    if len(out) < 16:
        out += bytes(16 - len(out))
    return out


def build_zstd_dict(samples, max_size: int = 64 << 10, dict_id: int = 1) -> bytes:
    """Reference: dict.BuildZstdDict -> zstd dictionary blob."""
    from compress_tpu_torch.zstd.dict import build_dict

    content = build_raw_dict(samples, max_size)
    return build_dict(list(samples), content, dict_id=dict_id)


def build_s2_dict(samples, max_size: int = 64 << 10) -> bytes:
    """Reference: dict.BuildS2Dict -> s2 dictionary blob."""
    from compress_tpu_torch.s2.dict import make_dict

    content = build_raw_dict(samples, min(max_size, 64 << 10))
    return make_dict(content).bytes()


__all__ = ["build_raw_dict", "build_zstd_dict", "build_s2_dict"]
