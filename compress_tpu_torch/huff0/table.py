"""huff0 code lengths and table serialization (RFC 8878 §4.2.1):
copies of the JAX package's ``huff0.build_nbits`` (its package-merge code
lengths), ``canonical_codes``, ``write_table`` and ``read_table`` and the
helpers they need (``weights_to_nbits``, ``build_dtable``).  As there,
``package_merge_lengths`` and ``write_table`` run the host core
(``ct_huf0_package_merge``, ``ct_huf_write_table``) and, where it refuses
an input, the Python path (the ``_py`` functions, their plain versions).

weight(s) = max_bits + 1 - nbits(s), 0 for an unused symbol; the last
present symbol's weight is implied.  The weights are written FSE-compressed
(header byte < 128, that many bytes follow) when that is smaller and
decodes back unambiguously, else as raw nibbles (header byte >= 128)."""

from __future__ import annotations

import numpy as np

from compress_tpu_torch import _native
from compress_tpu_torch.fse import core as fse_core


MAX_TABLELOG = 11


class IncompressibleError(ValueError):
    pass


class CorruptError(ValueError):
    pass


class UseRLEError(ValueError):
    pass


def package_merge_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Optimal length-limited code lengths (<= limit) for nonzero freqs."""
    if len(freqs) <= 256:
        f = np.zeros(256, np.int64)
        f[:len(freqs)] = freqs
        lengths = np.zeros(256, np.int32)
        if _native.library().ct_huf0_package_merge(
                _native.ptr(f), int(limit), _native.ptr(lengths)) == 0:
            return lengths[:len(freqs)].copy()
    return package_merge_lengths_py(freqs, limit)


def package_merge_lengths_py(freqs: np.ndarray, limit: int) -> np.ndarray:
    """``package_merge_lengths`` in Python (the same tie order)."""
    sym = np.nonzero(freqs)[0]
    n = len(sym)
    if n == 0:
        raise ValueError("empty histogram")
    if n == 1:
        out = np.zeros(len(freqs), dtype=np.int32)
        out[sym[0]] = 1
        return out
    if (1 << limit) < n:
        raise ValueError("limit too small for alphabet")
    f = freqs[sym].astype(np.int64)
    # package-merge: the coin lists of each level, (weight, symbols)
    items = sorted((int(w), (int(s),)) for s, w in zip(sym, f))
    packages = items
    merged = items
    for _ in range(limit - 1):
        paired = [(packages[i][0] + packages[i + 1][0],
                   packages[i][1] + packages[i + 1][1])
                  for i in range(0, len(packages) - 1, 2)]
        merged = sorted(items + paired)
        packages = merged
    lengths = np.zeros(len(freqs), dtype=np.int32)
    for _w, syms in merged[:2 * n - 2]:
        for s in syms:
            lengths[s] += 1
    return lengths


def build_nbits(hist: np.ndarray, table_log: int = MAX_TABLELOG):
    """(nb_bits per symbol, 0 = unused; the max bits used)."""
    if int((hist > 0).sum()) <= 1:
        raise UseRLEError("single symbol")
    nbits = package_merge_lengths(hist, min(table_log, MAX_TABLELOG))
    return nbits, int(nbits.max())


def canonical_codes(nbits: np.ndarray, max_bits: int) -> np.ndarray:
    """Code value per symbol matching the RFC decode-table layout: the
    table is filled nb_bits descending, natural symbol order within a
    length; code = table_start >> (max_bits - nb)."""
    codes = np.zeros(len(nbits), dtype=np.int64)
    start = 0
    for nb in range(max_bits, 0, -1):
        span = 1 << (max_bits - nb)
        for s in np.nonzero(nbits == nb)[0]:
            codes[s] = start >> (max_bits - nb)
            start += span
    if start != (1 << max_bits):
        raise ValueError("kraft sum mismatch")
    return codes


def nbits_to_weights(nbits: np.ndarray, max_bits: int) -> np.ndarray:
    w = np.where(nbits > 0, max_bits + 1 - nbits, 0)
    return w.astype(np.int32)


def write_table(nbits: np.ndarray, max_bits: int) -> bytes:
    """Serialize weights: FSE-compressed if smaller, else raw nibbles."""
    arr = np.zeros(256, np.int32)
    arr[:min(len(nbits), 256)] = nbits[:256]
    out, dst = _native.out_buf(256)
    r = _native.library().ct_huf_write_table(_native.ptr(arr), int(max_bits),
                                             dst, 256)
    if r > 0:
        return out[:r].tobytes()
    return write_table_py(nbits, max_bits)


def write_table_py(nbits: np.ndarray, max_bits: int) -> bytes:
    """``write_table`` in Python."""
    weights = nbits_to_weights(nbits, max_bits)
    last = int(np.nonzero(nbits)[0][-1])
    w_explicit = weights[:last]  # last present symbol's weight implied
    n = len(w_explicit)

    # raw nibble encoding: headerByte = 127 + number_of_weights, where the
    # weight count EXCLUDES the implied last symbol (RFC 8878 §4.2.1.1);
    # only representable for <= 128 explicit weights
    raw = None
    if n <= 128:
        raw = bytearray([127 + n])
        for i in range(0, n, 2):
            hi = int(w_explicit[i])
            lo = int(w_explicit[i + 1]) if i + 1 < n else 0
            raw.append((hi << 4) | lo)

    # FSE-compressed weights (accuracy <= 6, no explicit length)
    fse_blob = None
    if n >= 2:
        try:
            hist = np.bincount(w_explicit, minlength=256).astype(np.int64)
            max_sym = int(np.nonzero(hist)[0][-1])
            tl = fse_core.optimal_table_log(6, n, max_sym, max_table_log=6)
            norm = fse_core.normalize_count(hist, tl, n, max_sym)
            hdr = fse_core.write_ncount(norm, tl)
            stream = fse_core.encode_interleaved2(
                w_explicit.astype(np.uint8), norm, tl)
            blob = hdr + stream
            if len(blob) < 128 and (raw is None or len(blob) + 1 < len(raw)):
                # verify unambiguous exhaustion-decode before committing
                back = decode_weights_fse(bytes(blob))
                if (back is not None and len(back) == n
                        and (back == w_explicit).all()):
                    fse_blob = bytes([len(blob)]) + blob
        except (ValueError, IncompressibleError):
            fse_blob = None
    if fse_blob is not None:
        return fse_blob
    if raw is None:
        raise IncompressibleError(
            "table not serializable (>128 symbols, FSE failed)")
    return bytes(raw)


def decode_weights_fse(blob: bytes):
    """Decode FSE-compressed weights (termination by stream exhaustion)."""
    try:
        norm, tl, pos = fse_core.read_ncount(blob, 0, max_symbol=255,
                                             max_table_log=6)
    except ValueError:
        return None
    spread, nb, new_state = fse_core.build_dtable(norm, tl)
    try:
        br = fse_core.BitReaderReverse(blob[pos:])
    except ValueError:
        return None
    s1 = br.read(tl)
    s2 = br.read(tl)
    out = []
    # zstd semantics: emit, reload; overflow on reload => other state emits
    for _ in range(255):
        out.append(int(spread[s1]))
        s1 = int(new_state[s1]) + br.read(int(nb[s1]))
        if br.bitpos < 0:
            out.append(int(spread[s2]))
            return np.array(out, dtype=np.int32)
        out.append(int(spread[s2]))
        s2 = int(new_state[s2]) + br.read(int(nb[s2]))
        if br.bitpos < 0:
            out.append(int(spread[s1]))
            return np.array(out, dtype=np.int32)
    return None  # did not terminate — treat as corrupt/ambiguous


def weights_to_nbits(weights: np.ndarray) -> tuple[np.ndarray, int]:
    """Infer nb_bits from explicit weights + the implied last weight.

    weights: the serialized weights (last symbol's weight NOT included).
    Returns (nbits including the implied symbol, max_bits)."""
    w = weights.astype(np.int64)
    if (w < 0).any():
        raise CorruptError("negative weight")
    ksum = int((np.where(w > 0, 1 << (w - 1), 0)).sum())
    if ksum < 1:
        raise CorruptError("no weights")
    # total must reach the next power of two
    max_bits = max(ksum.bit_length(), 1)
    rest = (1 << max_bits) - ksum
    # rest must itself be a power of two (the implied symbol's 2^(w-1))
    if rest <= 0 or (rest & (rest - 1)) != 0:
        raise CorruptError("invalid weight sum")
    full = np.concatenate([w, [rest.bit_length()]])
    if max_bits > MAX_TABLELOG:
        raise CorruptError("tableLog too large")
    nbits = np.where(full > 0, max_bits + 1 - full, 0).astype(np.int32)
    return nbits, max_bits


def build_dtable(weights_full: np.ndarray, max_bits: int):
    """(symbol, nb_bits) per max_bits-bit window index (RFC layout:
    weight-ascending, natural symbol order within a weight)."""
    size = 1 << max_bits
    sym_t = np.zeros(size, dtype=np.uint8)
    nb_t = np.zeros(size, dtype=np.int32)
    start = 0
    for w in range(1, max_bits + 1):
        nb = max_bits + 1 - w
        span = 1 << (w - 1)
        for s in np.nonzero(weights_full == w)[0]:
            sym_t[start:start + span] = s
            nb_t[start:start + span] = nb
            start += span
    if start != size:
        raise CorruptError("weights do not fill the table")
    return sym_t, nb_t


def read_table(buf: bytes, pos: int = 0):
    """Parse a serialized table. Returns (sym_t, nb_t, max_bits, new_pos)."""
    if pos >= len(buf):
        raise CorruptError("table truncated")
    hdr = buf[pos]
    pos += 1
    if hdr >= 128:
        n = hdr - 127  # number of explicit weights (implied last excluded)
        nbytes = (n + 1) // 2
        if pos + nbytes > len(buf):
            raise CorruptError("table truncated")
        w = np.zeros(n, dtype=np.int32)
        for i in range(n):
            b = buf[pos + i // 2]
            w[i] = (b >> 4) if i % 2 == 0 else (b & 0xF)
        pos += nbytes
    else:
        if pos + hdr > len(buf):
            raise CorruptError("table truncated")
        w = decode_weights_fse(buf[pos:pos + hdr])
        if w is None:
            raise CorruptError("bad FSE weight stream")
        pos += hdr
    nbits, max_bits = weights_to_nbits(np.asarray(w))
    weights_full = np.where(nbits > 0, max_bits + 1 - nbits, 0)
    sym_t, nb_t = build_dtable(weights_full, max_bits)
    return sym_t, nb_t, max_bits, pos
