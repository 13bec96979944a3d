"""FSE (tANS) host pieces: normalization, the NCount header (RFC 8878
§4.1.1), table construction and the 2-state interleaved codec (frame
assembly, huff0 weights and the standalone FSE codec of ``fse``).

Copies of the JAX package's ``fse/core.py`` functions of the same names.
As there, ``write_ncount``, ``encode_interleaved2`` and
``decode_interleaved2`` run the host core (``ct_fse_write_ncount``,
``ct_fse_encode_i2``, ``ct_fse_decode_i2``) and, where it refuses an
input, the Python loop, which gives the reference's result or precise
error; the ``_py`` functions are those loops alone, the plain versions."""

from __future__ import annotations

import numpy as np

from compress_tpu_torch import _native

MIN_TABLELOG = 5
MAX_TABLELOG = 12  # standalone fse; zstd sequence tables cap lower
DEFAULT_TABLELOG = 11


def highbit(x: int) -> int:
    return x.bit_length() - 1


def optimal_table_log(table_log: int, src_len: int, max_symbol: int,
                      max_table_log: int = MAX_TABLELOG) -> int:
    """Pick a table log: small enough to matter, big enough to resolve."""
    if table_log == 0:
        table_log = DEFAULT_TABLELOG
    max_bits_src = max(highbit(src_len - 1) - 2, 1)
    min_bits_symbols = highbit(max_symbol) + 2
    table_log = min(table_log, max_bits_src)
    table_log = max(table_log, min_bits_symbols)
    return max(MIN_TABLELOG, min(table_log, max_table_log))


def normalize_count(hist: np.ndarray, table_log: int, total: int,
                    max_symbol: int, low_prob_allowed: bool = True) -> np.ndarray:
    """Scale hist[0..max_symbol] to sum exactly 2^table_log.

    Nonzero symbols keep >=1 slot; very rare symbols get -1 ("less than one",
    still one slot, placed at the table tail per the format). Our scheme:
    ideal shares + largest-remainder rounding, then a correction pass that
    steals from the largest counts — always valid, no pathological failures.
    """
    table_size = 1 << table_log
    counts = hist[: max_symbol + 1].astype(np.int64)
    norm = np.zeros(max_symbol + 1, dtype=np.int64)
    nz = counts > 0
    if total <= 0 or nz.sum() == 0:
        raise ValueError("empty input")
    if nz.sum() == 1:
        raise ValueError("single symbol — use RLE")

    low_threshold = total >> table_log
    if low_prob_allowed:
        is_low = nz & (counts <= low_threshold)
    else:
        is_low = np.zeros_like(nz)
    norm[is_low] = -1
    rest_slots = table_size - int(is_low.sum())
    rest_total = int(counts[nz & ~is_low].sum())
    if rest_total <= 0 or rest_slots <= 0:
        # everything landed in the low bucket — renormalize without it
        return normalize_count(hist, table_log, total, max_symbol,
                               low_prob_allowed=False)

    mid = nz & ~is_low
    if rest_slots < int(mid.sum()):
        raise ValueError("table log too small for alphabet")
    ideal = counts[mid].astype(np.float64) * (rest_slots / rest_total)
    base = np.maximum(np.floor(ideal).astype(np.int64), 1)
    remainder = rest_slots - int(base.sum())
    if remainder > 0:
        frac = ideal - np.floor(ideal)
        order = np.argsort(-frac, kind="stable")
        take = order[:remainder]
        base[take] += 1
        # if remainder exceeded symbol count, round-robin the rest
        left = remainder - len(take)
        i = 0
        while left > 0:
            base[order[i % len(order)]] += 1
            left -= 1
            i += 1
    elif remainder < 0:
        # stole too much via the >=1 floor: take back from the largest
        order = np.argsort(-base, kind="stable")
        i = 0
        while remainder < 0:
            j = order[i % len(order)]
            if base[j] > 1:
                base[j] -= 1
                remainder += 1
            i += 1
    norm[mid] = base
    assert int(np.abs(norm).sum()) == table_size, (norm, table_size)
    return norm


# ---------------------------------------------------------------------------
# NCount header (RFC 8878 §4.1.1 bit layout)
# ---------------------------------------------------------------------------


def _norm256(norm: np.ndarray) -> np.ndarray:
    nrm = np.zeros(256, np.int16)
    nrm[:len(norm)] = norm
    return nrm


def write_ncount(norm: np.ndarray, table_log: int) -> bytes:
    """Serialize a normalized count table (accuracy-log header + counts)."""
    arr, dst = _native.out_buf(1024)
    r = _native.library().ct_fse_write_ncount(
        _native.ptr(_norm256(norm)), len(norm) - 1, int(table_log), dst, 1024)
    if r >= 0:
        return arr[:r].tobytes()
    return write_ncount_py(norm, table_log)


def write_ncount_py(norm: np.ndarray, table_log: int) -> bytes:
    """``write_ncount`` in Python."""
    out = bytearray()
    bit_stream = 0
    bit_count = 0

    def put(v: int, n: int):
        nonlocal bit_stream, bit_count
        bit_stream |= (v & ((1 << n) - 1)) << bit_count
        bit_count += n
        while bit_count >= 16:
            out.append(bit_stream & 0xFF)
            out.append((bit_stream >> 8) & 0xFF)
            bit_stream >>= 16
            bit_count -= 16

    table_size = 1 << table_log
    put(table_log - MIN_TABLELOG, 4)
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1
    s = 0
    max_symbol = len(norm) - 1
    previous0 = False
    while remaining > 1 and s <= max_symbol:
        if previous0:
            # run-length of zero-probability symbols
            start = s
            while s <= max_symbol and norm[s] == 0:
                s += 1
            run = s - start
            while run >= 24:
                put(0xFFFF, 16)
                run -= 24
            while run >= 3:
                put(3, 2)
                run -= 3
            put(run, 2)
            if s > max_symbol:
                break
        count = int(norm[s])
        s += 1
        mx = (2 * threshold - 1) - remaining
        remaining -= abs(count)
        count += 1  # -1 -> 0, 0 -> 1, etc.
        if count >= threshold:
            count += mx
        put(count, nb_bits - (1 if count < mx else 0))
        previous0 = count == 1
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    # flush
    while bit_count > 0:
        out.append(bit_stream & 0xFF)
        bit_stream >>= 8
        bit_count -= 8
    return bytes(out)


def read_ncount(buf: bytes, pos: int = 0, max_symbol: int = 255,
                max_table_log: int = MAX_TABLELOG):
    """Parse an NCount header. Returns (norm int64[], table_log, new_pos)."""
    if pos + 1 > len(buf):
        raise ValueError("ncount: truncated")

    bit_stream = 0
    bit_count = 0
    p = pos

    def fill():
        nonlocal bit_stream, bit_count, p
        while bit_count <= 16 and p < len(buf):
            bit_stream |= buf[p] << bit_count
            bit_count += 8
            p += 1

    def take(n: int) -> int:
        nonlocal bit_stream, bit_count
        fill()
        if bit_count < n:
            # zero-padded tail is legal as long as counts resolve
            bit_stream |= 0
        v = bit_stream & ((1 << n) - 1)
        bit_stream >>= n
        bit_count -= n
        return v

    table_log = take(4) + MIN_TABLELOG
    if table_log > max_table_log:
        raise ValueError("ncount: tableLog too large")
    table_size = 1 << table_log
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1
    norm = np.zeros(max_symbol + 1, dtype=np.int64)
    s = 0
    previous0 = False
    while remaining > 1:
        if s > max_symbol:
            raise ValueError("ncount: too many symbols")
        if previous0:
            run = take(2)
            total_run = run
            while run == 3:
                run = take(2)
                total_run += run
            # runs of 24 escape via 16-bit all-ones chunks (0xFFFF = 8x '3')
            s += total_run
            if s > max_symbol + 1:
                raise ValueError("ncount: zero run overruns alphabet")
            previous0 = False
            continue
        mx = (2 * threshold - 1) - remaining
        fill()
        low = bit_stream & ((1 << (nb_bits - 1)) - 1)
        if low < mx:
            count = low
            bit_stream >>= nb_bits - 1
            bit_count -= nb_bits - 1
        else:
            count = bit_stream & ((1 << nb_bits) - 1)
            bit_stream >>= nb_bits
            bit_count -= nb_bits
            if count >= threshold:
                count -= mx
        count -= 1  # back to -1..
        remaining -= count if count >= 0 else -count
        norm[s] = count
        s += 1
        previous0 = count == 0
        while remaining < threshold and remaining > 1:
            nb_bits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("ncount: corrupted (remaining != 1)")
    # consumed position: p minus whole unread bytes in the accumulator
    new_pos = p - (bit_count >> 3)
    return norm[: s], table_log, new_pos


# ---------------------------------------------------------------------------
# Table construction (RFC-exact spread + encode/decode tables)
# ---------------------------------------------------------------------------


def spread_symbols(norm: np.ndarray, table_log: int) -> np.ndarray:
    """RFC 8878 symbol spread: low-prob (-1) symbols fill the table tail,

    the rest are scattered with the standard co-prime step."""
    table_size = 1 << table_log
    table = np.zeros(table_size, dtype=np.int32)
    high_threshold = table_size - 1
    for s, c in enumerate(norm):
        if c == -1:
            table[high_threshold] = s
            high_threshold -= 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(int(c), 0)):
            table[pos] = s
            while True:
                pos = (pos + step) & mask
                if pos <= high_threshold:
                    break
    assert pos == 0, "spread did not close the cycle"
    return table


def build_dtable(norm: np.ndarray, table_log: int):
    """Decode table: (symbol, nb_bits, new_state_base) per state (RFC-exact)."""
    table_size = 1 << table_log
    spread = spread_symbols(norm, table_log)
    symbol_next = np.where(norm == -1, 1, np.maximum(norm, 0)).astype(np.int64)
    nb = np.zeros(table_size, dtype=np.int32)
    new_state = np.zeros(table_size, dtype=np.int32)
    for u in range(table_size):
        s = spread[u]
        nxt = symbol_next[s]
        symbol_next[s] += 1
        nb_bits = table_log - highbit(int(nxt))
        nb[u] = nb_bits
        new_state[u] = (int(nxt) << nb_bits) - table_size
    return spread.astype(np.uint8), nb, new_state


def build_ctable(norm: np.ndarray, table_log: int):
    """Encode table: per-state next-state and per-symbol transforms.

    Returns (state_table int32[table_size],
             delta_nb_bits int64[nsym], delta_find_state int64[nsym])."""
    table_size = 1 << table_log
    spread = spread_symbols(norm, table_log)
    cumul = np.zeros(len(norm) + 1, dtype=np.int64)
    for s, c in enumerate(norm):
        cumul[s + 1] = cumul[s] + (1 if c == -1 else max(int(c), 0))
    # state_table[cumul_position] = table_size + u
    state_table = np.zeros(table_size, dtype=np.int32)
    cpos = cumul[:-1].copy()
    for u in range(table_size):
        s = spread[u]
        state_table[cpos[s]] = table_size + u
        cpos[s] += 1
    delta_nb = np.zeros(len(norm), dtype=np.int64)
    delta_fs = np.zeros(len(norm), dtype=np.int64)
    total = 0
    for s, c in enumerate(norm):
        c = int(c)
        if c == 0:
            # unused symbol: poison values (encoding it would be a bug)
            delta_nb[s] = ((table_log + 1) << 16) - (1 << table_log)
            continue
        if c == -1 or c == 1:
            delta_nb[s] = (table_log << 16) - (1 << table_log)
            delta_fs[s] = total - 1
            total += 1
        else:
            max_bits_out = table_log - highbit(c - 1)
            min_state_plus = c << max_bits_out
            delta_nb[s] = (max_bits_out << 16) - min_state_plus
            delta_fs[s] = total - c
            total += c
    return state_table, delta_nb, delta_fs


# ---------------------------------------------------------------------------
# Bitstream (LSB-first writer; backwards reader with 1-bit end marker)
# ---------------------------------------------------------------------------


class BitWriter:
    __slots__ = ("acc", "n", "out")

    def __init__(self):
        self.acc = 0
        self.n = 0
        self.out = bytearray()

    def add(self, v: int, nbits: int):
        self.acc |= (v & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def close(self) -> bytes:
        self.add(1, 1)  # end-of-stream marker
        if self.n:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.n = 0
        return bytes(self.out)


class BitReaderReverse:
    """Reads a marker-terminated LSB-first stream from the top (zstd style)."""

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("bitstream: missing end marker")
        self.data = data
        self.bitpos = (len(data) - 1) * 8 + highbit(data[-1])

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.bitpos -= n
        bp = self.bitpos
        mask = (1 << n) - 1
        if bp >= 0:
            byte0 = bp >> 3
            chunk = int.from_bytes(self.data[byte0 : byte0 + 9], "little")
            return (chunk >> (bp & 7)) & mask
        # overread past the start: zero-pad below bit 0
        chunk = int.from_bytes(self.data[0:9], "little")
        return (chunk << -bp) & mask

    def finished(self) -> bool:
        return self.bitpos <= 0

    def overflowed(self) -> bool:
        return self.bitpos < 0


def encode_interleaved2(symbols: np.ndarray, norm: np.ndarray,
                        table_log: int) -> bytes:
    """Encode symbols (last-to-first) with two interleaved states.

    Stream layout matches the classic FSE block codec: states flushed at the
    end (c2 then c1), so the decoder reads state1 first."""
    if len(symbols) >= 2:
        sym = np.ascontiguousarray(symbols, dtype=np.uint8)
        n = len(sym)
        cap = 2 * n + 64
        arr, dst = _native.out_buf(cap)
        r = _native.library().ct_fse_encode_i2(
            _native.ptr(sym), n, _native.ptr(_norm256(norm)), len(norm) - 1,
            int(table_log), dst, cap)
        if r >= 0:
            return arr[:r].tobytes()
    return encode_interleaved2_py(symbols, norm, table_log)


def encode_interleaved2_py(symbols: np.ndarray, norm: np.ndarray,
                           table_log: int) -> bytes:
    """``encode_interleaved2`` in Python."""
    state_table, delta_nb, delta_fs = build_ctable(norm, table_log)
    bw = BitWriter()
    n = len(symbols)
    if n < 2:
        raise ValueError("need >= 2 symbols")

    def first_state(sym: int) -> int:
        nb = (int(delta_nb[sym]) + (1 << 15)) >> 16
        im = (nb << 16) - int(delta_nb[sym])
        lu = (im >> nb) + int(delta_fs[sym])
        return int(state_table[lu])

    def enc(state: int, sym: int) -> int:
        nb = (state + int(delta_nb[sym])) >> 16
        bw.add(state, nb)
        return int(state_table[(state >> nb) + int(delta_fs[sym])])

    ip = n
    if ip & 1:
        s1 = first_state(int(symbols[ip - 1]))
        s2 = first_state(int(symbols[ip - 2]))
        s1 = enc(s1, int(symbols[ip - 3]))
        ip -= 3
    else:
        s2 = first_state(int(symbols[ip - 1]))
        s1 = first_state(int(symbols[ip - 2]))
        ip -= 2
    if ip & 2:
        s2 = enc(s2, int(symbols[ip - 1]))
        s1 = enc(s1, int(symbols[ip - 2]))
        ip -= 2
    while ip >= 4:
        s2 = enc(s2, int(symbols[ip - 1]))
        s1 = enc(s1, int(symbols[ip - 2]))
        s2 = enc(s2, int(symbols[ip - 3]))
        s1 = enc(s1, int(symbols[ip - 4]))
        ip -= 4
    bw.add(s2 - (1 << table_log), table_log)  # flush final states
    bw.add(s1 - (1 << table_log), table_log)
    return bw.close()


def decode_interleaved2(stream: bytes, norm: np.ndarray, table_log: int,
                        out_len: int) -> np.ndarray:
    """Inverse of encode_interleaved2; out_len symbols."""
    if out_len >= 2 and stream:
        sp, sn = _native.pad_scratch(stream)
        out = np.empty(out_len, np.uint8)
        r = _native.library().ct_fse_decode_i2(
            sp, sn, _native.ptr(_norm256(norm)), len(norm) - 1,
            int(table_log), _native.ptr(out), out_len)
        if r == 0:
            return out
    return decode_interleaved2_py(stream, norm, table_log, out_len)


def decode_interleaved2_py(stream: bytes, norm: np.ndarray, table_log: int,
                           out_len: int) -> np.ndarray:
    """``decode_interleaved2`` in Python (the reference's loop).  Each
    state's final emission has no encoder-side transition, so the last two
    symbols reload no state."""
    spread, nb, new_state = build_dtable(norm, table_log)
    spread, nb, new_state = spread.tolist(), nb.tolist(), new_state.tolist()
    br = BitReaderReverse(stream)
    s1 = br.read(table_log)
    s2 = br.read(table_log)
    out = bytearray(out_len)
    last = out_len - 2
    for i in range(out_len):
        if i & 1:
            out[i] = spread[s2]
            if i < last:
                s2 = new_state[s2] + br.read(nb[s2])
        else:
            out[i] = spread[s1]
            if i < last:
                s1 = new_state[s1] + br.read(nb[s1])
    if br.bitpos != 0:
        raise ValueError(f"fse: bitstream not fully consumed ({br.bitpos})")
    return np.frombuffer(bytes(out), np.uint8)
