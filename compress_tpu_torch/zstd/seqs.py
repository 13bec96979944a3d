"""zstd sequence coding (RFC 8878 §3.1.1.3.2): the code tables of literal
lengths, match lengths and offsets, the predefined FSE distributions, and
the 3-state interleaved sequence bitstream.  A copy of the JAX package's
``zstd/seqs.py``."""

from __future__ import annotations

import numpy as np

from compress_tpu_torch.fse import core as fse_core

MAX_LL_CODE = 35
MAX_ML_CODE = 52
MAX_OF_CODE = 31  # format allows up to 31; window limits in practice

# literal length codes: 0..15 are the length; 16..35 have baseline + extra
_LL_BASELINE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
                                  128, 256, 512, 1024, 2048, 4096, 8192,
                                  16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8,
                       9, 10, 11, 12, 13, 14, 15, 16]

# match length codes (stored value = length - 3): 0..31 are the value;
# 32..52 have baseline + extra
_ML_BASELINE = [i + 3 for i in range(32)] + [
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539,
]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]

LL_BASELINE = np.array(_LL_BASELINE, dtype=np.int64)
LL_BITS = np.array(_LL_BITS, dtype=np.int64)
ML_BASELINE = np.array(_ML_BASELINE, dtype=np.int64)
ML_BITS = np.array(_ML_BITS, dtype=np.int64)


def _highbit(v: np.ndarray) -> np.ndarray:
    return np.frompyfunc(lambda x: x.bit_length() - 1, 1, 1)(
        v.astype(object)).astype(np.int64)


def ll_code(ll: np.ndarray) -> np.ndarray:
    """Literal length -> code (vectorized)."""
    ll = np.asarray(ll, dtype=np.int64)
    small = np.array(
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
         16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 20, 20, 21, 21, 21, 21,
         22, 22, 22, 22, 22, 22, 22, 22, 23, 23, 23, 23, 23, 23, 23, 23,
         24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24],
        dtype=np.int64)
    big = ll >= 64
    v = ll.copy()
    v[~big] = 1
    # highbit(ll) + 19 for the extended codes
    return np.where(big, _highbit(v) + 19, small[np.minimum(ll, 63)])


def ml_code(mlen: np.ndarray) -> np.ndarray:
    """Match length (actual, >= 3) -> code (vectorized)."""
    v = np.asarray(mlen, dtype=np.int64) - 3  # stored value
    small = np.array(
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
         16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
         32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36, 37, 37, 37, 37,
         38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39],
        dtype=np.int64)
    big = v >= 128  # pure highbit pattern only from 128 up
    w = v.copy()
    w[~big] = 1
    mid = np.where(v < 80, 40, np.where(v < 96, 41, 42))  # 64..127 band
    return np.where(v < 64, small[np.minimum(v, 63)],
                    np.where(big, _highbit(w) + 36, mid))


def of_code(off_value: np.ndarray) -> np.ndarray:
    """Offset *value* (offset + 3 or repeat code 1..3) -> code = highbit."""
    return _highbit(np.asarray(off_value, dtype=np.int64))


# predefined FSE distributions (RFC 8878 §3.1.1.3.2.2)
PREDEF_LL_NORM = np.array(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], dtype=np.int64)
PREDEF_LL_LOG = 6
PREDEF_ML_NORM = np.array(
    [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, dtype=np.int64)
PREDEF_ML_LOG = 6
PREDEF_OF_NORM = np.array(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, -1, -1, -1, -1, -1], dtype=np.int64)
PREDEF_OF_LOG = 5

MAX_LL_LOG = 9
MAX_OF_LOG = 8
MAX_ML_LOG = 9

# per table: (largest code, largest log, predefined norm, predefined log)
TABLE_PARAMS = {
    "ll": (MAX_LL_CODE, MAX_LL_LOG, PREDEF_LL_NORM, PREDEF_LL_LOG),
    "of": (MAX_OF_CODE, MAX_OF_LOG, PREDEF_OF_NORM, PREDEF_OF_LOG),
    "ml": (MAX_ML_CODE, MAX_ML_LOG, PREDEF_ML_NORM, PREDEF_ML_LOG),
}

# sequence section table modes
MODE_PREDEFINED = 0
MODE_RLE = 1
MODE_FSE = 2
MODE_REPEAT = 3


class STable:
    """A built sequence decode/encode table pair."""

    __slots__ = ("norm", "log", "spread", "nb", "new_state",
                 "state_table", "delta_nb", "delta_fs", "mode", "rle_symbol")

    def __init__(self, norm, log, mode=MODE_FSE, rle_symbol=None):
        self.norm = norm
        self.log = log
        self.mode = mode
        self.rle_symbol = rle_symbol
        if rle_symbol is None:
            self.spread, self.nb, self.new_state = fse_core.build_dtable(
                norm, log)
            (self.state_table, self.delta_nb,
             self.delta_fs) = fse_core.build_ctable(norm, log)
        else:
            # RLE table: single state, zero-bit transitions
            self.spread = np.array([rle_symbol], dtype=np.uint8)
            self.nb = np.array([0], dtype=np.int32)
            self.new_state = np.array([0], dtype=np.int32)
            self.state_table = None
            self.delta_nb = None
            self.delta_fs = None
            self.log = 0


def predef_tables():
    return (
        STable(PREDEF_LL_NORM, PREDEF_LL_LOG, MODE_PREDEFINED),
        STable(PREDEF_OF_NORM, PREDEF_OF_LOG, MODE_PREDEFINED),
        STable(PREDEF_ML_NORM, PREDEF_ML_LOG, MODE_PREDEFINED),
    )


def decode_sequences(stream: bytes, n_seqs: int, t_ll: STable, t_of: STable,
                     t_ml: STable):
    """Decode n_seqs (ll, ml, of_value) triples.

    Returns int64 arrays (lls, mls, ofvals): mls are actual match lengths
    (baseline applied), ofvals raw offset values (repeat resolution happens
    at execution, where ll is known)."""
    br = fse_core.BitReaderReverse(stream)
    s_ll = br.read(t_ll.log)
    s_of = br.read(t_of.log)
    s_ml = br.read(t_ml.log)
    lls = np.zeros(n_seqs, dtype=np.int64)
    mls = np.zeros(n_seqs, dtype=np.int64)
    ofs = np.zeros(n_seqs, dtype=np.int64)
    for i in range(n_seqs):
        of_c = int(t_of.spread[s_of])
        ml_c = int(t_ml.spread[s_ml])
        ll_c = int(t_ll.spread[s_ll])
        if of_c > MAX_OF_CODE:
            raise ValueError("offset code too large")
        of_val = (1 << of_c) + br.read(of_c) if of_c > 0 else 1
        ml = _ML_BASELINE[ml_c] + br.read(_ML_BITS[ml_c])
        ll = _LL_BASELINE[ll_c] + br.read(_LL_BITS[ll_c])
        lls[i] = ll
        mls[i] = ml
        ofs[i] = of_val
        if i < n_seqs - 1:
            s_ll = int(t_ll.new_state[s_ll]) + br.read(int(t_ll.nb[s_ll]))
            s_ml = int(t_ml.new_state[s_ml]) + br.read(int(t_ml.nb[s_ml]))
            s_of = int(t_of.new_state[s_of]) + br.read(int(t_of.nb[s_of]))
    if br.bitpos != 0:
        raise ValueError(f"sequence bitstream not exhausted ({br.bitpos})")
    return lls, mls, ofs


def encode_sequences(lls, mls, ofvals, t_ll: STable, t_of: STable,
                     t_ml: STable) -> bytes:
    """Encode sequences; inputs are raw values (ofvals in offset-value
    form)."""
    n = len(lls)
    ll_c = ll_code(lls)
    ml_c = ml_code(mls)
    of_c = of_code(ofvals)
    bw = fse_core.BitWriter()

    def cinit(t: STable, sym: int) -> int:
        if t.rle_symbol is not None:
            return 0
        nb = (int(t.delta_nb[sym]) + (1 << 15)) >> 16
        im = (nb << 16) - int(t.delta_nb[sym])
        lu = (im >> nb) + int(t.delta_fs[sym])
        return int(t.state_table[lu])

    def cenc(t: STable, state: int, sym: int) -> int:
        if t.rle_symbol is not None:
            return 0
        nb = (state + int(t.delta_nb[sym])) >> 16
        bw.add(state, nb)
        return int(t.state_table[(state >> nb) + int(t.delta_fs[sym])])

    def extras(i: int):
        # write order: llx, mlx, ofx (the decoder reads ofx, mlx, llx)
        lc, mc, oc = int(ll_c[i]), int(ml_c[i]), int(of_c[i])
        bw.add(int(lls[i]) - _LL_BASELINE[lc], _LL_BITS[lc])
        bw.add(int(mls[i]) - _ML_BASELINE[mc], _ML_BITS[mc])
        bw.add(int(ofvals[i]) - (1 << oc), oc)

    extras(n - 1)
    st_ll = cinit(t_ll, int(ll_c[n - 1]))
    st_ml = cinit(t_ml, int(ml_c[n - 1]))
    st_of = cinit(t_of, int(of_c[n - 1]))
    for i in range(n - 2, -1, -1):
        st_of = cenc(t_of, st_of, int(of_c[i]))
        st_ml = cenc(t_ml, st_ml, int(ml_c[i]))
        st_ll = cenc(t_ll, st_ll, int(ll_c[i]))
        extras(i)
    # flush: the decoder reads the LL, OF, ML states first
    if t_ml.rle_symbol is None:
        bw.add(st_ml - (1 << t_ml.log), t_ml.log)
    if t_of.rle_symbol is None:
        bw.add(st_of - (1 << t_of.log), t_of.log)
    if t_ll.rle_symbol is None:
        bw.add(st_ll - (1 << t_ll.log), t_ll.log)
    return bw.close()
