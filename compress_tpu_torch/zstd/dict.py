"""zstd dictionaries: load `zstd --train` format, use in both directions,
and BuildDict serialization.  A copy of the JAX package's ``zstd/dict.py``
(host code there too).

Reference parity: zstd/dict.go — magic 0xEC30A437, entropy tables (huff +
OF/ML/LL FSE + 3 rep offsets) + content; InspectDictionary; BuildDict from
(History, Contents) with real-encoder statistics (zstd/dict.go:192+).
Raw (content-only) dictionaries are supported like WithEncoderDictRaw.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from compress_tpu_torch import huff0
from compress_tpu_torch.fse import core as fse_core
from compress_tpu_torch.zstd import seqs as S

DICT_MAGIC = 0xEC30A437


class DictError(ValueError):
    pass


@dataclass
class Dict:
    """A loaded zstd dictionary (reference: zstd.dict struct)."""

    id: int
    content: bytes
    reps: tuple = (1, 4, 8)
    huf: tuple | None = None  # (sym_t, nb_t, max_bits) decode table
    huf_blob: bytes | None = None  # serialized table (for encode reuse)
    t_ll: S.STable | None = None
    t_of: S.STable | None = None
    t_ml: S.STable | None = None

    @property
    def raw(self) -> bool:
        return self.huf is None


def load_dict(blob: bytes) -> Dict:
    """Parse a structured dictionary; raises DictError if not one."""
    blob = bytes(blob)
    if len(blob) < 8 or int.from_bytes(blob[:4], "little") != DICT_MAGIC:
        raise DictError("not a structured zstd dictionary")
    did = int.from_bytes(blob[4:8], "little")
    pos = 8
    huf_start = pos
    sym_t, nb_t, max_bits, pos = huff0.read_table(blob, pos)
    huf_blob = blob[huf_start:pos]
    # FSE tables in stored order: OF, ML, LL
    of_norm, of_log, pos = fse_core.read_ncount(blob, pos, S.MAX_OF_CODE, S.MAX_OF_LOG)
    ml_norm, ml_log, pos = fse_core.read_ncount(blob, pos, S.MAX_ML_CODE, S.MAX_ML_LOG)
    ll_norm, ll_log, pos = fse_core.read_ncount(blob, pos, S.MAX_LL_CODE, S.MAX_LL_LOG)
    if pos + 12 > len(blob):
        raise DictError("truncated rep offsets")
    reps = tuple(int.from_bytes(blob[pos + 4 * k : pos + 4 * k + 4], "little")
                 for k in range(3))
    pos += 12
    content = blob[pos:]
    for r in reps:
        if r == 0 or r > len(content) + 1:
            raise DictError("invalid rep offset")
    return Dict(
        id=did, content=content, reps=reps,
        huf=(sym_t, nb_t, max_bits), huf_blob=huf_blob,
        t_ll=S.STable(ll_norm, ll_log, S.MODE_FSE),
        t_of=S.STable(of_norm, of_log, S.MODE_FSE),
        t_ml=S.STable(ml_norm, ml_log, S.MODE_FSE),
    )


def raw_dict(content: bytes, dict_id: int = 0) -> Dict:
    """Content-only dictionary (reference: WithEncoderDictRaw/DecoderDictRaw)."""
    return Dict(id=dict_id, content=bytes(content))


def inspect_dictionary(blob: bytes) -> Dict:
    """Reference: zstd.InspectDictionary."""
    return load_dict(blob)


def build_dict(contents: list[bytes], history: bytes, dict_id: int = 1,
               level: int = 2) -> bytes:
    """Serialize a dictionary from (history, sample contents).

    Reference behavior (zstd/dict.go BuildDict): encode every sample against
    the history with a real encoder, accumulate ll/ml/of code and literal
    histograms plus the most-used offsets, then emit normalized tables."""
    from compress_tpu_torch.zstd.encoder import Matcher, offsets_to_values

    history = bytes(history)
    if len(history) < 8:
        raise DictError("history too small")
    ll_hist = np.zeros(S.MAX_LL_CODE + 1, dtype=np.int64)
    ml_hist = np.zeros(S.MAX_ML_CODE + 1, dtype=np.int64)
    of_hist = np.zeros(S.MAX_OF_CODE + 1, dtype=np.int64)
    lit_hist = np.ones(256, dtype=np.int64)  # smoothing: every byte possible
    off_counts: dict[int, int] = {}
    for sample in contents:
        sample = bytes(sample)
        if not sample:
            continue
        combined = history + sample
        m = Matcher(combined, level)
        lls, mls, offs, tail = m.next_block(len(history), len(combined))
        if len(lls) == 0:
            lit_hist += np.bincount(np.frombuffer(sample, np.uint8), minlength=256)
            continue
        vals, _ = offsets_to_values(lls, offs)
        ll_hist += np.bincount(S.ll_code(lls), minlength=S.MAX_LL_CODE + 1)[: S.MAX_LL_CODE + 1]
        ml_hist += np.bincount(S.ml_code(mls), minlength=S.MAX_ML_CODE + 1)[: S.MAX_ML_CODE + 1]
        of_hist += np.bincount(
            np.minimum(S.of_code(vals), S.MAX_OF_CODE), minlength=S.MAX_OF_CODE + 1
        )[: S.MAX_OF_CODE + 1]
        for o in offs.tolist():
            off_counts[o] = off_counts.get(o, 0) + 1
        # literals histogram
        p = len(history)
        for i in range(len(lls)):
            lit_hist += np.bincount(
                np.frombuffer(combined[p : p + int(lls[i])], np.uint8), minlength=256
            )
            p += int(lls[i]) + int(mls[i])
        if tail:
            lit_hist += np.bincount(np.frombuffer(tail, np.uint8), minlength=256)

    # top-3 offsets as initial reps (fallback to defaults)
    top = sorted(off_counts.items(), key=lambda kv: -kv[1])[:3]
    reps = [o for o, _ in top]
    while len(reps) < 3:
        reps.append([1, 4, 8][len(reps)])

    out = bytearray(DICT_MAGIC.to_bytes(4, "little"))
    out += dict_id.to_bytes(4, "little")
    nbits, max_bits = huff0.build_nbits(lit_hist, huff0.MAX_TABLELOG)
    out += huff0.write_table(nbits, max_bits)

    def fse_table(hist, max_log):
        hist = hist + (hist.sum() == 0)  # avoid empty
        nz = np.nonzero(hist)[0]
        if len(nz) < 2:
            hist = hist.copy()
            hist[0] += 1
            hist[1] += 1
            nz = np.nonzero(hist)[0]
        max_sym = int(nz[-1])
        total = int(hist.sum())
        tl = fse_core.optimal_table_log(max_log, total, max_sym, max_table_log=max_log)
        norm = fse_core.normalize_count(hist[: max_sym + 1], tl, total, max_sym)
        return fse_core.write_ncount(norm, tl)

    out += fse_table(of_hist, S.MAX_OF_LOG)
    out += fse_table(ml_hist, S.MAX_ML_LOG)
    out += fse_table(ll_hist, S.MAX_LL_LOG)
    for r in reps:
        out += int(max(1, min(r, len(history)))).to_bytes(4, "little")
    out += history
    return bytes(out)
