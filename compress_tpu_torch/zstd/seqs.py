"""zstd sequence code tables (RFC 8878 §3.1.1.3.2.1): the baselines and
extra-bit counts of literal-length and match-length codes, copied from
the JAX package's ``zstd/seqs.py``."""

from __future__ import annotations

import numpy as np

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
