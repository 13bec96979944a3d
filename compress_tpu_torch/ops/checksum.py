"""Batched CRC-32C and xxHash64 of equal-length rows (counterpart of the
JAX package's ``ops/checksum.py``: ``crc32c_batch`` and ``xxh64_batch``).

The reference computes the CRC as GF(2) matrix products on the MXU and
xxHash64 as a scan over 32-byte stripes in 16-bit limbs; both are XLA
functions, not Pallas kernels.  Here each is a CUDA kernel
(``csrc/checksum.cu``) on CUDA tensors and a plain PyTorch version of the
same arithmetic on CPU tensors.

CRC-32C: each row's first ``n`` bytes are cut into NCHUNK chunks of ``lc``
bytes aligned to the end (chunk t is [n - (NCHUNK - t) lc, n - (NCHUNK -
1 - t) lc)); bytes before 0 are leading zeros, which leave a raw CRC
(state 0, no conditioning) at 0.  Each chunk's raw CRC comes from a byte
table.  The plain version joins neighbours by a tree of log2(NCHUNK)
levels, raw(AB) = raw(A) * x^(8 |B|) mod P xor raw(B); the kernel, by
linearity, XORs every chunk's raw CRC times its shift constant
x^(8 lc (NCHUNK - 1 - t)) mod P (``crc_shifts``, a device buffer cached
per n and device).  The conditioning (initial and final 0xFFFFFFFF) is one
xor with a constant of n alone.  Polynomial products are in the reflected
form (bit 31 holds x^0).

xxHash64: four lanes fold the 8-byte words of every 32-byte stripe in
order, then merge, add the length and avalanche, in wrapping 64-bit
integers.  The result is the reference's (B, 2) [lo, hi] layout of 32-bit
halves, as int64.
"""

from __future__ import annotations

import functools

import torch

from compress_tpu_torch import _cuda

__all__ = ["crc32c_batch", "crc32c_batch_ref", "crc_shifts", "xxh64_batch",
           "xxh64_batch_ref"]

POLY = 0x82F63B78        # CRC-32C, reflected
NCHUNK = 256             # chunks a row: the CRC kernel's threads a CTA
_LEVELS = 8              # log2(NCHUNK)
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63

_I64 = torch.int64


def mulmodp(a: int, b: int) -> int:
    """a * b modulo the CRC-32C polynomial (reflected form)."""
    p = 0
    m = 1 << 31
    while m:
        if a & m:
            p ^= b
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
        m >>= 1
    return p


@functools.lru_cache(maxsize=256)
def xpow8(n: int) -> int:
    """x^(8 n) modulo the CRC-32C polynomial: the operator that moves a
    raw CRC past n zero bytes (cached: a batch's length repeats)."""
    result, base, e = 1 << 31, 1 << 30, 8 * n
    while e:
        if e & 1:
            result = mulmodp(result, base)
        base = mulmodp(base, base)
        e >>= 1
    return result


@functools.lru_cache(maxsize=256)
def _crc_consts(n: int):
    """(lc, x^(8 lc), conditioning constant) for rows of n bytes."""
    lc = max(1, -(-n // NCHUNK))
    return lc, xpow8(lc), mulmodp(xpow8(n), _M32) ^ _M32


@functools.lru_cache(maxsize=256)
def crc_shifts(n: int) -> tuple:
    """The kernel's shift constants for rows of n bytes: entry t is
    x^(8 lc (NCHUNK - 1 - t)) mod P, the operator that moves chunk t's raw
    CRC past the chunks after it (the last entry is 1, bit 31)."""
    _, x1, _ = _crc_consts(n)
    out = [1 << 31]
    for _ in range(NCHUNK - 1):
        out.append(mulmodp(out[-1], x1))
    return tuple(out[::-1])


@functools.lru_cache(maxsize=64)
def _shift_buffer(n: int, device: torch.device) -> torch.Tensor:
    """``crc_shifts(n)`` on ``device``: (NCHUNK,) int32 holding the 32-bit
    values."""
    return torch.tensor([v - (1 << 32) if v >> 31 else v
                         for v in crc_shifts(n)], dtype=torch.int32,
                        device=device)


def _crc_args(blocks: torch.Tensor, length):
    """(n, lc, x^(8 lc), conditioning constant) for the rows' first n
    bytes."""
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError("crc32c_batch: expected a (B, N) uint8 tensor")
    N = blocks.shape[1]
    n = N if length is None else int(length)
    if not 0 <= n <= N:
        raise ValueError(f"crc32c_batch: length {n} outside 0..{N}")
    return (n, *_crc_consts(n))


def _table() -> list:
    t = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        t.append(c)
    return t


_TABLE = _table()


def _mul_const(a: torch.Tensor, b: int) -> torch.Tensor:
    """a * b mod P for an int64 tensor of 32-bit values and a constant."""
    p = torch.zeros_like(a)
    for k in range(32):
        p ^= torch.where((a >> (31 - k)) & 1 == 1, b, 0)
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
    return p


def crc32c_batch_ref(blocks: torch.Tensor, length: int | None = None):
    """Plain version of ``crc32c_batch``."""
    n, lc, x1, cond = _crc_args(blocks, length)
    B = blocks.shape[0]
    dev = blocks.device
    start = n - (NCHUNK - torch.arange(NCHUNK, device=dev, dtype=_I64)) * lc
    pos = start[:, None] + torch.arange(lc, device=dev, dtype=_I64)
    data = torch.where(pos >= 0, blocks[:, pos.clamp(min=0)].to(_I64), 0)
    tab = torch.tensor(_TABLE, dtype=_I64, device=dev)
    c = torch.zeros((B, NCHUNK), dtype=_I64, device=dev)
    for j in range(lc):
        c = tab[(c ^ data[:, :, j]) & 255] ^ (c >> 8)
    for level in range(_LEVELS):
        h = 1 << level
        c = c.view(B, -1, 2 * h)
        c = torch.cat([(_mul_const(c[:, :, 0], x1) ^ c[:, :, h])[:, :, None],
                       c[:, :, 1:]], dim=2).view(B, NCHUNK)
        x1 = mulmodp(x1, x1)
    return c[:, 0] ^ cond


def crc32c_batch(blocks: torch.Tensor, length: int | None = None):
    """CRC-32C (initial and final 0xFFFFFFFF) of each row's first
    ``length`` bytes (all N when None).

    blocks (B, N) uint8.  Returns (B,) int64 holding the 32-bit values.  A
    CUDA tensor goes through the kernel (one launch), a CPU tensor through
    ``crc32c_batch_ref``."""
    if blocks.device.type == "cpu":
        return crc32c_batch_ref(blocks, length)
    n, lc, _, cond = _crc_args(blocks, length)
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"crc32c_batch: expected a CUDA tensor, got {dev}")
    if blocks.stride(1) != 1:
        blocks = blocks.contiguous()
    B = blocks.shape[0]
    out = torch.empty(B, dtype=_I64, device=dev)
    with torch.cuda.device(dev):
        shifts = _shift_buffer(n, torch.device("cuda",
                                               torch.cuda.current_device()))
        rc = _cuda.library().ct_crc32c_batch(
            blocks.data_ptr(), blocks.stride(0), B, n, lc, shifts.data_ptr(),
            cond, out.data_ptr(), _cuda.stream(dev))
    _cuda.check(rc, "crc32c_batch")
    crc32c_batch.launches += 1
    return out


crc32c_batch.launches = 0


def _signed(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 values by 1 <= r <= 63."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def _round(acc: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    acc = acc + inp * _signed(_P2)
    return _rotl(acc, 31) * _signed(_P1)


def _xxh_check(blocks: torch.Tensor):
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError("xxh64_batch: expected a (B, N) uint8 tensor")
    N = blocks.shape[1]
    if N % 32 or N < 32:
        raise ValueError("xxh64_batch needs N % 32 == 0, N >= 32")


def xxh64_batch_ref(blocks: torch.Tensor, seed: int = 0):
    """Plain version of ``xxh64_batch``."""
    _xxh_check(blocks)
    B, N = blocks.shape
    seed &= _M64
    words = _cuda.aligned(blocks.contiguous(), 8).view(_I64).view(
        B, N // 32, 4)
    acc = torch.tensor([_signed(seed + _P1 + _P2), _signed(seed + _P2),
                        _signed(seed), _signed(seed - _P1)], dtype=_I64,
                       device=blocks.device).expand(B, 4)
    for s in range(N // 32):
        acc = _round(acc, words[:, s])
    h = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7) + _rotl(acc[:, 2], 12)
         + _rotl(acc[:, 3], 18))
    for k in range(4):
        h = h ^ _round(torch.zeros_like(h), acc[:, k])
        h = h * _signed(_P1) + _signed(_P4)
    h = h + N
    h = h ^ _lsr(h, 33)
    h = h * _signed(_P2)
    h = h ^ _lsr(h, 29)
    h = h * _signed(_P3)
    h = h ^ _lsr(h, 32)
    return torch.stack([h & _M32, _lsr(h, 32)], dim=1)


def xxh64_batch(blocks: torch.Tensor, seed: int = 0):
    """xxHash64 with ``seed`` (any integer, taken mod 2^64) of each row.

    blocks (B, N) uint8 with N % 32 == 0 and N >= 32.  Returns (B, 2)
    int64: the digest's low and high 32-bit halves.  A CUDA tensor goes
    through the kernel (one launch), a CPU tensor through
    ``xxh64_batch_ref``."""
    if blocks.device.type == "cpu":
        return xxh64_batch_ref(blocks, seed)
    _xxh_check(blocks)
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"xxh64_batch: expected a CUDA tensor, got {dev}")
    blocks = _cuda.aligned(blocks.contiguous(), 8)
    B, N = blocks.shape
    out = torch.empty((B, 2), dtype=_I64, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_xxh64_batch(
            blocks.data_ptr(), B, N, seed & _M64, out.data_ptr(),
            _cuda.stream(dev))
    _cuda.check(rc, "xxh64_batch")
    xxh64_batch.launches += 1
    return out


xxh64_batch.launches = 0
