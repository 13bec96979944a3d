"""256-bin byte histograms (counterpart of the JAX package's
``utils/histogram.py``, and of the per-row one-hot sums of its
``ops/entropy.py``, ``ops/zenc2.py`` and ``ops/zdev.py``): ``histogram256``
on the host, ``histogram256_torch`` of a whole tensor and
``byte_histograms`` of each row of a batch, on the tensor's own device.

The reference counts on the device with one-hot compares summed per
segment or per row.  Here a CUDA tensor goes through one launch of the
histogram kernel (``csrc/histogram.cu``: 8-bit counters of each thread's
own in shared memory, a byte an ordinary load, add and store, merged
between passes of at most 255 values a thread), and a CPU
tensor through the plain versions: a scatter-add of ones (or of the mask)
into one row of 256 bins a row, and, for a whole input, into LANES rows of
257 bins (position p counts in row p % LANES, so neighbouring values add
into different rows instead of contending for one counter), the last bin
taking every value outside 0..255 (the reference counts none of them),
and the rows summed.  One PyTorch call, ``torch.bincount``, computes the
whole-input function for uint8 input; ``chip_smoke.py`` times it beside
the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _cuda

LANES = 1024  # rows of counters of histogram256_torch_ref

_I32 = torch.int32
_I64 = torch.int64
# the dtypes the kernel reads, and their codes in its C entry
_KINDS = {torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
          torch.int64: 4}


def histogram256(data) -> np.ndarray:
    """Host path: counts of each byte value, shape (256,), int64."""
    buf = (data if isinstance(data, np.ndarray)
           else np.frombuffer(bytes(data), dtype=np.uint8))
    return np.bincount(buf.reshape(-1), minlength=256).astype(np.int64)


def _check_segment(segment: int) -> None:
    if segment <= 0:
        raise ValueError(f"segment must be positive, got {segment}")


def histogram256_torch_ref(x: torch.Tensor, segment: int = 1 << 14):
    """Plain version of ``histogram256_torch``."""
    _check_segment(segment)
    v = x.reshape(-1).to(_I64)
    lane = torch.arange(v.numel(), device=x.device) % LANES
    idx = lane * 257 + torch.where((v >= 0) & (v < 256), v, 256)
    hist = torch.zeros(LANES * 257, dtype=_I64, device=x.device)
    hist.scatter_add_(0, idx, torch.ones(1, dtype=_I64,
                                         device=x.device).expand_as(idx))
    return hist.view(LANES, 257)[:, :256].sum(dim=0).to(_I32)


def histogram256_torch(x: torch.Tensor, segment: int = 1 << 14):
    """(256,) int32 counts of the values 0..255 of ``x`` (any shape,
    flattened), on ``x``'s device.  ``segment`` is the reference's tile
    length (a positive integer); the counts do not depend on it.

    A CUDA tensor of uint8, int8, int16, int32 or int64 goes through the
    kernel (one launch); a CPU tensor (of any dtype the plain version
    converts to int64) through ``histogram256_torch_ref``."""
    if x.device.type == "cpu":
        return histogram256_torch_ref(x, segment)
    _check_segment(segment)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"histogram256_torch: expected a CUDA tensor, got "
                         f"{dev}")
    kind = _KINDS.get(x.dtype)
    if kind is None:
        raise ValueError(f"histogram256_torch: the kernel reads "
                         f"{sorted(str(d) for d in _KINDS)}, got {x.dtype}")
    v = x.reshape(-1).contiguous()   # a 1-D view keeps its stride
    if v.data_ptr() % v.element_size():
        v = v.clone()
    out = torch.empty(256, dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_histogram256(
            v.data_ptr(), v.numel(), kind, out.data_ptr(), _cuda.stream(dev))
    _cuda.check(rc, "histogram256_torch")
    histogram256_torch.launches += 1
    return out


histogram256_torch.launches = 0


def _check_rows(blocks: torch.Tensor, mask) -> None:
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError(f"byte_histograms: expected an (N, L) uint8 tensor, "
                         f"got {tuple(blocks.shape)} {blocks.dtype}")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != blocks.shape
                             or mask.device != blocks.device):
        raise ValueError("byte_histograms: expected a bool mask of the "
                         "blocks' shape on their device")


def byte_histograms_ref(blocks: torch.Tensor, mask=None) -> torch.Tensor:
    """Plain version of ``byte_histograms``."""
    _check_rows(blocks, mask)
    b = blocks.to(_I64)
    hist = torch.zeros((blocks.shape[0], 256), dtype=_I64,
                       device=blocks.device)
    hist.scatter_add_(1, b, torch.ones_like(b) if mask is None
                      else mask.to(_I64))
    return hist.to(_I32)


def byte_histograms(blocks: torch.Tensor, mask=None) -> torch.Tensor:
    """(N, L) uint8 -> (N, 256) int32 per-row byte counts: of every byte,
    or with ``mask`` ((N, L) bool) of the bytes where it is True.

    A CUDA tensor goes through the kernel (one launch; rows at any
    address and row stride), a CPU tensor through
    ``byte_histograms_ref``."""
    if blocks.device.type == "cpu":
        return byte_histograms_ref(blocks, mask)
    _check_rows(blocks, mask)
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"byte_histograms: expected a CUDA tensor, got {dev}")
    N, L = blocks.shape
    out = torch.empty((N, 256), dtype=_I32, device=dev)
    if N == 0:
        return out
    if blocks.stride(1) != 1:
        blocks = blocks.contiguous()
    if mask is not None:
        if mask.stride(1) != 1:
            mask = mask.contiguous()
        # the kernel reads a row and its mask 16 bytes at a time from the
        # same offsets: both must sit at the same address modulo 16
        if (blocks.data_ptr() - mask.data_ptr()) % 16 or \
                (blocks.stride(0) - mask.stride(0)) % 16:
            blocks = _cuda.aligned(blocks.contiguous())
            mask = _cuda.aligned(mask.contiguous())
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_byte_histograms(
            blocks.data_ptr(), blocks.stride(0), N, L,
            None if mask is None else mask.data_ptr(),
            0 if mask is None else mask.stride(0), out.data_ptr(),
            _cuda.stream(dev))
    _cuda.check(rc, "byte_histograms")
    byte_histograms.launches += 1
    return out


byte_histograms.launches = 0
