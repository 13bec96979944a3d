"""zstd frame decode on the host core (``zstd_dec.cpp``): the port's copy
of the JAX package's ``zstd/native_dec.py``, the paths that
``zstd.decompress`` takes by default.

``decode_all`` decodes a whole stream (headers, skippable frames, bodies,
checksums) in one native call; ``decode_frame_body`` decodes the blocks of
one frame, its output buffer serving as the history.  Either returns None
where the native decoder refuses the input (a window over its limit, a
corrupt or lying frame): the caller then runs the Python decoder, which
gives the precise error, as the reference does.  The inputs are read in
place: the native decoders read no byte past their input.
"""

from __future__ import annotations

import ctypes

import numpy as np

from compress_tpu_torch import _native

_SLACK = (1 << 17) + 64   # one block of room past the expected output


def _at(data: bytes, pos: int):
    """A pointer to data[pos:] without a copy (data must stay alive)."""
    return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value + pos


def decode_all(data: bytes, max_size: int, max_window: int,
               ignore_checksum: bool):
    """The whole stream's output, or None where the native decoder
    refuses it.  Where every frame declares its content size, a
    headers-only scan sizes the output exactly; otherwise the output
    buffer starts at 4 times the input (at least 1 MiB) and grows 4 times
    at a time up to ``max_size``."""
    lib = _native.library()
    n = len(data)
    ign = 1 if ignore_checksum else 0
    expected = lib.ct_zstd_scan_size(data, n)
    if 0 <= expected <= max_size:
        dst = np.empty(expected + _SLACK, np.uint8)
        r = lib.ct_zstd_decode_all(data, n, _native.ptr(dst),
                                   expected + _SLACK, int(max_window), ign)
        return dst[:r].tobytes() if r == expected else None
    guess = max(4 * n, 1 << 20)
    while True:
        cap = min(guess, max_size) + _SLACK
        dst = np.empty(cap, np.uint8)
        r = lib.ct_zstd_decode_all(data, n, _native.ptr(dst), cap,
                                   int(max_window), ign)
        if r == -3:  # E_SPACE
            if guess >= max_size:
                return None
            guess = min(guess * 4, max_size)
            continue
        if r < 0 or r > max_size:
            return None
        return dst[:r].tobytes()


def decode_frame_body(data: bytes, pos: int, window_size: int,
                      max_out: int, expected: int | None = None):
    """Decode the blocks of the frame whose first block header is at
    ``pos``: (frame output, position of the checksum field), or None where
    the native decoder refuses them (a window over 64 MiB included).
    ``expected`` (the declared content size) sizes the output; a frame
    that overflows it is refused, not grown toward ``max_out``."""
    if window_size > (64 << 20):
        return None
    lib = _native.library()
    body, n = _at(data, pos), len(data) - pos
    guess = expected if expected is not None else max(4 * n, 1 << 20)
    while True:
        cap = min(guess, max_out) + _SLACK
        dst = np.empty(cap, np.uint8)
        consumed = ctypes.c_longlong(0)
        r = lib.ct_zstd_decode_frame(body, n, _native.ptr(dst), cap,
                                     ctypes.byref(consumed), int(window_size))
        if r == -3 and expected is None and guess < max_out:  # E_SPACE
            guess = min(max(guess * 4, 1 << 20), max_out)
            continue
        if r < 0 or r > max_out:
            return None
        return dst[:r].tobytes(), pos + consumed.value
