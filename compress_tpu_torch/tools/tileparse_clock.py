"""Cycles a tile of the tile parse's warp route, by part, on one card.

    python3 compress_tpu_torch/tools/tileparse_clock.py

Builds ``compress_tpu_torch/csrc/tileparse.cu`` with ``nvcc`` and
``-DCT_TILEPARSE_CLOCK`` into ``compress_tpu_torch/_build/clock/`` (a
library of its own, beside the package's): through the entry
``ct_tile_parse_clock`` each warp of the warp route reads the SM clock
(``clock64``) between the parts of each tile and writes its sums and its
tile count.  The inputs are ``chip_smoke.py``'s:
the S2 XLA engine's L_t at level 1 on ``corpus.corpus_blocks(256, 0)``
at tiles 512 and 256 (phase 25) and the zstd v1 engine's at level 2 on
``corpus.replica_jobs(8, 1 MiB, 0)`` (phase 26), captured with the plain
version standing in for the kernel.  The outputs are held against
``tile_parse_ref``.  Prints, for each input, the launch's device time
(clock build), the warps and tiles a warp, and the mean cycles a tile of
each part: the next cursors (with the flags zeroed and the next tile's
copies issued), waiting for this tile's copies, phase 1 (exits), phase 2
(entries), phase 3 (walks), the stores; then one JSON line.  Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from compress_tpu_torch import _cuda, corpus  # noqa: E402
from compress_tpu_torch.ops import lz2, zdev  # noqa: E402
from compress_tpu_torch.tools.clockbuild import (  # noqa: E402
    compile_source, device_ms)

PARTS = ("cursors", "wait", "phase1", "phase2", "phase3", "store")
N_BLOCKS, JOBS, SEED = 256, 8, 0


def build() -> ctypes.CDLL:
    lib = compile_source("tileparse.cu", ("-DCT_TILEPARSE_CLOCK",))
    sig = _cuda._SIGNATURES["ct_tile_parse"]
    lib.ct_tile_parse_clock.argtypes = sig[:-1] + [ctypes.c_void_p, sig[-1]]
    lib.ct_tile_parse_clock.restype = ctypes.c_int
    return lib


def capture(dev) -> dict:
    """Phase 25's L_t at tiles 512 and 256 and phase 26's, each with its
    tile."""
    from compress_tpu_torch.zstd import device as zdevice

    caps = []
    f_parse = lz2.tile_parse

    def parse(L, tile, **kw):
        caps.append((L, tile))
        return lz2.tile_parse_ref(L, tile)

    lz2.tile_parse = parse
    try:
        blocks = torch.from_numpy(corpus.corpus_blocks(N_BLOCKS, SEED)).to(dev)
        for tile in (512, 256):
            lz2.s2_encode_blocks(blocks, tile, 1)
        data = corpus.replica_jobs(JOBS, zdev.JOB, SEED).tobytes()
        zdevice.compress_device(data, engine="v1", level=2, device=dev)
    finally:
        lz2.tile_parse = f_parse
    return dict(zip(("parse_s2_512", "parse_s2_256", "parse_v1"), caps))


def main() -> int:
    if not torch.cuda.is_available():
        print("tileparse_clock: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    lib = build()
    parses = capture(dev)
    routes = torch.zeros(2, dtype=torch.int32, device=dev)
    result = {}
    for case, (L, tile) in parses.items():
        L = L.contiguous()
        n = L.numel()
        n_tiles = n // tile
        out = torch.empty(2 * n, dtype=torch.bool, device=dev)
        clk = torch.zeros(((n_tiles + 3) // 4 * 4, 7), dtype=torch.int64,
                          device=dev)

        def call():
            rc = lib.ct_tile_parse_clock(
                L.data_ptr(), n_tiles, tile, out.data_ptr(),
                out.data_ptr() + n, routes.data_ptr(), clk.data_ptr(),
                _cuda.stream(dev))
            if rc:
                raise RuntimeError(f"{case}: CUDA error {rc}")

        clk.zero_()
        call()
        torch.cuda.synchronize()
        want = torch.cat([t.reshape(-1) for t in lz2.tile_parse_ref(L, tile)])
        if not torch.equal(out, want):
            raise AssertionError(f"{case}: differs from the plain version")
        c = clk.cpu()
        warps = int((c[:, 6] > 0).sum())
        tiles = int(c[:, 6].sum())
        per = {p: float(c[:, i].sum()) / tiles for i, p in enumerate(PARTS)}
        ms = device_ms(call)
        result[case] = {"device_ms": ms, "tile": tile, "warps": warps,
                        "tiles": tiles, "cycles_a_tile": per}
        print(f"{case} (tile {tile}): device time {ms:.4f} ms (clock "
              f"build); {warps} warps, {tiles / warps:.2f} tiles a warp; "
              f"cycles a tile: " + ", ".join(f"{p} {v:.0f}"
                                             for p, v in per.items()),
              flush=True)
    print(json.dumps({"tileparse_clock": result, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
