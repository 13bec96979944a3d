"""The paths that build entropy tables, timed on one card with the
table-build kernels and with their plain versions, in turns.

    python3 compress_tpu_torch/tools/tablebuild_ab.py [--rounds N]

Two arms in one process: ``kernel`` is the package as it is (on CUDA
tensors ``ops/zdev._huff_build`` and ``_normalize_count`` launch
``csrc/tablebuild.cu``); ``plain`` sends the same calls to
``_huff_build_ref`` and ``_normalize_count_ref`` on the card, wherever
the encoders look them up (``zdev``, ``zenc2``, ``entropy``), which is
the code the port ran before the kernels.  Each round runs plain,
kernel, kernel, plain.  Every arm times, on ``chip_smoke.py``'s inputs
(seed 0):

- the v2 literal stage of its phase 9 (8 jobs of 4 MiB, 512 blocks of
  64 KiB), with its split (``literal_split``): the masked histograms, the
  Huffman build, the canonical codes, ``_litlut``, ``_bitpack_rows`` and
  the stream split around them, by CUDA events (median of 3);
- the whole v2 ``compress_device`` of those 32 MiB (phase 11), the huff0
  encode ``compress_4x_batch`` of both engines (phases 14-15: 1024 rows
  of 16 KiB of text at maxlog 8 with one table, the corpus at maxlog 11
  with a table a row), the FSE ``compress_batch`` of the corpus rows
  (phase 23) and ``compress_device(engine="v1")`` of 8 jobs of 1 MiB at
  levels 1-3 (phase 26), on the host clock (median of 2).

It fails unless both arms give the same frames and containers, and
prints one JSON line an arm and the medians by arm.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import cuda_ms, host_ms  # noqa: E402

SEED = 0
ZSTD_JOB, ZSTD_JOBS = 4 << 20, 8   # chip_smoke.py's phases 9-11
N_BLOCKS = 256                     # its 16 MiB corpus
ROW = 16 << 10


def literal_split(lits, lit_cnt, bs: int, reps: int = 3) -> dict:
    """The v2 literal stage (``zenc2._literal_stage``) on its inputs, and
    its parts, in ms by CUDA events: ``literal`` the whole stage;
    ``tables`` its table build (``_literal_tables``), of which
    ``histograms`` (the masked per-row counts), ``huff_build`` and
    ``codes`` (``_canonical_codes_dev``); ``litlut``; ``bitpack``
    (``_bitpack_rows`` on the stage's own items); ``split_and_bitpack``,
    the stage with its tables and its ``_litlut`` outputs handed in ready
    (the 4-stream split, the bit destinations and the bit-pack)."""
    from compress_tpu_torch.ops import zdev, zenc2
    from compress_tpu_torch.utils.histogram import byte_histograms

    tables = zenc2._literal_tables(lits, lit_cnt, bs)
    is_lit, nbits, max_bits, _, packed = tables
    looked_up = zenc2._litlut(lits, packed)
    hist = byte_histograms(lits, is_lit).to(torch.int64)
    seen = []
    orig = zenc2._bitpack_rows
    zenc2._bitpack_rows = lambda *a, **kw: seen.append((a, kw)) or orig(
        *a, **kw)
    try:
        zenc2._literal_stage(lits, lit_cnt, bs)
    finally:
        zenc2._bitpack_rows = orig
    (pack_args, pack_kw), = seen

    def split_and_bitpack():
        saved = zenc2._literal_tables, zenc2._litlut
        zenc2._literal_tables = lambda *a: tables
        zenc2._litlut = lambda *a: looked_up
        try:
            return zenc2._literal_stage(lits, lit_cnt, bs)
        finally:
            zenc2._literal_tables, zenc2._litlut = saved

    parts = {
        "literal": lambda: zenc2._literal_stage(lits, lit_cnt, bs),
        "tables": lambda: zenc2._literal_tables(lits, lit_cnt, bs),
        "histograms": lambda: byte_histograms(lits, is_lit),
        "huff_build": lambda: zenc2._huff_build(hist),
        "codes": lambda: zdev._canonical_codes_dev(nbits, max_bits),
        "litlut": lambda: zenc2._litlut(lits, packed),
        "bitpack": lambda: zenc2._bitpack_rows(*pack_args, **pack_kw),
        "split_and_bitpack": split_and_bitpack}
    return {k: cuda_ms(fn, reps) for k, fn in parts.items()}


@contextlib.contextmanager
def plain_builds():
    """Send every call of the two table builds to their plain versions
    while the block runs."""
    from compress_tpu_torch.ops import entropy, zdev, zenc2

    names = {"_huff_build": (zdev._huff_build_ref, (zdev, zenc2, entropy)),
             "_normalize_count": (zdev._normalize_count_ref,
                                  (zdev, entropy))}
    saved = [(m, name, getattr(m, name))
             for name, (_, mods) in names.items() for m in mods]
    for name, (ref, mods) in names.items():
        for m in mods:
            setattr(m, name, ref)
    try:
        yield
    finally:
        for m, name, f in saved:
            setattr(m, name, f)


def inputs(dev) -> dict:
    """chip_smoke.py's inputs of the paths that build tables."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import zdev, zenc2, zparse
    from compress_tpu_torch.zstd import device as zdevice

    data_np = corpus.replica_jobs(ZSTD_JOBS, ZSTD_JOB, SEED)
    jobs, prefixes, has_prefix = zdevice.launch_inputs(
        torch.from_numpy(data_np), 0, ZSTD_JOBS, ZSTD_JOB)
    blocks, off, L, _ = zenc2._merged_matches(
        jobs.to(dev), prefixes.to(dev), has_prefix.to(dev))
    lits, lit_cnt = zparse.parse_blocks(blocks, off, L)[3::2]
    rng = np.random.default_rng(SEED)
    text = np.concatenate([corpus.make_block("text", rng)
                           for _ in range(N_BLOCKS)]).reshape(-1, ROW)
    rows = corpus.corpus_blocks(N_BLOCKS, SEED).reshape(-1, ROW)
    return {"v2": data_np.tobytes(), "lits": lits, "lit_cnt": lit_cnt,
            "text": text, "rows": rows,
            "v1": corpus.replica_jobs(ZSTD_JOBS, zdev.JOB, SEED).tobytes()}


def arm(x: dict) -> tuple:
    """(times, outputs) of one arm."""
    from compress_tpu_torch import fse, huff0
    from compress_tpu_torch.ops import zenc2
    from compress_tpu_torch.zstd import device as zdevice

    calls = {
        "v2_call": lambda: zdevice.compress_device(x["v2"], job=ZSTD_JOB),
        "huff0_shared_encode": lambda: huff0.compress_4x_batch(
            x["text"], shared_table=True, max_log=8),
        "huff0_table_encode": lambda: huff0.compress_4x_batch(
            x["rows"], max_log=11),
        "fse_compress_batch": lambda: fse.compress_batch(x["rows"]),
        **{f"v1_level{lv}_call": lambda lv=lv: zdevice.compress_device(
            x["v1"], engine="v1", level=lv) for lv in (1, 2, 3)}}
    out = {k: fn() for k, fn in calls.items()}
    t = {f"literal_{k}": v for k, v in literal_split(
        x["lits"], x["lit_cnt"], zenc2.BLOCK).items()}
    t.update({k: host_ms(fn, 2) for k, fn in calls.items()})
    return t, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tablebuild_ab: no CUDA device", file=sys.stderr)
        return 2
    from compress_tpu_torch import _cuda

    dev = torch.device("cuda")
    _cuda.library()
    x = inputs(dev)
    print(f"tablebuild_ab: {torch.cuda.get_device_name(0)}; arms plain, "
          f"kernel, kernel, plain x {args.rounds}", flush=True)
    by_arm = {"plain": [], "kernel": []}
    first = None
    for _ in range(args.rounds):
        for name in ("plain", "kernel", "kernel", "plain"):
            ctx = plain_builds() if name == "plain" else \
                contextlib.nullcontext()
            with ctx:
                t, out = arm(x)
            if first is None:
                first = out
            elif out != first:
                bad = [k for k in out if out[k] != first[k]]
                raise AssertionError(f"the {name} arm's outputs differ: "
                                     f"{bad}")
            by_arm[name].append(t)
            print(json.dumps({"arm": name, "ms": t}), flush=True)
    med = {name: {k: statistics.median(t[k] for t in ts) for k in ts[0]}
           for name, ts in by_arm.items()}
    for k in med["plain"]:
        print(f"{k:34s} plain {med['plain'][k]:12.4f} ms  kernel "
              f"{med['kernel'][k]:12.4f} ms")
    print(json.dumps({"median_ms": med, "outputs_equal": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
