"""On-card differential sweep: every hand-written CUDA kernel of the port
(rows 1-18 and a-c of PERF.md's kernel table) against its plain PyTorch
version on hostile inputs, in one command, bit for bit (tolerance 0: the
outputs are integers and bytes).

    python3 compress_tpu_torch/tools/gpu_diff.py

The inputs are made here from seeds: ``corpus.py``'s block classes and its
hostile classes (the finder's blocks, the parse and execute plans, the
repeat and FSE chains, the huff0, sequence and FSE chunk classes with
``FSE_DEC_WILD``'s tables of any int32 entry), tile-parse lengths at the
tile's edges and near INT32_MAX, FSE scan tables broken so that they
take the exact step, and the table builds' hostile counts.  Each check
also requires its wrapper's launch count to rise, so the kernel ran and
not the plain version.  The entries that
take ``routes=`` (rows 13, 14, 17 and 18) print the work on each route.

It exits 1 on any mismatch or error and 2 when no CUDA card is present:
there is no CPU fallback (the plain versions are what it compares with).
The port's ``chip_smoke.py`` drives the main paths; this tool is the
sweep of the kernels alone.
"""

from __future__ import annotations

import ctypes
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

I32_MAX = (1 << 31) - 1


class Mismatch(AssertionError):
    pass


def _same(got, want, what: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    if len(got) != len(want):
        raise Mismatch(f"{what}: {len(got)} outputs, plain {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise Mismatch(f"{what}: output {k} differs from the plain "
                           "version")


def _launched(fn, *args, **kw):
    """fn(*args, **kw), which must raise fn's launch count by one (on CPU
    tensors, where the wrapper runs its plain version, it counts none)."""
    before = fn.launches
    out = fn(*args, **kw)
    if not torch.cuda.is_available():
        return out
    torch.cuda.synchronize()
    if fn.launches != before + 1:
        raise Mismatch(f"{fn.__name__}: {fn.launches - before} launches, "
                       "not 1")
    return out


def _on(dev, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _blocks(dev, n: int = 16, seed: int = 5):
    from compress_tpu_torch import corpus

    return torch.from_numpy(corpus.corpus_blocks(n, seed)).to(dev)


# ---- rows 1-8: the encoders' kernels --------------------------------------

def check_finder(dev) -> str:
    """Rows 1-2: the finder at caps 10 and 6 on the corpus classes and the
    finder's hostile blocks."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import lzkern

    sets = {"corpus": _blocks(dev),
            "hostile": torch.from_numpy(np.stack(
                [corpus.finder_block(k) for k in corpus.FINDER_CLASSES])
            ).to(dev)}
    for name, t in sets.items():
        for slim in (False, True):
            _same(_launched(lzkern.find_matches_blocks, t, slim=slim),
                  lzkern.find_matches_blocks_ref(t, slim=slim),
                  f"finder ({name}, slim={slim})")
    return f"{len(sets)} sets x 2 caps"


def check_emit(dev) -> str:
    """Rows 3-4: the S2 parse+emit at the finder's caps and at a run-time
    cap, on the corpus and the parse classes."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import lzemit2, lzkern

    t = _blocks(dev)
    sets = [(t, *lzkern.find_matches_blocks_ref(t))]
    for kind in corpus.PARSE_CLASSES:
        sets.append(tuple(x[None] for x in _on(dev, *corpus.parse_inputs(
            kind))))
    for k, (b, off, L) in enumerate(sets):
        for cap in (lzkern.L_CAP, lzkern.L_CAP_SLIM, 17):
            _same(_launched(lzemit2.emit_blocks, b, off, L, cap=cap),
                  lzemit2.emit_blocks_ref(b, off, L, cap=cap),
                  f"emit (set {k}, cap {cap})")
    return f"{len(sets)} sets x 3 caps"


def check_zparse(dev) -> str:
    """Row 5: the zstd parse on the corpus, a replica job's blocks and the
    parse classes, at cap 10 and a run-time cap."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import lzkern, zparse

    rep = torch.from_numpy(corpus.replica_jobs(1, 1 << 20, 3).reshape(
        -1, lzkern.BS)).to(dev)
    sets = [(t, *lzkern.find_matches_blocks_ref(t))
            for t in (_blocks(dev), rep)]
    for kind in corpus.PARSE_CLASSES:
        sets.append(tuple(x[None] for x in _on(dev, *corpus.parse_inputs(
            kind))))
    for k, (b, off, L) in enumerate(sets):
        for cap in (10, 6):
            _same(_launched(zparse.parse_blocks, b, off, L, cap=cap),
                  zparse.parse_blocks_ref(b, off, L, cap=cap),
                  f"zparse (set {k}, cap {cap})")
    return f"{len(sets)} sets x 2 caps"


def check_rep_scan(dev) -> str:
    """Row 6: the repeat-offset scan on the corpus's sequences and every
    repeat class (offsets of 0, negative and near INT32_MAX)."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import lzkern, zparse, zseqenc

    t = _blocks(dev)
    ll, ml, of, _, n, _ = zparse.parse_blocks_ref(
        t, *lzkern.find_matches_blocks_ref(t))
    sets = [(of, ll, n)] + [tuple(_on(dev, *corpus.rep_inputs(k)))
                            for k in corpus.REP_CLASSES]
    for k, args in enumerate(sets):
        _same(_launched(zseqenc.rep_scan, *args),
              zseqenc.rep_scan_ref(*args), f"rep_scan (set {k})")
    return f"{len(sets)} sets"


def check_fse_chain(dev) -> str:
    """Row 7: the FSE chain on the corpus's codes and every FSE class,
    also with the clamped re-walk everywhere."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import lzkern, zenc2, zparse, zseqenc

    t = _blocks(dev)
    ll, ml, of, _, n, _ = zparse.parse_blocks_ref(
        t, *lzkern.find_matches_blocks_ref(t))
    rep = zseqenc.rep_scan_ref(of, ll, n)
    pk_ll, pk_of, pk_ml, tables, *_ = zenc2._codes_stage(ll, ml, rep, n)
    sets = [(pk_ll, pk_of, pk_ml, n, tables)] + [
        tuple(_on(dev, *corpus.fse_inputs(k))) for k in corpus.FSE_CLASSES]
    for k, args in enumerate(sets):
        want = zseqenc.fse_chain_ref(*args)
        _same(_launched(zseqenc.fse_chain, *args), want, f"fse_chain ({k})")
        _same(_launched(zseqenc.fse_chain, *args, clamped_only=True), want,
              f"fse_chain clamped ({k})")
    return f"{len(sets)} sets"


def check_litlut(dev) -> str:
    """Row 8: the literal lookup on rows of odd lengths, every byte value
    and misaligned starts, tables over the whole int32 range."""
    from compress_tpu_torch.ops import zenc2

    rng = np.random.default_rng(8)
    sets = []
    for R, bs in ((1, 4), (3, 20), (3, 65540), (5, 1 << 16)):
        lits = rng.integers(0, 256, (R, bs), dtype=np.uint8)
        if bs == 1 << 16:
            lits = np.stack([rng.permutation(np.arange(bs) % 256)
                             for _ in range(R)]).astype(np.uint8)
        sets.append(torch.from_numpy(lits).to(dev))
    buf = torch.from_numpy(rng.integers(0, 256, 3 * 65540 + 64,
                                        dtype=np.uint8)).to(dev)
    for start in (4, 1):   # contiguous rows that start off a 16-byte line
        sets.append(buf[start:start + 3 * 65540].view(3, 65540))
    for k, lits in enumerate(sets):
        tab = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, (lits.shape[0], 2, 128),
            dtype=np.int64).astype(np.int32)).to(dev)
        _same(_launched(zenc2._litlut, lits, tab),
              zenc2._litlut_ref(lits, tab), f"litlut (set {k})")
    return f"{len(sets)} sets"


# ---- rows 9-12: the decoders' kernels -------------------------------------

def check_huff0(dev) -> str:
    """Row 9: the huff0 chunk decode on every hostile class, through the
    shared-table entry, a table per 100 chunks and the class's own rows,
    and the per-container entry where the peek is 11 bits."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import entropy_dec, entropy_kern

    for kind in corpus.HUFF0_CLASSES:
        d = corpus.huff0_inputs(kind)
        k, mb = d["k"], d["max_bits"]
        w, lb, ns = _on(dev, d["windows"], d["lbit"], d["nsym"])
        tab0 = _on(dev, d["tables"][0])[0]
        _same(_launched(entropy_kern.huff0_decode_chunks_shared, w, lb, ns,
                        tab0, k=k, max_bits=mb),
              entropy_kern.huff0_decode_chunks_shared_ref(
                  w, lb, ns, tab0, k=k, max_bits=mb), f"huff0 {kind} shared")
        nc = w.shape[0]
        for per_row in sorted({100, d["per_row"]} - {0}):
            rows = -(-nc // per_row)
            tabs_np = (d["tables"] if len(d["tables"]) == rows
                       else np.repeat(d["tables"][:1], rows, 0))
            tabs = _on(dev, tabs_np)[0]
            _same(entropy_kern.launch(w, lb, ns, tabs, per_row, k, mb),
                  entropy_kern.decode_chunks_plain(w, lb, ns, tabs, per_row,
                                                   k, mb),
                  f"huff0 {kind} per_row {per_row}")
            if mb == 11 and nc % per_row == 0:
                N = nc // per_row
                args = (w.view(N, per_row, -1), lb.view(N, per_row),
                        ns.view(N, per_row), tabs)
                _same(_launched(entropy_dec.huff0_decode_chunks, *args, k=k),
                      entropy_dec.huff0_decode_chunks_ref(*args, k=k),
                      f"huff0 {kind} per container")
    return f"{len(corpus.HUFF0_CLASSES)} classes"


def check_zseq(dev) -> str:
    """Row 10: the sequence decode on every hostile class through its
    entry, then the kernel at k = 1-8 under both repeat-code-3 rules."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import entropy_dec, zseq_kern

    for kind in corpus.ZSEQ_CLASSES:
        d = corpus.zseq_inputs(kind)
        t = dict(zip(("windows", "lbit", "nsym", "states", "reps", "tables"),
                     _on(dev, *(d[k] for k in ("windows", "lbit", "nsym",
                                               "states", "reps",
                                               "tables")))))
        if d["shared"]:
            last = _on(dev, d["last"])[0]
            args = (t["windows"], t["lbit"], t["nsym"], t["states"],
                    t["reps"], last, t["tables"][0])
            _same(_launched(zseq_kern.zseq_decode_chunks_shared, *args),
                  zseq_kern.zseq_decode_chunks_shared_ref(*args),
                  f"zseq {kind} shared")
            nore = t["nsym"] - (last > 0).to(torch.int32)
        else:
            nore = _on(dev, d["nore"])[0]
            C = d["per_row"]
            N = t["lbit"].shape[0] // C
            cols = [x.contiguous().view(N, C) for x in (
                t["lbit"], *t["states"].unbind(1), t["nsym"], nore)]
            reps = [x.contiguous().view(N, C) for x in t["reps"].unbind(1)]
            wv = t["windows"].view(N, C, -1)
            for fn, ref, extra in (
                    (entropy_dec.zseq_decode_chunks_rep,
                     entropy_dec.zseq_decode_chunks_rep_ref, reps),
                    (entropy_dec.zseq_decode_chunks,
                     entropy_dec.zseq_decode_chunks_ref, [])):
                got, got_e = _launched(fn, wv, *cols, *extra, t["tables"])
                want, want_e = ref(wv, *cols, *extra, t["tables"])
                _same([*got, got_e], [*want, want_e],
                      f"zseq {kind} {fn.__name__}")
        nore = nore.to(torch.int32).contiguous()
        for per_row, tabs in ((0, t["tables"][:1]),
                              (d["per_row"], t["tables"])):
            for k in range(1, 9):
                for floor in (False, True):
                    _same(zseq_kern.launch(
                        t["windows"], t["lbit"], t["nsym"], nore,
                        t["states"].unbind(1), t["reps"].unbind(1), tabs,
                        per_row, k, floor),
                        zseq_kern.decode_plain(
                            t["windows"], t["lbit"], t["nsym"], nore,
                            t["states"], t["reps"], tabs, per_row, k, floor),
                        f"zseq {kind} k={k} floor={floor} per_row={per_row}")
    return f"{len(corpus.ZSEQ_CLASSES)} classes x k 1-8 x 2 rules"


def check_exec(dev) -> str:
    """Row 11: the LZ execute on the S2 decode's compact plans (M = 1, 2,
    4), the hostile plans, and the sum route on the plans only a sum gets
    right."""
    from compress_tpu_torch import corpus, s2
    from compress_tpu_torch.ops import execute
    from compress_tpu_torch.s2.device_dec import plan_blocks

    data = corpus.corpus_blocks(4, 9).tobytes()
    blocks = [s2.encode(data[i:i + n]) for i, n in ((0, 1 << 16),
                                                    (1, 100000),
                                                    (7, 200000))]
    _, classes = plan_blocks(blocks)
    sets = [(c["lit_rows"], c["plans"]) for c in classes]
    for M in (1, 2, 4):
        plans = corpus.exec_hostile_plans(M)
        sets.append((np.random.default_rng(M).integers(
            0, 256, (len(plans), 512 * M, 128), np.uint8), plans))
    for k, (lit, plans) in enumerate(sets):
        pieces, rstart = execute.pack_pieces(plans, lit.shape[1])
        args = _on(dev, lit, pieces, rstart)
        _same(_launched(execute.execute_pieces, *args),
              execute.execute_pieces_ref(*args), f"execute_pieces ({k})")
    planned = corpus.exec_hostile_plans(1)[1]
    for kind, plan in corpus.exec_sum_plans().items():
        src, dst, length, caps = execute.pack_plans([plan, planned])
        lit = np.random.default_rng(3).integers(0, 256, (2, 512, 128),
                                                np.uint8)
        args = _on(dev, lit, src, dst, length)
        _same(_launched(execute.execute_rounds, *args, caps),
              execute.execute_rounds_ref(*args, caps),
              f"execute_rounds sum ({kind})")
    return f"{len(sets)} compact sets, {len(corpus.EXEC_SUM_CLASSES)} sums"


def check_exec_hist(dev) -> str:
    """Row 12: the history execute on the hostile history plans (1, 5, 8
    and 128 blocks) at every cluster size the card takes."""
    from compress_tpu_torch import _cuda, corpus
    from compress_tpu_torch.ops import execute

    lib = _cuda.library()
    n = 0
    for hb in (1, 5, 8, 128):
        plans_kb = corpus.hist_plans(hb)
        pieces, gstart = execute.pack_pieces_mb(plans_kb, hb << 16)
        lit = np.random.default_rng(hb).integers(
            0, 256, (len(plans_kb), gstart.shape[1], 512, 128), np.uint8)
        args = _on(dev, lit, pieces, gstart)
        want = execute.execute_blocks_hist_ref(*args, hb * 512)
        for cluster in (1, 2, 4, 8, 16):
            if lib.ct_exec_hist_clusters(cluster) < 1:
                continue
            _same(_launched(execute.execute_blocks_hist, *args, hb * 512,
                            cluster=cluster), want,
                  f"execute_blocks_hist (history {hb}, cluster {cluster})")
            n += 1
    return f"{n} launches"


# ---- rows 13-18 and a: the XLA scans' kernels ------------------------------

def check_fse_encode(dev) -> str:
    """Row 13: the FSE encode chain on every encode class and on tables
    of any int32 value; prints the rows on each route."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import entropy

    rng = np.random.default_rng(13)
    sets = {k: corpus.fse_enc_inputs(k) for k in corpus.FSE_ENC_CLASSES}
    big = np.iinfo(np.int32)
    sets["int32"] = (rng.integers(0, 256, (5, 2050), dtype=np.uint8),
                     *(rng.integers(big.min, big.max, (5, w), dtype=np.int32)
                       for w in (512, 256, 256)))
    out = []
    for kind, ins in sets.items():
        ts = _on(dev, *ins)
        routes = torch.zeros(2, dtype=torch.int32, device=dev)
        _same(_launched(entropy.fse_encode_chain, *ts, routes=routes),
              entropy.fse_encode_chain_ref(*ts), f"fse_encode {kind}")
        out.append(f"{kind} {routes.tolist()}")
    return "routes [one-load, exact]: " + ", ".join(out)


def check_fse_decode(dev) -> str:
    """Row 14: the FSE chunk decode on every decode class and the wild
    tables, at k = 2, 6, 32 and 64; prints the chunks on each route."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import entropy_dec

    out = []
    for kind in corpus.FSE_DEC_CLASSES + (corpus.FSE_DEC_WILD,):
        d = corpus.fse_dec_inputs(kind)
        for k in (2, 6, 32, 64):
            dk = dict(d)
            if k != 32:
                dk["npair"] = np.minimum(d["npair"], k // 2)
                dk["nore1"] = np.minimum(d["nore1"], k // 2)
                dk["nore2"] = np.minimum(d["nore2"], k // 2)
            args = _on(dev, *(dk[x] for x in ("windows", "lbit", "st1", "st2",
                                              "npair", "nore1", "nore2",
                                              "tables")))
            routes = torch.zeros(2, dtype=torch.int32, device=dev)
            _same(_launched(entropy_dec.fse_decode_chunks, *args, k=k,
                            routes=routes),
                  entropy_dec.fse_decode_chunks_ref(*args, k=k),
                  f"fse_decode {kind} k={k}")
        out.append(f"{kind} {routes.tolist()}")
    return "chunks at k=64 [dead, walked]: " + ", ".join(out)


def check_checksums(dev) -> str:
    """Rows 15-16: CRC-32C and xxHash64 on rows of many lengths, prefixes,
    seeds and a misaligned start."""
    from compress_tpu_torch.ops import checksum

    rng = np.random.default_rng(15)
    n = 0
    for N in (1, 31, 255, 256, 257, 4096, 65536, 100000):
        t = torch.from_numpy(rng.integers(0, 256, (7, N), dtype=np.uint8)
                             ).to(dev)
        for length in (None, max(N - 5, 0)):
            _same(_launched(checksum.crc32c_batch, t, length),
                  checksum.crc32c_batch_ref(t, length), f"crc32c N={N}")
            n += 1
    wide = torch.from_numpy(rng.integers(0, 256, (3, 70000), dtype=np.uint8)
                            ).to(dev)
    _same(_launched(checksum.crc32c_batch, wide[:, 5:], 70000 - 5),
          checksum.crc32c_batch_ref(wide[:, 5:], 70000 - 5),
          "crc32c misaligned")
    for N in (32, 64, 544, 1056, 1184, 65536):
        t = torch.from_numpy(rng.integers(0, 256, (7, N), dtype=np.uint8)
                             ).to(dev)
        for seed in (0, 12345, (1 << 64) - 1, 1 << 63):
            _same(_launched(checksum.xxh64_batch, t, seed),
                  checksum.xxh64_batch_ref(t, seed), f"xxh64 N={N}")
            n += 1
    return f"{n + 1} launches"


def _tile_lengths(kind: str, tile: int, nb: int, rng) -> np.ndarray:
    """Hostile L_t rows of whole tiles: every position 4, matches that end
    at a tile's end, whole-tile matches, raw random values, values near
    INT32_MAX, negatives among ordinary lengths."""
    n = max(tile, 256) * 4
    n -= n % tile
    pos = np.arange(n)[None, :].repeat(nb, 0)
    if kind == "all4":
        L = np.full((nb, n), 4)
    elif kind == "tile_end":
        L = tile - pos % tile
    elif kind == "whole_tile":
        L = np.where(pos % tile == 0, tile, 0)
    elif kind == "raw":
        L = rng.integers(0, I32_MAX, (nb, n))
    elif kind == "near_max":
        L = I32_MAX - rng.integers(0, 8, (nb, n))
    else:
        L = rng.integers(-8, 40, (nb, n))
    return np.ascontiguousarray(L.astype(np.int32))


def check_tile_parse(dev) -> str:
    """Row 17: the tile parse on the S2 engine's own lengths and hostile
    ones at tiles 1 to 2048 (the warp route) and past it (the chunked
    route), in batches of 1 and 65 rows; prints the tiles on each
    route."""
    from compress_tpu_torch.ops import lz2

    rng = np.random.default_rng(17)
    totals = np.zeros(2, np.int64)
    t = _blocks(dev, 8)
    _, _, L_t, _ = lz2._find_parse(t, 512, level=1)
    sets = [(L_t.to(torch.int32).contiguous(), 512)]
    for tile in (1, 8, 33, 256, 512, 700, 2048, 4096):
        for kind, nb in (("all4", 1), ("tile_end", 65), ("whole_tile", 1),
                         ("raw", 65), ("near_max", 1), ("mixed", 65)):
            sets.append((torch.from_numpy(_tile_lengths(kind, tile, nb,
                                                        rng)).to(dev), tile))
    for k, (L, tile) in enumerate(sets):
        routes = torch.zeros(2, dtype=torch.int32, device=dev)
        _same(_launched(lz2.tile_parse, L, tile, routes=routes),
              lz2.tile_parse_ref(L, tile), f"tile_parse ({k}, tile {tile})")
        totals += np.array(routes.tolist())
    return f"{len(sets)} sets; tiles [warp, chunked] {totals.tolist()}"


def _scan_inputs(seed: int, nj: int, nblk: int, ms: int = 2731):
    """FSE scan inputs at v1's shapes: skewed random codes and per-job
    tables of logs 9/8/9 from ``zdev._fse_build``."""
    from compress_tpu_torch.ops import zdev

    rng = np.random.default_rng(seed)
    R = nj * nblk
    n = torch.from_numpy(rng.integers(0, ms + 1, R).astype(np.int32))
    is_seq = torch.arange(ms)[None, :] < n[:, None]
    codes = []
    for hi in (36, 21, 53):
        c = np.minimum(rng.geometric(rng.uniform(0.05, 0.5), (R, ms)) - 1,
                       hi - 1)
        codes.append(torch.where(is_seq, torch.from_numpy(c), 0)
                     .to(torch.int32))
    tabs = [zdev._fse_build(c, is_seq, nj, lg)
            for c, lg in zip(codes, zdev.FSE_LOGS)]
    st, dnb, dfs, logs, rle = (torch.stack([t[k] for t in tabs], dim=1)
                               .contiguous()
                               for k in ("st", "dnb", "dfs", "log", "rle"))
    return [torch.stack(codes, dim=1).contiguous(), n, st, dnb, dfs, logs,
            rle]


def check_fse_scan(dev) -> str:
    """Row 18: the v1 FSE scan on real per-job tables at several
    geometries, with an RLE stream, and with job 0's ll table broken four
    ways (a width switch off a power of two, states outside [size,
    2 size), s + dnb past INT32_MAX, every symbol at k = 0); prints the
    rows on each route."""
    from compress_tpu_torch.ops import zdev

    sets = [("8x64", _scan_inputs(1, 8, 64)), ("3x65", _scan_inputs(2, 3, 65)),
            ("1x1", _scan_inputs(3, 1, 1))]
    rle = _scan_inputs(4, 2, 3)
    rle[6][1, 2] = True
    rle[5][1, 2] = 0
    sets.append(("rle", rle))
    for name in ("switch", "state", "wrap_nb", "k0"):
        args = _scan_inputs(7, 2, 3)
        syms, n, st, dnb = args[:4]
        hot = int(torch.mode(syms[:3, 0, :max(int(n[:3].min()), 1)]
                             .flatten())[0])
        if name == "switch":
            dnb[0, 0, hot] += 1
        elif name == "state":
            st[0, 0, :] = torch.where(st[0, 0] > 0, 3, 0)
        elif name == "wrap_nb":
            dnb[0, 0, hot] = I32_MAX - 700
        else:
            dnb[0, 0, :] = -(1 << 16) + 1
        sets.append((name, args))
    out = []
    for name, args in sets:
        routes = torch.zeros(2, dtype=torch.int32, device=dev)
        ins = [a.to(dev) for a in args]
        _same(_launched(zdev.fse_scan, *ins, routes=routes),
              zdev.fse_scan_ref(*args), f"fse_scan {name}")
        out.append(f"{name} {routes.tolist()}")
    return "rows [one-load, exact]: " + ", ".join(out)


def check_histograms(dev) -> str:
    """Row a: the per-row histograms (masks none, all false, all true, a
    prefix, random; a misaligned view) and the whole-input histogram on
    every dtype it reads; the launch's threads a row, CTAs an SM,
    registers and shared bytes."""
    from compress_tpu_torch import _cuda
    from compress_tpu_torch.utils import histogram

    rng = np.random.default_rng(19)
    n = 0
    for N, L in ((1, 2), (7, 16383), (1024, 16384), (3, 65536)):
        rows = rng.integers(0, 256, (N, L), dtype=np.uint8)
        rows[0] = 0
        t = torch.from_numpy(rows).to(dev)
        masks = [None, torch.zeros_like(t, dtype=torch.bool),
                 torch.ones_like(t, dtype=torch.bool),
                 torch.arange(L, device=dev)[None, :].expand(N, L)
                 < L // 3,
                 torch.from_numpy(rng.random((N, L)) < 0.5).to(dev)]
        for m in masks:
            _same(_launched(histogram.byte_histograms, t, m),
                  histogram.byte_histograms_ref(t, m), f"byte_histograms "
                  f"{N}x{L}")
            n += 1
    wide = torch.from_numpy(rng.integers(0, 256, (4, 20000),
                                         dtype=np.uint8)).to(dev)
    _same(_launched(histogram.byte_histograms, wide[:, 3:]),
          histogram.byte_histograms_ref(wide[:, 3:]), "byte_histograms view")
    for dtype in (torch.uint8, torch.int8, torch.int16, torch.int32,
                  torch.int64):
        x = torch.from_numpy(rng.integers(0, 256, 1 << 20)).to(dtype).to(dev)
        _same(_launched(histogram.histogram256_torch, x),
              histogram.histogram256_torch_ref(x), f"histogram256 {dtype}")
        n += 1
    if dev.type != "cuda":
        return f"{n + 1} launches"
    out = (ctypes.c_int * 6)()
    _cuda.check(_cuda.library().ct_histogram_info(1024, 16384, out),
                "ct_histogram_info")
    if out[1] < 1:
        raise Mismatch(f"the histogram kernel cannot be resident: {list(out)}")
    return (f"{n + 1} launches; for 1024 rows of 16 KiB {out[0]} threads "
            f"a row, {out[1]} CTAs an SM, {out[2]} / {out[3]} registers "
            f"(unmasked / masked), {out[4]} shared bytes a CTA")


def check_huff_build(dev) -> str:
    """Row b: the Huffman code-length build on every
    ``corpus.huff_build_hists`` class at maxlog 8 and 11 (and 1 and 15
    on all of them), int32 and int64 counts, and on the int64 rows whose
    keys pass 2^54 (``corpus.huff_build_wide_hists``); each row's walk
    steps."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import zdev

    rows = np.concatenate([corpus.huff_build_hists(k)
                           for k in corpus.HUFF_BUILD_CLASSES])
    h = torch.from_numpy(rows)
    wide = torch.from_numpy(corpus.huff_build_wide_hists())
    n = 0
    for maxlog in (1, 8, 11, 15):
        for t in (h, h.to(torch.int64), wide):
            _same(_launched(zdev._huff_build, t.to(dev), maxlog),
                  zdev._huff_build_ref(t, maxlog),
                  f"huff_build maxlog {maxlog} {t.dtype} "
                  f"{'wide' if t is wide else ''}")
            n += 1
    if dev.type != "cuda":
        return f"{n} launches of {len(rows)} rows"
    from compress_tpu_torch import _cuda

    stats = torch.zeros((len(rows), 2), dtype=torch.int64, device=dev)
    zdev._huff_build(h.to(dev), 11, stats=stats)
    steps = stats[:, 0].cpu()
    info = (ctypes.c_int * 6)()
    _cuda.check(_cuda.library().ct_tablebuild_info(info),
                "ct_tablebuild_info")
    if info[2] < 1 or info[5] < 1:
        raise Mismatch(f"a table build cannot be resident: {list(info)}")
    return (f"{n} launches of {len(rows)} rows; at maxlog 11 walks of "
            f"{int(steps.sum())} steps, the longest {int(steps.max())}; "
            f"registers / CTAs an SM: Huffman {info[0]} / {info[2]}, "
            f"normalisation (NSYM 256) {info[3]} / {info[5]}")


def check_normalize_count(dev) -> str:
    """Row c: the FSE count normalisation on every
    ``corpus.normalize_hists`` class at NSYM 64 and 256 and logs 5-12,
    int32 and int64 counts, and on the int64 rows whose totals and
    remainders pass 2^54 (``corpus.normalize_wide_hists``) at NSYM 1,
    63, 255, 1000 and 1024 and logs 5 and 20."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import zdev

    n = 0
    for nsym in (64, 256):
        for log in range(5, 13):
            h = torch.from_numpy(np.concatenate(
                [corpus.normalize_hists(k, nsym, log)
                 for k in corpus.NORMALIZE_CLASSES]))
            for t in (h, h.to(torch.int64)):
                _same(_launched(zdev._normalize_count, t.to(dev), log),
                      zdev._normalize_count_ref(t, log),
                      f"normalize_count NSYM {nsym} log {log} {t.dtype}")
                n += 1
    for nsym in (1, 63, 255, 1000, 1024):
        for log in (5, 20):
            t = torch.from_numpy(corpus.normalize_wide_hists(nsym, log))
            _same(_launched(zdev._normalize_count, t.to(dev), log),
                  zdev._normalize_count_ref(t, log),
                  f"normalize_count wide NSYM {nsym} log {log}")
            n += 1
    return f"{n} launches"


def check_occupancy(dev) -> str:
    """The occupancy queries: every kernel can be resident."""
    from compress_tpu_torch import _cuda

    lib = _cuda.library()
    got = {"exec": lib.ct_exec_occupancy(512),
           "parse": lib.ct_parse_occupancy(), "emit": lib.ct_emit_occupancy(),
           "rep": lib.ct_rep_occupancy(), "fse": lib.ct_fse_occupancy(),
           "huff0": lib.ct_huff0_occupancy(0),
           "zseq": lib.ct_zseq_occupancy(96),
           "exec_hist": lib.ct_exec_hist_occupancy(8),
           "fse_encode": lib.ct_fse_encode_occupancy(9)}
    if min(got.values()) < 1:
        raise Mismatch(f"a kernel cannot be resident: {got}")
    return "CTAs an SM: " + ", ".join(f"{k} {v}" for k, v in got.items())


# name, rows of PERF.md's table, the C entries it drives, the check
KERNELS = [
    ("finder", "1-2", ("ct_find_matches",), check_finder),
    ("emit", "3-4", ("ct_emit_blocks",), check_emit),
    ("zparse", "5", ("ct_parse_blocks",), check_zparse),
    ("rep_scan", "6", ("ct_rep_scan",), check_rep_scan),
    ("fse_chain", "7", ("ct_fse_chain",), check_fse_chain),
    ("litlut", "8", ("ct_litlut",), check_litlut),
    ("huff0_decode", "9", ("ct_huff0_decode",), check_huff0),
    ("zseq_decode", "10", ("ct_zseq_decode",), check_zseq),
    ("execute", "11", ("ct_exec_pieces", "ct_exec_sum"), check_exec),
    ("execute_blocks_hist", "12", ("ct_exec_hist", "ct_exec_hist_clusters"),
     check_exec_hist),
    ("fse_encode_chain", "13", ("ct_fse_encode",), check_fse_encode),
    ("fse_decode_chunks", "14", ("ct_fse_decode",), check_fse_decode),
    ("checksums", "15-16", ("ct_crc32c_batch", "ct_xxh64_batch"),
     check_checksums),
    ("tile_parse", "17", ("ct_tile_parse", "ct_tile_parse_info"),
     check_tile_parse),
    ("fse_scan", "18", ("ct_zdev_fse", "ct_zdev_fse_info"), check_fse_scan),
    ("byte_histograms", "a", ("ct_byte_histograms", "ct_histogram256",
                              "ct_histogram_info"), check_histograms),
    ("huff_build", "b", ("ct_huff_build", "ct_tablebuild_info"),
     check_huff_build),
    ("normalize_count", "c", ("ct_normalize_count",), check_normalize_count),
    ("occupancy", "-", ("ct_exec_occupancy", "ct_parse_occupancy",
                        "ct_emit_occupancy", "ct_rep_occupancy",
                        "ct_fse_occupancy", "ct_huff0_occupancy",
                        "ct_zseq_occupancy", "ct_exec_hist_occupancy",
                        "ct_fse_encode_occupancy"), check_occupancy),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("gpu_diff: no CUDA device; the sweep needs the card (it has "
              "no CPU fallback)", file=sys.stderr)
        return 2
    from compress_tpu_torch import _cuda

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"gpu_diff: {torch.cuda.get_device_name(0)}; kernels built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bad = 0
    for name, rows, _syms, fn in KERNELS:
        t0 = time.perf_counter()
        try:
            detail, ok = fn(dev), True
        except Exception as e:  # noqa: BLE001 — every failure is reported
            detail, ok = f"{type(e).__name__}: {e}", False
        bad += not ok
        print(f"{name:20s} row {rows:5s} {'OK' if ok else 'MISMATCH':8s} "
              f"{time.perf_counter() - t0:6.1f} s  {detail}", flush=True)
    print("gpu_diff:", "ALL OK" if bad == 0 else f"{bad} MISMATCHES")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
