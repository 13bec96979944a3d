"""s2c — compress files to .s2/.snappy streams (reference: s2/cmd/s2c).

Flag parity with klauspost/compress's s2/cmd/s2c/main.go: -faster/-slower
(level ladder; default = better, like the reference), -cpu (worker
fan-out), -blocksize, -block (single-block), -snappy, -recomp, -pad,
-index (default on), -safe, -rm, -q, -o, -c (stdout), -verify, -bench,
plus our -device (the parallel engine's S2 encoder on the card). File
names beginning with http:// or https:// are downloaded (response 200
only); shell-style globs in arguments are expanded (the reference's
filepathx role).

``main(argv, mesh=None)``: ``mesh`` is the ``parallel.BlockMesh`` that
-device encodes on (the default group's, on the card, when None); a
caller asks for the CPU with ``parallel.block_mesh(device="cpu")``.
-device honours -index: the device stream gets the seek index that
``s2.index.index_stream`` builds from it, so ``s2d -offset`` and ``-tail``
can seek it (the JAX package's -device route writes no index).
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import sys
import time


def parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suf, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if s.endswith(suf):
            mult = m
            s = s[:-1]
            break
    return int(s) * mult


def read_input(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    if path.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(path) as r:  # noqa: S310
            if getattr(r, "status", 200) != 200:
                raise OSError(f"{path}: http status {r.status}")
            return r.read()
    return open(path, "rb").read()


def expand_args(files):
    out = []
    for f in files:
        if f == "-" or f.startswith(("http://", "https://")):
            out.append(f)
            continue
        hits = sorted(glob.glob(f, recursive=True))
        out.extend(hits if hits else [f])
    return out


def out_name(path: str, snappy: bool) -> str:
    base = path
    if base.startswith(("http://", "https://")):
        base = base.split("://", 1)[1].replace("/", "_").rstrip("_") or "http"
    return base + (".sz" if snappy else ".s2")


def main(argv=None, mesh=None):
    ap = argparse.ArgumentParser(prog="s2c", description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("-faster", action="store_true",
                    help="compress faster, with a minor compression loss")
    ap.add_argument("-slower", action="store_true",
                    help="compress more, but a lot slower")
    ap.add_argument("-cpu", type=int, default=os.cpu_count() or 1,
                    help="compress using this many threads")
    ap.add_argument("-blocksize", default="4M",
                    help="max block size (examples: 64K, 256K, 1M, 4M)")
    ap.add_argument("-block", action="store_true",
                    help="compress as a single block (content in memory)")
    ap.add_argument("-snappy", action="store_true",
                    help="generate snappy-compatible output")
    ap.add_argument("-recomp", action="store_true",
                    help="recompress snappy or s2 input")
    ap.add_argument("-pad", default="1",
                    help="pad size to a multiple of this value")
    ap.add_argument("-index", action="store_true", default=True,
                    help="add a seek index (default)")
    ap.add_argument("-no-index", dest="index", action="store_false")
    ap.add_argument("-safe", action="store_true",
                    help="do not overwrite output files")
    ap.add_argument("-rm", action="store_true",
                    help="delete source files on success")
    ap.add_argument("-q", action="store_true",
                    help="no terminal output except errors")
    ap.add_argument("-o", default="",
                    help="write output to this file (single input)")
    ap.add_argument("-c", action="store_true", help="write to stdout")
    ap.add_argument("-verify", action="store_true",
                    help="decompress and verify output")
    ap.add_argument("-bench", type=int, default=0,
                    help="benchmark n iterations instead of writing")
    ap.add_argument("-device", action="store_true",
                    help="use the device encoder on the card")
    args = ap.parse_args(argv)
    if args.faster and args.slower:
        ap.error("-faster and -slower are mutually exclusive")

    from compress_tpu_torch.s2 import stream as s2stream

    block_size = parse_size(args.blocksize)
    pad = parse_size(args.pad) if args.pad != "1" else 0
    files = expand_args(args.files)
    if args.o and len(files) != 1:
        ap.error("-o requires a single input")

    for path in files:
        data = read_input(path)
        if args.recomp:
            data = _decompress_any(data)
        if args.bench:
            best = None
            for _ in range(args.bench):
                t = time.time()
                _compress(data, args, block_size, pad, mesh)
                dt = time.time() - t
                best = dt if best is None else min(best, dt)
            print(f"{path}: {len(data) / best / 1e6:.1f} MB/s",
                  file=sys.stderr)
            continue
        out = _compress(data, args, block_size, pad, mesh)
        if args.verify:
            got = _decompress_any(out)
            if got != data:
                print(f"{path}: VERIFY FAILED", file=sys.stderr)
                return 1
        if args.c:
            sys.stdout.buffer.write(out)
            continue
        dst = args.o or out_name(path, args.snappy)
        if args.safe and os.path.exists(dst):
            print(f"{dst}: exists (use without -safe to overwrite)",
                  file=sys.stderr)
            return 1
        with open(dst, "wb") as f:
            f.write(out)
        if not args.q:
            ratio = len(out) / max(len(data), 1) * 100
            print(f"{path} -> {dst} ({len(data)} -> {len(out)} bytes, "
                  f"{ratio:.2f}%)", file=sys.stderr)
        if args.rm and path != "-" and not path.startswith(("http://",
                                                            "https://")):
            os.unlink(path)
    return 0


def _level(args) -> int:
    if args.faster:
        return 1
    if args.slower:
        return 3
    return 2  # reference default: WriterBetterCompression


def _decompress_any(blob: bytes) -> bytes:
    from compress_tpu_torch import s2 as s2blk
    from compress_tpu_torch.s2 import stream as s2stream

    try:
        return s2stream.Reader(io.BytesIO(blob)).read()
    except Exception:
        return s2blk.decode(blob)


def _compress(data, args, block_size, pad, mesh=None):
    from compress_tpu_torch import s2 as s2blk
    from compress_tpu_torch.s2 import stream as s2stream

    if args.device and not args.snappy:
        from compress_tpu_torch.parallel import s2_stream_encode_device
        from compress_tpu_torch.s2.index import index_stream

        stream = s2_stream_encode_device(data, mesh)
        if args.index:
            stream += index_stream(stream).append_to()
        return stream
    if args.block:
        enc = {1: s2blk.encode, 2: s2blk.encode_better,
               3: s2blk.encode_best}[_level(args)]
        if args.snappy:
            enc = {1: s2blk.encode_snappy, 2: s2blk.encode_snappy_better,
                   3: s2blk.encode_snappy_best}[_level(args)]
        return enc(data)
    buf = io.BytesIO()
    w = s2stream.Writer(buf, block_size=block_size, snappy=args.snappy,
                        padding=pad, add_index=args.index and not args.snappy,
                        level=_level(args), workers=max(1, args.cpu))
    w.write(data)
    w.close()
    return buf.getvalue()


if __name__ == "__main__":
    sys.exit(main())
