"""s2d — decompress .s2/.snappy streams (reference: s2/cmd/s2d).

Flag parity with klauspost/compress's s2/cmd/s2d/main.go: -c (stdout), -o,
-safe, -rm, -q, -verify (decode without writing), -bench, -cpu
(concurrent stream decode), -offset/-tail (random access via the seek
index), -block (raw S2 block), plus -untar (unpack a decompressed tar
archive, the reference cmd's tar mode). http(s):// inputs are
downloaded; glob arguments expand.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time

from compress_tpu_torch.cli.s2c import expand_args, parse_size, read_input


def main(argv=None):
    ap = argparse.ArgumentParser(prog="s2d", description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("-c", action="store_true", help="write to stdout")
    ap.add_argument("-o", default="", help="output filename")
    ap.add_argument("-safe", action="store_true",
                    help="do not overwrite output files")
    ap.add_argument("-rm", action="store_true",
                    help="delete source files on success")
    ap.add_argument("-q", action="store_true",
                    help="no terminal output except errors")
    ap.add_argument("-verify", action="store_true",
                    help="decode and discard (verify only)")
    ap.add_argument("-bench", type=int, default=0)
    ap.add_argument("-cpu", type=int, default=os.cpu_count() or 1,
                    help="decode streams using this many threads")
    ap.add_argument("-offset", default="",
                    help="start at uncompressed offset (needs index)")
    ap.add_argument("-tail", default="",
                    help="return last N bytes (needs index)")
    ap.add_argument("-block", action="store_true",
                    help="input is a raw S2 block")
    ap.add_argument("-untar", action="store_true",
                    help="unpack the decompressed output as a tar archive")
    args = ap.parse_args(argv)

    from compress_tpu_torch import s2
    from compress_tpu_torch.s2 import stream as s2stream
    from compress_tpu_torch.s2.seek import ReadSeeker

    for path in expand_args(args.files):
        blob = read_input(path)

        def decode():
            if args.block:
                return s2.decode(blob)
            if args.offset or args.tail:
                rs = ReadSeeker(io.BytesIO(blob))
                if args.tail:
                    rs.seek(-parse_size(args.tail), io.SEEK_END)
                else:
                    rs.seek(parse_size(args.offset))
                return rs.read()
            if args.cpu > 1:
                return s2stream.decode_concurrent(blob, workers=args.cpu)
            return s2stream.Reader(io.BytesIO(blob)).read()

        if args.bench:
            best = None
            for _ in range(args.bench):
                t = time.time()
                out = decode()
                dt = time.time() - t
                best = dt if best is None else min(best, dt)
            print(f"{path}: {len(out) / best / 1e6:.1f} MB/s",
                  file=sys.stderr)
            continue
        out = decode()
        if args.verify:
            if not args.q:
                print(f"{path}: ok ({len(out)} bytes)", file=sys.stderr)
            continue
        if args.untar:
            import tarfile

            dstdir = args.o or "."
            with tarfile.open(fileobj=io.BytesIO(out)) as tf:
                tf.extractall(dstdir, filter="data")
            if not args.q:
                print(f"{path}: untarred to {dstdir}", file=sys.stderr)
            continue
        if args.c:
            sys.stdout.buffer.write(out)
            continue
        dst = args.o
        if not dst:
            base = path
            if base.startswith(("http://", "https://")):
                base = base.split("://", 1)[1].replace("/", "_")
            for suf in (".s2", ".snappy", ".sz"):
                if base.endswith(suf):
                    dst = base[: -len(suf)]
                    break
            else:
                dst = base + ".decoded"
        if args.safe and os.path.exists(dst):
            print(f"{dst}: exists", file=sys.stderr)
            return 1
        with open(dst, "wb") as f:
            f.write(out)
        if not args.q:
            print(f"{path} -> {dst} ({len(blob)} -> {len(out)} bytes)",
                  file=sys.stderr)
        if args.rm and path != "-" and not path.startswith(("http://",
                                                            "https://")):
            os.unlink(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
