"""zstdio — zstd compress/decompress CLI over our codec.

Covers the reference's zstd-level CLI exposure (the Go repo ships only
library APIs for zstd; this is the s2c/s2d-style driver for the zstd side).
Flags: -d (decompress), -level 1..4, -D dictionary, -crc, -accel, -c, -o.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zstdio", description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("-d", action="store_true", help="decompress")
    ap.add_argument("-level", type=int, default=2, help="1=fastest 2=default 3=better 4=best")
    ap.add_argument("-D", default="", help="dictionary file")
    ap.add_argument("-crc", action="store_true", help="add content checksum")
    ap.add_argument("-accel", action="store_true",
                    help="emit the device-decode accel sidecar (a "
                         "skippable frame, any zstd decoder ignores it)")
    ap.add_argument("-c", action="store_true", help="stdout")
    ap.add_argument("-o", default="")
    args = ap.parse_args(argv)

    from compress_tpu_torch import zstd as Z

    dict_ = None
    dicts = []
    if args.D:
        from compress_tpu_torch.zstd.dict import load_dict, raw_dict

        blob = open(args.D, "rb").read()
        try:
            dict_ = load_dict(blob)
        except ValueError:
            dict_ = raw_dict(blob)
        dicts = [dict_]

    for path in args.files:
        data = sys.stdin.buffer.read() if path == "-" else open(path, "rb").read()
        if args.d:
            out = Z.decompress(data, dicts=dicts)
            dst = args.o or (path[:-4] if path.endswith(".zst") else path + ".out")
        else:
            if args.accel and dict_ is None and not args.crc:
                out = Z.compress_accel(data, level=min(args.level, 3))
            else:
                if args.accel:
                    print("zstdio: -accel ignored (incompatible with "
                          "-crc/-D)", file=sys.stderr)
                out = Z.compress(data, level=args.level, checksum=args.crc, dict_=dict_)
            dst = args.o or path + ".zst"
        if args.c:
            sys.stdout.buffer.write(out)
            continue
        with open(dst, "wb") as f:
            f.write(out)
        print(f"{path} -> {dst} ({len(data)} -> {len(out)})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
