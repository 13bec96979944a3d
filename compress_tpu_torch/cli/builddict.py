"""builddict — train a dictionary from sample files (reference: dict/cmd/builddict).

Flags: -format raw|zstd|s2, -maxsize, -o, -dictID.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="builddict", description=__doc__)
    ap.add_argument("samples", nargs="+", help="sample files")
    ap.add_argument("-format", default="zstd", choices=["raw", "zstd", "s2"])
    ap.add_argument("-maxsize", type=int, default=64 << 10)
    ap.add_argument("-dictID", type=int, default=1)
    ap.add_argument("-o", default="dict.bin")
    args = ap.parse_args(argv)

    from compress_tpu_torch import dictbuilder

    samples = [open(p, "rb").read() for p in args.samples]
    if args.format == "raw":
        out = dictbuilder.build_raw_dict(samples, args.maxsize)
    elif args.format == "zstd":
        out = dictbuilder.build_zstd_dict(samples, args.maxsize, args.dictID)
    else:
        out = dictbuilder.build_s2_dict(samples, args.maxsize)
    with open(args.o, "wb") as f:
        f.write(out)
    print(f"{args.o}: {len(out)} bytes from {len(samples)} samples", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
