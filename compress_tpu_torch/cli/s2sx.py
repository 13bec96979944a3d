"""s2sx — build self-extracting archives (reference: s2/cmd/_s2sx).

The reference embeds the compressed stream in a platform executable with
a built-in decoder; the portable equivalent here is a single Python file
with an embedded dependency-free S2 stream decoder and the payload in
base85. `python archive.py.sx.py` (or any interpreter) recreates the file.

The stream is ``parallel.s2_stream_encode_device``'s, on the card unless
the caller passes another ``mesh`` (``parallel.block_mesh(device="cpu")``
for the CPU); without a card and without a mesh it raises.
"""

from __future__ import annotations

import argparse
import base64
import sys

_STUB = '''#!/usr/bin/env python3
"""Self-extracting S2 archive (compress_tpu s2sx). Run to extract."""
import base64, struct, sys

def _u(b, p):
    r = s = 0
    while True:
        x = b[p]; p += 1
        r |= (x & 0x7F) << s
        if x < 0x80: return r, p
        s += 7

def _block(b):
    n, p = _u(b, 0)
    out = bytearray()
    off = 0
    while p < len(b):
        tag = b[p]
        t = tag & 3
        if t == 0:
            x = tag >> 2
            if x < 60:
                p += 1
            else:
                nb = x - 59
                x = int.from_bytes(b[p+1:p+1+nb], "little")
                p += 1 + nb
            l = x + 1
            out += b[p:p+l]; p += l
            continue
        if t == 1:
            toff = ((tag & 0xE0) << 3) | b[p+1]
            l = (tag >> 2) & 7
            p += 2
            if toff == 0:  # repeat-offset extension
                if l == 5: l = b[p] + 4; p += 1
                elif l == 6: l = int.from_bytes(b[p:p+2], "little") + 256; p += 2
                elif l == 7: l = int.from_bytes(b[p:p+3], "little") + 65536; p += 3
            else:
                off = toff
            l += 4
        elif t == 2:
            off = b[p+1] | (b[p+2] << 8)
            l = 1 + (tag >> 2); p += 3
        else:
            off = int.from_bytes(b[p+1:p+5], "little")
            l = 1 + (tag >> 2); p += 5
        for _ in range(l):
            out.append(out[-off])
    assert len(out) == n, (len(out), n)
    return bytes(out)

def extract(payload, name):
    data = base64.b85decode(payload)
    p = 0
    out = bytearray()
    while p < len(data):
        ct = data[p]
        ln = data[p+1] | (data[p+2] << 8) | (data[p+3] << 16)
        body = data[p+4 : p+4+ln]
        p += 4 + ln
        if ct == 0xFF:
            continue  # stream magic
        if ct == 0x00:
            out += _block(body[4:])
        elif ct == 0x01:
            out += body[4:]
        elif 0x80 <= ct <= 0xFD:
            continue  # skippable
    with open(name, "wb") as f:
        f.write(out)
    print(f"extracted {name} ({len(out)} bytes)")
'''


def build_sx(path: str, out_path: str | None = None, mesh=None) -> str:
    from compress_tpu_torch.parallel import s2_stream_encode_device

    data = open(path, "rb").read()
    stream = s2_stream_encode_device(data, mesh)
    out_path = out_path or path + ".sx.py"
    name = path.rsplit("/", 1)[-1]
    with open(out_path, "w") as f:
        f.write(_STUB)
        f.write(f"\n_NAME = {name!r}\n")
        f.write(f"_PAYLOAD = {base64.b85encode(stream)!r}\n")
        f.write("extract(_PAYLOAD, _NAME)\n")
    return out_path


def main(argv=None, mesh=None) -> int:
    ap = argparse.ArgumentParser(
        prog="s2sx", description=__doc__.split("\n")[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("-o", default=None, help="output path (single input)")
    args = ap.parse_args(argv)
    for f in args.files:
        print(build_sx(f, args.o if len(args.files) == 1 else None, mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
