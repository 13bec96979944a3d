"""Time the huff0 chunk kernel of several checkouts on one card, in turns.

    python3 compress_tpu_torch/tools/huff0_ab.py ROOT [ROOT ...] [--rounds N]

Each ROOT is a checkout of this repository; its ``compress_tpu_torch``
builds its own kernels under its own ``_build/``.  The inputs are made
once, by the checkout this script lies in, and saved to a temporary file:

- ``shared``: ``chip_smoke.py``'s phase 14, 1024 rows of 16 KiB of seeded
  text, one 8-bit table for the batch (the shared engine);
- ``table``: its phase 15, the seeded corpus as 1024 rows of 16 KiB, an
  11-bit table per container of 512 chunks (the table engine);
- ``rows48``: 360 rows of 1536 bytes of the same text, an 11-bit table
  per container of 48 chunks, the shape of the zstd literals' rows.

Each round runs every ROOT in a process of its own, in the order given in
odd rounds and in reverse in even ones (A B, B A, ...).  A process times
each input's kernel call on device time, the median of CUDA events around
calls queued behind a device spin (as ``chip_smoke.cuda_ms(..., spin=True)``),
with the inputs' symbol counts and with none, and prints one JSON line.
The script fails unless every process's outputs equal the first's, and
ends with each ROOT's range over the rounds.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parents[2]
SEED = 0
N_BLOCKS = 256   # 16 MiB, as chip_smoke.py
ROW = 16 << 10

CHILD = r"""
import hashlib, json, statistics, sys
import torch
from compress_tpu_torch.ops import entropy_dec as ED
from compress_tpu_torch.ops import entropy_kern as EK

REPS, SPIN_CYCLES = 50, 2_000_000


def device_ms(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


out = {}
for name, d in torch.load(sys.argv[1]).items():
    t = {key: v.cuda() for key, v in d["tensors"].items()}
    if d["shared"]:
        def call(ns, t=t, mb=d["max_bits"]):
            return EK.huff0_decode_chunks_shared(t["windows"], t["lbit"], ns,
                                                 t["table"], max_bits=mb)
    else:
        def call(ns, t=t):
            return ED.huff0_decode_chunks(t["windows"], t["lbit"], ns,
                                          t["tables"])
    syms, endl = call(t["nsym"])
    h = hashlib.sha256(syms.cpu().numpy().tobytes())
    h.update(endl.cpu().numpy().tobytes())
    none = torch.zeros_like(t["nsym"])
    out[name] = {"device_ms": device_ms(lambda: call(t["nsym"])),
                 "no_symbols_device_ms": device_ms(lambda: call(none)),
                 "digest": h.hexdigest()[:16]}
print(json.dumps(out))
"""


def make_inputs() -> dict:
    """The three inputs as CPU tensors, encoded on the card by this
    checkout's port."""
    sys.path.insert(0, str(HERE))
    from compress_tpu_torch import corpus, huff0
    from compress_tpu_torch.huff0 import batch as hb

    rng = np.random.default_rng(SEED)
    text = np.concatenate([corpus.make_block("text", rng)
                           for _ in range(N_BLOCKS)])
    cases = {"shared": (text.reshape(-1, ROW), True, 8),
             "table": (corpus.corpus_blocks(N_BLOCKS, SEED).reshape(-1, ROW),
                       False, 11),
             "rows48": (text[:360 * 1536].reshape(-1, 1536), False, 11)}
    inputs = {}
    for name, (rows, shared, max_log) in cases.items():
        conts, accel = huff0.compress_4x_batch(
            rows, return_accel=True, shared_table=shared, max_log=max_log)
        (windows, lbit, nsym, tables), metas, _ = hb._prep_decode_batch(
            conts, accel)
        if shared:
            packed, mb = hb.shared_packed_table(metas)
            N, C, W = windows.shape
            tensors = {"windows": windows.reshape(N * C, W),
                       "lbit": lbit.reshape(-1), "nsym": nsym.reshape(-1),
                       "table": torch.from_numpy(packed)}
        else:
            mb = max_log
            tensors = {"windows": windows, "lbit": lbit, "nsym": nsym,
                       "tables": tables}
        inputs[name] = {"tensors": tensors, "shared": shared, "max_bits": mb}
        print(f"{name}: windows {tuple(windows.shape)}, "
              f"{int(nsym.sum())} symbols, peek {mb} bits", flush=True)
    return inputs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(make_inputs(), path)
        runs = {str(r): [] for r in a.roots}
        first = None
        for rnd in range(a.rounds):
            for root in (a.roots if rnd % 2 == 0 else a.roots[::-1]):
                env = dict(os.environ, PYTHONPATH=str(root.resolve()))
                p = subprocess.run([sys.executable, "-c", CHILD, path],
                                   cwd=root, env=env, capture_output=True,
                                   text=True, check=False)
                if p.returncode:
                    print(p.stdout, p.stderr, file=sys.stderr)
                    return 1
                got = json.loads(p.stdout.strip().splitlines()[-1])
                print(json.dumps({"round": rnd, "root": str(root), **got}),
                      flush=True)
                digests = {k: v["digest"] for k, v in got.items()}
                if first is None:
                    first = digests
                elif digests != first:
                    print(f"{root}: outputs differ ({digests} against "
                          f"{first})", file=sys.stderr)
                    return 1
                runs[str(root)].append(got)
    for root, got in runs.items():
        for name in got[0]:
            for key in ("device_ms", "no_symbols_device_ms"):
                v = [g[name][key] for g in got]
                print(f"{root} {name} {key}: {min(v):.4f}-{max(v):.4f} "
                      f"({', '.join(f'{x:.4f}' for x in v)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
