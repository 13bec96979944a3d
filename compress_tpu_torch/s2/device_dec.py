"""Batched device decode of S2/Snappy blocks (counterpart of the JAX
package's ``s2/device_dec.py`` ``decode_blocks_device``).

The host parses each block's tag stream (the inherently serial byte
work) into its literal bytes and a round-annotated execute plan
(``s2/plan.py``), packed into a compact plan (live pieces only,
``execute.pack_pieces``); the byte movement then runs as one arena
execute per arena class over every block of that class at once
(``ops/execute.py``, the CUDA kernel ``csrc/exec.cu`` on the card).  Blocks the planner cannot
take (longer than 256 KiB, corrupt) go to the host decoder
(``s2/block.decode``), the reference's own contract.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.ops import execute as X
from compress_tpu_torch.s2 import block as B
from compress_tpu_torch.s2.plan import MAX_LEN, arena_class, build_plan
from compress_tpu_torch.utils.varint import read_uvarint

__all__ = ["plan_blocks", "decode_blocks_device"]


def plan_blocks(blocks, *, allow_repeat: bool = True, max_rounds: int = 4):
    """Host half of the decode.  Returns (results, classes): results[i] is
    the host-decoded bytes of block i, or None where block i is planned;
    classes holds one dict per arena class M (ascending) with ``M``,
    ``index`` (the blocks' positions), ``total`` (their lengths),
    ``lit_rows`` (Bc, 512 * M, 128) uint8, ``plans`` (the per-block plan
    dicts) and their compact plan ``pieces`` (P, 2) and ``rstart``
    (Bc, nr + 1) int32 (``execute.pack_pieces``), all numpy."""
    results = [None] * len(blocks)
    planned = []
    for i, blk in enumerate(blocks):
        blk = bytes(blk)
        dlen, pos = read_uvarint(blk)
        plan = None
        if 0 < dlen <= MAX_LEN:
            plan = build_plan(blk[pos:], dlen, allow_repeat, max_rounds)
        if plan is None:
            results[i] = B.decode(blk, allow_repeat=allow_repeat)
        else:
            planned.append((i, plan))
    classes = []
    for M in sorted({arena_class(p[0]) for _, p in planned}):
        sel = [(i, p) for i, p in planned if arena_class(p[0]) == M]
        lit_rows = np.zeros((len(sel), M * 512 * 128), np.uint8)
        plans = []
        for k, (_, (total, lit, src, length, rnd, n_rounds)) in enumerate(sel):
            lit_rows[k, :len(lit)] = np.frombuffer(lit, np.uint8)
            starts = np.concatenate([[0], np.cumsum(length[:-1],
                                                    dtype=np.int64)])
            plans.append({"src": src,
                          "dst": (M * X.OUT_BASE + starts).astype(np.int32),
                          "len": length, "round": rnd, "n_rounds": n_rounds})
        pieces, rstart = X.pack_pieces(plans, M * 512)
        classes.append({"M": M, "index": [i for i, _ in sel],
                        "total": [p[0] for _, p in sel],
                        "lit_rows": lit_rows.reshape(len(sel), M * 512, 128),
                        "plans": plans, "pieces": pieces, "rstart": rstart})
    return results, classes


def decode_blocks_device(blocks, *, allow_repeat: bool = True,
                         max_rounds: int = 4, device=None,
                         stats: dict | None = None, mesh=None):
    """Decode a batch of S2 (or snappy, ``allow_repeat=False``) blocks.
    Returns a list of bytes, equal to ``s2.block.decode`` of each block.

    Runs on CUDA unless ``device`` names another device ("cpu" runs the
    plain PyTorch execute); raises when no card is present and no device
    was given.  ``stats``, when given, receives the count of blocks
    decoded on the device and on the host, and per arena class its block
    count, rounds, piece count and the bytes of its compact plan.

    mesh: an optional ``parallel.BlockMesh``: the blocks are independent,
    so each rank decodes its share (``parallel.shard_items``) on the
    mesh's device and every rank returns the whole list, gathered in
    block order; ``stats`` then holds this rank's share."""
    if mesh is not None:
        from compress_tpu_torch.parallel.engine import map_sharded

        return map_sharded(mesh, blocks, device, lambda part, dev: (
            decode_blocks_device(part, allow_repeat=allow_repeat,
                                 max_rounds=max_rounds, device=dev,
                                 stats=stats)))
    dev = resolve_device(device)
    results, classes = plan_blocks(blocks, allow_repeat=allow_repeat,
                                   max_rounds=max_rounds)
    for c in classes:
        out = X.execute_pieces(*(torch.from_numpy(c[k]).to(dev) for k in (
            "lit_rows", "pieces", "rstart")))
        out = out.reshape(out.shape[0], -1).cpu().numpy()
        for k, (i, total) in enumerate(zip(c["index"], c["total"])):
            results[i] = out[k, :total].tobytes()
    if stats is not None:
        n_dev = sum(len(c["index"]) for c in classes)
        stats.update(device=n_dev, host=len(blocks) - n_dev, classes={
            c["M"]: {"blocks": len(c["index"]),
                     "rounds": c["rstart"].shape[1] - 1,
                     "pieces": len(c["pieces"]),
                     "plan_bytes": c["pieces"].nbytes + c["rstart"].nbytes}
            for c in classes})
    return results
