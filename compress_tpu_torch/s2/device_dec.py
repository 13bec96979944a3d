"""Batched device decode of S2/Snappy blocks (counterpart of the JAX
package's ``s2/device_dec.py`` ``decode_blocks_device``).

The host parses each block's tag stream (the inherently serial byte
work) into its literal bytes and a round-annotated execute plan with one
call of the host core's ``ct_s2_build_plan`` a block (``native_plan``, as
the reference plans; ``s2/plan.build_plan`` is its plain version), packed
into a compact plan (live pieces only,
``execute.pack_pieces``); the byte movement then runs as one arena
execute per arena class over every block of that class at once
(``ops/execute.py``, the CUDA kernel ``csrc/exec.cu`` on the card).  Blocks the planner cannot
take (longer than 256 KiB, corrupt) go to the host decoder
(``s2/block.decode``), the reference's own contract.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _native
from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.ops import execute as X
from compress_tpu_torch.s2 import block as B
from compress_tpu_torch.s2.plan import MAX_LEN, arena_class
from compress_tpu_torch.utils.varint import read_uvarint

__all__ = ["native_plan", "plan_blocks", "decode_blocks_device"]


def _parse_payload(payload: bytes):
    """The native plan payload: u32 total, u32 nlit, the literals, u32
    n_pieces, u8 n_rounds, i32 src[n], u8 len[n], u8 round[n]."""
    total, nlit = np.frombuffer(payload, np.uint32, 2, 0)
    pos = 8
    lit = payload[pos:pos + int(nlit)]
    pos += int(nlit)
    n_pieces = int.from_bytes(payload[pos:pos + 4], "little")
    pos += 4
    n_rounds = payload[pos]
    pos += 1
    src = np.frombuffer(payload, np.int32, n_pieces, pos).copy()
    pos += 4 * n_pieces
    length = np.frombuffer(payload, np.uint8, n_pieces, pos).astype(np.int32)
    pos += n_pieces
    rnd = np.frombuffer(payload, np.uint8, n_pieces, pos).astype(np.int32)
    return int(total), lit, src, length, rnd, int(n_rounds)


def native_plan(body: bytes, dlen: int, allow_repeat: bool = True,
                max_rounds: int = 4):
    """``s2.plan.build_plan`` on the host core: (total, lit bytes, src,
    len, round, n_rounds), or None where ``ct_s2_build_plan`` refuses the
    block (or ``dlen`` is outside 1..256 KiB)."""
    if not 0 < dlen <= MAX_LEN:
        return None
    body = bytes(body)
    cap = 8 + dlen + 6 * (4 * dlen + 2048) + 64
    oarr, out = _native.out_buf(cap)
    r = _native.library().ct_s2_build_plan(body, len(body), dlen,
                                           1 if allow_repeat else 0,
                                           int(max_rounds), out, cap)
    return _parse_payload(oarr[:r].tobytes()) if r > 0 else None


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
        plan = native_plan(blk[pos:], dlen, allow_repeat, max_rounds)
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
