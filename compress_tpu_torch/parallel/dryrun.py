"""The multi-chip dryrun (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): the sharded encode step, the
sharded zstd job engine with its halo and the sharded device decode, at
tiny shapes over a mesh, each checked by decoding."""

from __future__ import annotations

import numpy as np

from compress_tpu_torch import s2, zstd
from compress_tpu_torch.parallel.engine import (block_mesh, encode_step_stats,
                                                zstd_decode_sharded,
                                                zstd_encode_sharded)
from compress_tpu_torch.utils.varint import put_uvarint


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(mesh=None) -> dict:
    """One step of each sharded path over ``mesh`` (the default mesh when
    None); raises when an output does not decode to its input.  Returns
    the sizes it saw: ``blocks``, ``total`` (compressed S2 bytes),
    ``zstd_in``, ``zstd_frame`` and ``items``."""
    mesh = mesh or block_mesh()
    bs, tile = 4096, 256  # tiny blocks for the dryrun
    nb = 2 * mesh.size
    rng = np.random.default_rng(1)
    motif = rng.integers(0, 8, 61, dtype=np.uint8).tobytes()
    data = (motif * (nb * bs // len(motif) + 1))[:nb * bs]
    blocks = np.frombuffer(data, np.uint8).reshape(nb, bs)
    out, lens, total = encode_step_stats(blocks, mesh, tile=tile)
    out, lens = out.cpu().numpy(), lens.cpu().numpy()
    _check(lens.shape == (nb,), f"lens shape {lens.shape}")
    _check(int(total) == int(lens.sum()), "total is not the sum of lens")
    # every rank's output decodes on the host
    hdr = bytearray()
    put_uvarint(hdr, bs)
    for k in range(nb):
        got = s2.decode(bytes(hdr) + out[k, :lens[k]].tobytes())
        _check(got == data[k * bs:(k + 1) * bs],
               f"sharded device encode mismatch, block {k}")

    # the zstd job engine over the mesh: the halo exchange, the per-rank
    # encode and the ordered gather.  One decode covers every rank and
    # every job seam: the motif period (61) does not divide JOB, so
    # matches cross rank boundaries through the halo prefix.
    JOB, BLOCK = 1 << 13, 1 << 12
    zdata = (motif * (mesh.size * JOB // len(motif) + 2))[:mesh.size * JOB
                                                          + 99]
    frame = zstd_encode_sharded(zdata, mesh, job=JOB, block=BLOCK)
    _check(zstd.decompress(frame) == zdata, "sharded zstd mismatch")

    # the sharded device decode over the same mesh
    srcs = [zdata[k * 3000:(k + 1) * 3000] for k in range(mesh.size + 1)]
    items = [zstd.compress_accel(s, level=1) for s in srcs]
    _check(zstd_decode_sharded(items, mesh) == srcs, "sharded decode")
    return {"blocks": nb, "total": int(total), "zstd_in": len(zdata),
            "zstd_frame": len(frame), "items": len(items)}
