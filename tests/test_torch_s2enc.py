"""PyTorch port of the device S2 block encode, end to end
(compress_tpu_torch/ops/lz2.py), and the port's own host helpers.

- The kernel path's bodies (``s2_encode_blocks_kern`` on CPU tensors, the
  plain versions) equal the JAX chain finder -> lzemit2 ->
  assemble_bodies in interpret mode byte for byte, and decode with both
  the JAX package's and the port's decoder.  (``encode_blocks_np`` on the
  CPU takes the XLA engine, as the JAX one does: tests/test_torch_s2xla.py
  holds it.)
- The port's S2 decoder equals ``compress_tpu.s2.decode`` on host-encoded
  blocks that carry repeat and copy4 tags.
- The port and ``chip_smoke.py`` import neither ``jax`` nor
  ``compress_tpu``; with no card and no device given, the entry point
  raises."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu import s2 as jax_s2  # noqa: E402
from compress_tpu.ops import lz2 as jax_lz2  # noqa: E402
from compress_tpu.ops import lzemit2 as jax_lzemit2  # noqa: E402
from compress_tpu.ops import lzkern as jax_lzkern  # noqa: E402
from compress_tpu.utils import varint as jax_varint  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import lz2  # noqa: E402
from compress_tpu_torch.s2 import block as port_block  # noqa: E402
from compress_tpu_torch.utils import varint  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = list(corpus.CLASSES)


@pytest.fixture(scope="module")
def data():
    blocks = corpus.corpus_blocks(len(NAMES), seed=23)
    blocks[NAMES.index("gate")] = corpus.make_block(
        "gate", np.random.default_rng(0))
    return blocks.tobytes()


@pytest.fixture(scope="module")
def jax_bodies(data):
    blocks = jnp.asarray(np.frombuffer(data, np.uint8).reshape(-1, lz2.B))
    off, L = jax_lzkern.find_matches_blocks(blocks, interpret=True)
    b0, b1, rl = jax_lzemit2.emit_blocks(blocks, off, L, interpret=True)
    return jax_lzemit2.assemble_bodies(b0, b1, rl)


@pytest.fixture(scope="module")
def port_bodies(data):
    return lz2.s2_encode_blocks_kern(torch.from_numpy(
        np.frombuffer(data, np.uint8).reshape(-1, lz2.B).copy()))


def _hdr(n):
    out = bytearray()
    varint.put_uvarint(out, n)
    return bytes(out)


@pytest.mark.parametrize("name", NAMES)
def test_bodies_match_jax_chain(name, jax_bodies, port_bodies):
    i = NAMES.index(name)
    assert isinstance(port_bodies[i], bytes)
    assert port_bodies[i] == jax_bodies[i], name


@pytest.mark.parametrize("name", NAMES)
def test_bodies_decode_with_both_decoders(name, data, port_bodies):
    i = NAMES.index(name)
    src = data[i * lz2.B:(i + 1) * lz2.B]
    block = _hdr(lz2.B) + port_bodies[i]
    assert port_block.decode(block) == src
    assert jax_s2.decode(block) == src


def test_encode_chunks_launches(data, port_bodies, monkeypatch):
    """Inputs longer than MAX_LAUNCH_BLOCKS go in several chunks with the
    same result (the kernel path, through ``s2_encode_blocks_kern`` on
    CPU tensors)."""
    monkeypatch.setattr(lz2, "MAX_LAUNCH_BLOCKS", 3)
    monkeypatch.setattr(lz2, "_use_kernel_path", lambda dev: True)
    assert lz2.encode_blocks_np(data, device="cpu") == port_bodies


def _long_range_text(seed):
    """~200 KiB of text with a 20 KiB segment repeated 100 KiB later
    (copy4 territory) and short repeats (repeat tags)."""
    rng = np.random.default_rng(seed)
    parts = [corpus.make_block("text", rng).tobytes() for _ in range(3)]
    seg = parts[0][1000:21000]
    return parts[0] + parts[1][:40000] + seg + parts[2] + b"abcabcab" * 500


def _tag_kinds(body: bytes) -> set:
    """Tag kinds an S2 body uses: literal, copy1, repeat, copy2, copy4."""
    kinds, s = set(), 0
    while s < len(body):
        tag = body[s]
        kind = tag & 3
        if kind == 0:
            x = tag >> 2
            nb = x - 59 if x >= 60 else 0
            n = (int.from_bytes(body[s + 1:s + 1 + nb], "little") if nb
                 else x) + 1
            kinds.add("literal")
            s += 1 + nb + n
        elif kind == 1:
            rep = ((tag & 0xE0) << 3 | body[s + 1]) == 0
            code = (tag >> 2) & 7
            kinds.add("repeat" if rep else "copy1")
            s += 2 + (({5: 1, 6: 2, 7: 3}.get(code, 0)) if rep else 0)
        elif kind == 2:
            kinds.add("copy2")
            s += 3
        else:
            kinds.add("copy4")
            s += 5
    return kinds


@pytest.mark.parametrize("encoder", ["encode", "encode_better"])
@pytest.mark.parametrize("seed", [1, 2])
def test_decoder_matches_jax_package(encoder, seed):
    src = _long_range_text(seed)
    block = getattr(jax_s2, encoder)(src)
    _, pos = varint.read_uvarint(block)
    kinds = _tag_kinds(block[pos:])
    assert {"repeat", "copy4"} <= kinds, kinds
    assert port_block.decode(block) == jax_s2.decode(block) == src


def test_decoder_snappy_mode_and_corruption():
    src = _long_range_text(3)
    snappy = jax_s2.encode_snappy(src)
    assert port_block.decode(snappy, allow_repeat=False) == src
    with pytest.raises(port_block.CorruptError):
        port_block.decode(jax_s2.encode(src), allow_repeat=False)
    block = bytearray(jax_s2.encode(src))
    with pytest.raises(port_block.CorruptError):
        port_block.decode(bytes(block[:-7]))


@pytest.mark.parametrize("x", [0, 1, 127, 128, 65536, 2**35 + 5, 2**64 - 1])
def test_varint_matches_jax_package(x):
    a, b = bytearray(), bytearray()
    assert varint.put_uvarint(a, x) == jax_varint.put_uvarint(b, x)
    assert a == b
    assert varint.read_uvarint(bytes(a)) == jax_varint.read_uvarint(bytes(a))


def test_constants_match_jax():
    assert lz2.B == jax_lz2.B
    assert lz2.TILE == jax_lz2.TILE


def test_no_device_raises_without_cuda(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lz2.encode_blocks_np(data[:lz2.B])


def test_bad_length_raises():
    with pytest.raises(ValueError):
        lz2.encode_blocks_np(b"x" * 1000, device="cpu")


def test_corpus_is_seeded():
    a = corpus.corpus_blocks(len(NAMES), seed=4)
    b = corpus.corpus_blocks(len(NAMES), seed=4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, corpus.corpus_blocks(len(NAMES), seed=5))


def _port_sources():
    return sorted((ROOT / "compress_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax_or_reference():
    """Static check over every import statement, including those inside
    functions."""
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "compress_tpu"), (
                    f"{path.relative_to(ROOT)} imports {n}")


def test_importing_port_loads_no_jax_or_reference():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "compress_tpu_torch").rglob("*.py")
        if p.name != "__init__.py" or p.parent.name != "compress_tpu_torch")
    code = (
        "import sys, importlib, runpy\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'compress_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

