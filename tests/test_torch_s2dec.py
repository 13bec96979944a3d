"""The port's S2/Snappy device decode (``compress_tpu_torch/s2/plan.py``,
``s2/device_dec.py``) against the JAX package on the CPU.

- The port's planner equals the JAX package's native ``ct_s2_build_plan``
  payload field for field (total, literals, src, len, round, n_rounds, and
  refusal), on every corpus class encoded by JAX ``s2.encode`` and by the
  port's own encoder, on blocks of 65,537, 130,000 and 262,144 bytes
  (arena classes 2 and 4), on strict snappy, at max_rounds 1, 2 and 4.
- ``decode_blocks_device(device="cpu")`` returns the input and equals JAX
  ``decode_blocks_device``.
- On 48 seeded bit flips and 4 truncations of a block, the port and the
  host decoder agree or both reject."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from compress_tpu import _native  # noqa: E402
from compress_tpu import s2 as jax_s2  # noqa: E402
from compress_tpu.s2 import device_dec as jax_sd  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import lz2  # noqa: E402
from compress_tpu_torch.s2 import decode_blocks_device  # noqa: E402
from compress_tpu_torch.s2 import plan as P  # noqa: E402
from compress_tpu_torch.utils.varint import put_uvarint, read_uvarint  # noqa: E402

NAMES = list(corpus.CLASSES)


def _native_plan(block: bytes, allow_repeat=True, max_rounds=4):
    """The native payload of one block, parsed; None where it refuses."""
    lib = jax_sd._lib()
    if lib is None:
        pytest.skip("the JAX package's native library did not build")
    dlen, pos = read_uvarint(block)
    body = block[pos:]
    cap = 8 + dlen + 6 * (4 * dlen + 2048) + 64
    oarr, out = _native.out_buf(cap)
    r = lib.ct_s2_build_plan(body, len(body), dlen, int(allow_repeat),
                             max_rounds, out, cap)
    return jax_sd._parse_payload(oarr[:r].tobytes()) if r > 0 else None


def _assert_same_plan(block, allow_repeat=True, max_rounds=4):
    dlen, pos = read_uvarint(block)
    got = P.build_plan(block[pos:], dlen, allow_repeat, max_rounds)
    want = _native_plan(block, allow_repeat, max_rounds)
    if want is None:
        assert got is None
        return None
    assert got is not None
    assert got[0] == want[0] and got[1] == want[1] and got[5] == want[5]
    for a, b in zip(got[2:5], want[2:5]):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    return got


@pytest.fixture(scope="module")
def corpus_data():
    blocks = corpus.corpus_blocks(len(NAMES), seed=13)
    blocks[NAMES.index("gate")] = corpus.make_block(
        "gate", np.random.default_rng(0))
    return [b.tobytes() for b in blocks]


@pytest.fixture(scope="module")
def port_blocks(corpus_data):
    hdr = bytearray()
    put_uvarint(hdr, lz2.B)
    bodies = lz2.s2_encode_blocks_kern(torch.from_numpy(
        np.frombuffer(b"".join(corpus_data), np.uint8).reshape(-1, lz2.B)
        .copy()))
    return [bytes(hdr) + b for b in bodies]


@pytest.mark.parametrize("name", NAMES)
def test_planner_matches_native_jax_encode(name, corpus_data):
    block = jax_s2.encode(corpus_data[NAMES.index(name)])
    for max_rounds in (1, 2, 4):
        assert _assert_same_plan(block, max_rounds=max_rounds) is not None


@pytest.mark.parametrize("name", NAMES)
def test_planner_matches_native_port_encode(name, port_blocks):
    assert _assert_same_plan(port_blocks[NAMES.index(name)]) is not None


@pytest.fixture(scope="module")
def long_texts():
    rng = np.random.default_rng(17)
    text = b"".join(corpus.make_block("text", rng).tobytes()
                    for _ in range(4))
    return {65537: text[:65537], 130000: text[:130000],
            262144: text[:262144]}


@pytest.mark.parametrize("n", [65537, 130000, 262144])
def test_planner_matches_native_large_blocks(n, long_texts):
    got = _assert_same_plan(jax_s2.encode(long_texts[n]))
    assert P.arena_class(got[0]) == (2 if n < 131073 else 4)


def test_planner_refuses_where_native_does(long_texts):
    big = long_texts[262144] + b"x"
    assert _assert_same_plan(jax_s2.encode(big)) is None
    assert _assert_same_plan(jax_s2.encode(long_texts[65537]),
                             allow_repeat=False) is None


@pytest.mark.parametrize("encoder", ["encode_snappy", "encode_better"])
def test_planner_matches_native_snappy_and_better(encoder, corpus_data):
    for i in (0, 1, 5):
        block = getattr(jax_s2, encoder)(corpus_data[i])
        strict = encoder == "encode_snappy"
        assert _assert_same_plan(block, allow_repeat=not strict) is not None


def test_decode_matches_input_and_jax(corpus_data, port_blocks, long_texts):
    blocks = ([jax_s2.encode(d[:30000]) for d in corpus_data[:4]]
              + port_blocks[4:] + [jax_s2.encode(long_texts[130000])])
    want = ([d[:30000] for d in corpus_data[:4]] + corpus_data[4:]
            + [long_texts[130000]])
    stats = {}
    got = decode_blocks_device(blocks, device="cpu", stats=stats)
    assert got == want
    assert stats["host"] == 0 and stats["device"] == len(blocks)
    assert sorted(stats["classes"]) == [1, 2]
    assert got == jax_sd.decode_blocks_device(blocks)


def test_decode_snappy_strict_and_host_route(corpus_data, long_texts):
    srcs = [corpus_data[0][:20000], corpus_data[5][:20000]]
    blocks = [jax_s2.encode_snappy(s) for s in srcs]
    assert decode_blocks_device(blocks, allow_repeat=False,
                                device="cpu") == srcs
    big = long_texts[262144] * 2          # over 256 KiB: the host decodes
    stats = {}
    assert decode_blocks_device([jax_s2.encode(big)], device="cpu",
                                stats=stats) == [big]
    assert stats == {"device": 0, "host": 1, "classes": {}}


def _outcome(fn):
    try:
        return fn()
    except Exception:  # noqa: BLE001
        return None


def test_hostile_blocks_agree_with_host():
    base_src = corpus.make_block("text", np.random.default_rng(4))[:8000]
    base = jax_s2.encode(base_src.tobytes())
    rng = np.random.default_rng(4)
    cases = []
    for _ in range(48):
        b = bytearray(base)
        k = int(rng.integers(0, len(b)))
        b[k] ^= 1 + int(rng.integers(0, 255))
        cases.append(bytes(b))
    cases += [base[:-cut] for cut in (1, 3, 7, len(base) // 2)]
    for blk in cases:
        want = _outcome(lambda: jax_s2.decode(blk))
        got = _outcome(lambda: decode_blocks_device([blk], device="cpu")[0])
        assert got == want


def test_no_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_blocks_device([jax_s2.encode(b"abc" * 100)])
