"""A numpy model of the two table-build kernels' design
(``csrc/tablebuild.cu``) on the CPU, held against their plain versions
(``ops/zdev._huff_build_ref`` and ``_normalize_count_ref``) bit for bit
(tolerance 0: integers).

The models do what the kernels do, step for step:

- the Huffman build (a CTA a row, a thread a symbol): l0 from the exact
  integer floor_log2 of ceil(total / h) - 1 and the floor division
  PyTorch's integers use; the Kraft deficit d; then up to 12 passes, each
  of which gives every symbol that can step (present, l > 1) the rank a
  stable sort gives it, by counting the keys h << l that sort before its
  own (larger, or equal at a lower symbol), writes its cost at its rank,
  and walks the costs in rank order (one thread), taking a step where the
  cost fits d and stopping where d reaches 0; the passes stop when a pass
  starts with d <= 0 or takes no step;
- the normalisation (a CTA a row of NSYM symbols): floor shares and
  remainders in 64 bits; a surplus to the present symbols whose count of
  larger remainders (equal ones at a lower symbol) is below it; a deficit
  by the counts' comparison-count ranks (descending, the lower symbol
  first on ties) and one walk over them in rank order that steals all
  each has above 1, stopping where the deficit is paid.

The ranks must form a permutation of the slots the walk reads, the walks
must stop no later than the plain versions' full scans, and the models'
results must equal the plain versions' on every ``corpus.py`` class of
both builds (``huff_build_hists``, ``normalize_hists``) at maxlog 8 and
11, NSYM 64 and 256 and logs 5-12.  A CPU tensor takes the plain
version: the wrappers launch nothing there.
"""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import zdev

PASSES = 12


def _ranks(key: np.ndarray, live: np.ndarray) -> np.ndarray:
    """Each live slot's count of live keys that sort before its own:
    larger, or equal at a lower index (a stable descending sort)."""
    n = len(key)
    t = np.arange(n)
    before = (key[None, :] > key[:, None]) | (
        (key[None, :] == key[:, None]) & (t[None, :] < t[:, None]))
    return np.where(live, (before & live[None, :]).sum(axis=1), -1)


def model_huff_build(hist: np.ndarray, maxlog: int):
    """(nbits, max_bits, ok, steps, passes) as the kernel computes them;
    steps and passes are each row's walk steps and passes run."""
    J = hist.shape[0]
    nbits = np.zeros((J, 256), np.int32)
    max_bits = np.zeros(J, np.int32)
    ok = np.zeros(J, bool)
    steps = np.zeros(J, np.int64)
    passes = np.zeros(J, np.int64)
    for j in range(J):
        h = hist[j].astype(np.int64)
        present = h > 0
        total = int(h.sum())
        hh = np.where(present, h, 1)
        ratio = (total + hh - 1) // hh                  # floor division
        l = np.array([int(r - 1).bit_length() if r > 1 else 1
                      for r in ratio], np.int64)
        l = np.where(present, np.minimum(l, maxlog), 0)
        d = (1 << maxlog) - int(np.where(present, 1 << (maxlog - l),
                                         0).sum())
        more = d > 0
        for _ in range(PASSES):
            if not more:
                break
            passes[j] += 1
            elig = present & (l > 1)
            key = np.where(elig, h << l, 0).astype(np.uint64)
            n = int(elig.sum())
            rank = _ranks(key, elig)
            assert sorted(rank[elig]) == list(range(n))
            cost = np.zeros(256, np.int64)
            cost[rank[elig]] = 1 << (maxlog - l[elig])
            take = np.zeros(256, bool)
            i, took = 0, False
            while i < n:
                tk = cost[i] <= d
                d -= int(cost[i]) if tk else 0
                took |= tk
                take[i] = tk
                i += 1
                if d == 0:
                    break
            steps[j] += i
            more = d > 0 and took
            moved = elig & (rank < i)
            l[moved] -= take[rank[moved]]
        nbits[j] = l
        max_bits[j] = l.max()
        ok[j] = d == 0 and int(present.sum()) >= 2
    return nbits, max_bits, ok, steps, passes


def model_normalize_count(hist: np.ndarray, log: int):
    """(norm, steps) as the kernel computes them; steps are each row's
    deficit-walk steps (0 without a deficit)."""
    N, nsym = hist.shape
    size = 1 << log
    out = np.zeros((N, nsym), np.int32)
    steps = np.zeros(N, np.int64)
    for r in range(N):
        h = hist[r].astype(np.int64)
        total = max(int(h.sum()), 1)
        present = h > 0
        scaled = h * size
        base = scaled // total
        rem = scaled - base * total
        norm = np.where(present, np.maximum(base, 1), 0)
        diff = size - int(norm.sum())
        if diff > 0:
            rank = _ranks(np.where(present, rem, -1), present)
            norm = norm + (present & (rank < diff))
        elif diff < 0:
            rank = _ranks(norm, np.ones(nsym, bool))
            assert sorted(rank) == list(range(nsym))
            vals = np.zeros(nsym, np.int64)
            vals[rank] = norm
            d, i = -diff, 0
            while i < nsym:
                tk = min(max(int(vals[i]) - 1, 0), d)
                d -= tk
                vals[i] -= tk
                i += 1
                if d == 0:
                    break
            steps[r] = i
            norm = vals[rank]
        out[r] = norm
    return out, steps


def _huff_rows() -> np.ndarray:
    return np.concatenate([corpus.huff_build_hists(k)
                           for k in corpus.HUFF_BUILD_CLASSES])


@pytest.mark.parametrize("maxlog", [8, 11])
@pytest.mark.parametrize("kind", corpus.HUFF_BUILD_CLASSES)
def test_huff_model_matches_plain(kind, maxlog):
    hist = corpus.huff_build_hists(kind)
    nbits, max_bits, ok, steps, passes = model_huff_build(hist, maxlog)
    want = zdev._huff_build_ref(torch.from_numpy(hist), maxlog)
    assert np.array_equal(nbits, want[0].numpy())
    assert np.array_equal(max_bits, want[1].numpy())
    assert np.array_equal(ok, want[2].numpy())
    # the walk never reads past the symbols that can step, 12 times
    assert (steps <= PASSES * 255).all() and (passes <= PASSES).all()


def test_huff_model_walks_stop_early():
    """The early stops are what the kernel saves over the plain version's
    12 walks of every symbol that can step: most hostile and corpus rows
    run one or two passes (the hostile ones up to 12), and on the corpus
    rows the walks take under a tenth of the steps of 12 walks of the
    symbols that can step at the start."""
    hist = _huff_rows()
    _, _, _, steps, passes = model_huff_build(hist, 11)
    assert (passes <= 2).mean() > 0.7
    assert passes.max() > 2
    rows = corpus.huff_build_hists("corpus")
    _, _, _, steps, _ = model_huff_build(rows, 11)
    l0_steps = 0
    for r in rows.astype(np.int64):
        h = np.maximum(r, 1)
        ratio = (r.sum() + h - 1) // h
        l0_steps += PASSES * int(((r > 0) & (ratio > 2)).sum())
    assert steps.sum() * 10 < l0_steps


@pytest.mark.parametrize("log", [5, 6, 7, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("nsym", [64, 256])
def test_normalize_model_matches_plain(nsym, log):
    for kind in corpus.NORMALIZE_CLASSES:
        hist = corpus.normalize_hists(kind, nsym, log)
        norm, steps = model_normalize_count(hist, log)
        want = zdev._normalize_count_ref(torch.from_numpy(hist), log)
        assert np.array_equal(norm, want.numpy()), kind
        assert (steps <= nsym).all()
        if kind == "deficit":
            assert (steps > 0).any() and (steps[steps > 0] < nsym).any()


def test_cpu_tensors_take_the_plain_versions():
    hist = torch.from_numpy(_huff_rows())
    before = zdev._huff_build.launches
    got = zdev._huff_build(hist, 11)
    assert zdev._huff_build.launches == before
    for a, b in zip(got, zdev._huff_build_ref(hist, 11)):
        assert torch.equal(a, b)
    counts = torch.from_numpy(corpus.normalize_hists("deficit", 64, 9))
    before = zdev._normalize_count.launches
    assert torch.equal(zdev._normalize_count(counts, 9),
                       zdev._normalize_count_ref(counts, 9))
    assert zdev._normalize_count.launches == before
    # another device is neither the kernel's nor the plain version's
    with pytest.raises(ValueError, match="CUDA tensor"):
        zdev._huff_build(torch.zeros((2, 256), dtype=torch.int64,
                                     device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        zdev._normalize_count(torch.zeros((2, 64), dtype=torch.int64,
                                          device="meta"), 9)


def test_ab_tool_sends_the_calls_to_the_plain_versions():
    """``tools/tablebuild_ab.py``'s plain arm: inside ``plain_builds``
    every module the encoders look the two builds up in holds the plain
    versions, and the kernels' wrappers are back on exit."""
    from compress_tpu_torch.ops import entropy, zenc2
    from compress_tpu_torch.tools import tablebuild_ab

    wrappers = (zdev._huff_build, zdev._normalize_count)
    with tablebuild_ab.plain_builds():
        for m in (zdev, zenc2, entropy):
            assert m._huff_build is zdev._huff_build_ref
        for m in (zdev, entropy):
            assert m._normalize_count is zdev._normalize_count_ref
    for m in (zdev, zenc2, entropy):
        assert m._huff_build is wrappers[0]
    for m in (zdev, entropy):
        assert m._normalize_count is wrappers[1]
