"""``compress_tpu_torch/tools/gpu_diff.py``, the on-card sweep of every
kernel against its plain version, checked on the CPU: its list covers
every C entry of ``_cuda.py``'s table (rows 1-18 and a-c, and the
occupancy queries), its ``main()`` and the script exit non-zero where
there is no CUDA card, and the checks whose wrappers take CPU tensors
build their hostile inputs and run them through the plain versions (the
same inputs the card holds the kernels to)."""

import pathlib
import subprocess
import sys

import pytest
import torch

from compress_tpu_torch import _cuda
from compress_tpu_torch.tools import gpu_diff

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROWS = {"1-2", "3-4", "5", "6", "7", "8", "9", "10", "11", "12", "13", "14",
        "15-16", "17", "18", "a", "b", "c"}


def test_kernel_list_covers_every_entry():
    covered = [s for _, _, syms, _ in gpu_diff.KERNELS for s in syms]
    assert sorted(covered) == sorted(set(covered))
    assert set(covered) == set(_cuda._SIGNATURES)
    assert {rows for _, rows, _, _ in gpu_diff.KERNELS} - {"-"} == ROWS


def test_main_exits_non_zero_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert gpu_diff.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
    r = subprocess.run([sys.executable, str(ROOT / "compress_tpu_torch"
                                            / "tools" / "gpu_diff.py")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    assert "ALL OK" not in r.stdout


@pytest.mark.parametrize("name", ["litlut", "execute", "checksums",
                                  "fse_encode_chain", "fse_decode_chunks",
                                  "tile_parse", "fse_scan",
                                  "byte_histograms", "huff_build",
                                  "normalize_count"])
def test_checks_build_their_inputs(name):
    fn = next(f for n, _, _, f in gpu_diff.KERNELS if n == name)
    assert fn(torch.device("cpu"))


def test_a_mismatch_is_reported():
    with pytest.raises(gpu_diff.Mismatch):
        gpu_diff._same([torch.zeros(3)], [torch.ones(3)], "x")
    with pytest.raises(gpu_diff.Mismatch):
        gpu_diff._same([torch.zeros(3, dtype=torch.int32)],
                       [torch.zeros(3, dtype=torch.int64)], "dtype")
    gpu_diff._same([torch.arange(4), None], [torch.arange(4), None], "same")
