"""Tests that need a CUDA card: every kernel of csrc/gram.cu against its
plain version on the card, at small, ragged shapes.

This file imports no JAX, so it also runs on a machine without it (the
suite's conftest.py imports JAX, hence --noconftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.cuda
def test_all_kernels_match_plain_on_cuda():
    """chip_smoke's kernel checks (K1-K3, K6, K10, then K7, K8, K9, K11) at
    small shapes, each against its plain version with its tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    device = torch.device("cuda")
    chip_smoke.check_kernels(device, S=40, D=700, rows4=333, D4=137)
    chip_smoke.check_weighted_kernels(device, small=True)
