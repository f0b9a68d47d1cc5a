"""The port's CUDA kernels on the card: built with nvcc, held against their
plain versions at the main path's shapes. Skipped where there is no card;
run them on the machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports jax, which that machine
may not have.)
"""

import numpy as np
import pytest
import torch

from acezero_tpu_torch.ops import fused_head as fh
from acezero_tpu_torch.utils.precision import no_tf32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there (no interpret mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,tags", [(307_200, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (3 * 4800 + 37, (0, 0, 1, 0, 0)),
                                    (4800, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0))])
def test_fused_head_fwd_matches_plain(cuda, B, tags):
    rng = np.random.default_rng(B)
    L = len(tags)
    x = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32) * 0.5).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-1, 1, (L, 512, 512)).astype(np.float32) / 512**0.5).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.uniform(-1, 1, (L, 512)).astype(np.float32) / 512**0.5).to(cuda)
    before = fh.LAUNCHES
    out = fh.fused_head_chain(x, w, b, tags)
    torch.cuda.synchronize()
    assert fh.LAUNCHES == before + 1
    with no_tf32():
        ref = fh.fused_head_chain_plain(x, w, b, tags).float()
    rel = float((out.float() - ref).norm() / ref.norm())
    assert rel <= 1e-2
