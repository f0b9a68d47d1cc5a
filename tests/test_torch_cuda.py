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
                                    (4800, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (1, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (64, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (65, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120, (0,)),
                                    (5120 + 37, (1,)),
                                    (132 * 64, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    ((2 * 132 + 1) * 64 + 37, (0, 0, 1, 0, 0, 1, 0, 0))])
def test_fused_head_fwd_matches_plain(cuda, B, tags):
    """K1 against its plain version at relative Frobenius 1e-2: the main
    paths' shapes, the tile edges, one layer with and without the residual
    add, a full H100 (one tile per SM) and a persistent grid whose tile count
    is no multiple of the SMs."""
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


@pytest.mark.parametrize("B,tags", [(5120, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120 + 37, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120, (0, 0, 1, 0, 0)),
                                    (5120, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)),
                                    (1, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (64, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (65, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120, (0,)),
                                    (5120 + 37, (1,))])
def test_fused_head_bwd_matches_plain(cuda, B, tags):
    """K2 against its plain version: relative Frobenius 2e-2 (chip_smoke.py
    K2_TOL: tensor-core and IEEE sums flip single bf16 roundings and, rarely,
    ReLU masks, compounded over the walk back); the Function's dW, db against
    autograd of the plain chain at 2e-2."""
    rng = np.random.default_rng(B + len(tags))
    L = len(tags)
    x = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32) * 0.5).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-1, 1, (L, 512, 512)).astype(np.float32) / 512**0.5).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.uniform(-1, 1, (L, 512)).astype(np.float32) / 512**0.5).to(cuda)
    g = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32) * 1e-2).to(cuda, torch.bfloat16)
    before = fh.LAUNCHES_BWD
    out = fh.fused_head_chain_backward(x, w, b, g, tags)
    torch.cuda.synchronize()
    assert fh.LAUNCHES_BWD == before + 1
    with no_tf32():
        ref = fh.fused_head_chain_backward_plain(x, w, b, g, tags)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.bfloat16
        assert float((o.float() - r.float()).norm() / r.float().norm()) <= 2e-2
    grads = []
    for fn in (lambda *a: fh.FusedHeadChain.apply(*a, tags), lambda *a: fh.fused_head_chain_plain(*a, tags)):
        wf = w.float().requires_grad_(True)
        bf = b.clone().requires_grad_(True)
        with no_tf32():
            (fn(x, wf, bf).float() * g.float()).sum().backward()
        grads.append((wf.grad, bf.grad))
    for got, want in zip(*grads):
        assert float((got - want).norm() / want.norm()) <= 2e-2
