"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  The file
imports torch only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import fused_update as fu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_kernels_match_plain_versions_bitwise(gen):
    """Every kernel bit-equal to its plain version, on the 16-byte
    vector path (N a multiple of 1024) and the one-element path."""
    n = 137_216 + 3                    # the vector path and the tail path

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        for nn in (n - 3, n):
            p, g, m = r(nn, dtype=dtype), r(nn, dtype=dtype), r(nn, dtype=dtype)
            sc = torch.tensor([0.7, 0.05], device="cuda")
            a, am = p.clone(), m.clone()
            b, bm = p.clone(), m.clone()
            fu.local_step(a, g, am, None, sc, weight_decay=1e-3, momentum=0.9)
            fu.local_step_plain(b, g, bm, None, sc, weight_decay=1e-3,
                                momentum=0.9)
            assert torch.equal(a, b) and torch.equal(am, bm)
            st = r(10, nn, dtype=dtype)
            w = torch.full((10,), 0.1, device="cuda")
            assert torch.equal(fu.weighted_delta(st, p, w),
                               fu.weighted_delta_plain(st, p, w))
            d = r(nn) * 1e-2
            mu, nu = r(nn, dtype=dtype).abs(), r(nn, dtype=dtype).abs()
            sc3 = torch.tensor([0.5, 0.19, 0.0199], device="cuda")
            a, amu, anu = p.clone(), mu.clone(), nu.clone()
            fu.server_update(a, d, (amu, anu), sc3, opt="adam")
            fu.server_update_plain(p, d, (mu, nu), sc3, opt="adam")
            assert torch.equal(a, p) and torch.equal(amu, mu)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_launch_counts_and_checks(gen):
    fu.reset_launch_counts()
    p = torch.randn(4096, generator=gen, device="cuda")
    sc = torch.tensor([1.0, 0.1], device="cuda")
    fu.local_step(p, p.clone(), None, None, sc)
    fu.weighted_delta(torch.stack([p, p]), p,
                      torch.full((2,), 0.5, device="cuda"))
    fu.server_update(p, torch.zeros_like(p), (), sc[:1], opt="none")
    assert [k.launches for k in fu.KERNELS] == [1, 1, 1]
    with pytest.raises(ValueError):
        fu.local_step(p, p.cpu(), None, None, sc)
    torch.cuda.synchronize()
