"""``repro_torch.kernels.ssd_scan``: the plain version of K8 and the card
kernel's chunk-parallel decomposition (``ssd_chunk_parallel_plain``)
against the JAX package's Pallas kernel in interpret mode and against both
packages' sequential oracles, for y and the final state, plus the
wrapper's contract on the CPU.

Inputs are made with numpy from a seed (x, B, C normal; dt = softplus of
a normal; A = -exp of a normal, as ``tests/test_kernels.py`` draws them)
and handed to both sides.  The CUDA kernel itself is held against the
plain version on the card.

Tolerances: against the Pallas kernel, f32 at atol = rtol = 1e-4: the two
run the same chunked algorithm, but XLA's cumsum and matmuls add in
another order than torch's, and exp(cum_i - cum_j) turns an absolute
error of the cumulative log-decay (which grows to ~|A|·dt·chunk) into a
relative error of the decay.  Against the sequential oracles, 2e-3, the
JAX package's own tolerance for the chunked form against the
recurrence.  bf16 y within one bf16 ulp (2⁻⁷ relative) plus 1e-3
absolute, the state (always f32) as for f32.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_scan import (ssd_chunk_parallel_plain, ssd_scan,
                                          ssd_scan_plain)
from repro_torch.models import ssm as tssm

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# one compile per case instead of one per op
jssd_chunked = jax.jit(jssm.ssd_chunked,
                       static_argnames=("chunk", "return_final_state"))
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, s, h, p, n, g, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    if dtype == "bfloat16":
        x, B, C = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (x, B, C))
    j = (jnp.asarray(x, JDT[dtype]), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B, JDT[dtype]), jnp.asarray(C, JDT[dtype]))
    t = (torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(B).to(TDT[dtype]),
         torch.from_numpy(C).to(TDT[dtype]))
    return j, t


def _close(got: torch.Tensor, want, dtype: str, tol: float):
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(want, jnp.float32))
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)
    else:
        bad = np.abs(a - b) > 2.0 ** -7 * np.abs(b) + 1e-3
        assert not bad.any(), (np.abs(a - b)[bad].max(), int(bad.sum()))


SHAPES = [
    # b, s, h, p, n, g, chunk
    (2, 64, 2, 32, 16, 1, 32),     # one group
    (1, 80, 4, 16, 8, 2, 32),      # grouped B/C (hpg 2), 80 -> 96 padded
    (2, 40, 3, 16, 16, 3, 16),     # g = h, 40 -> 48 padded
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", SHAPES)
def test_plain_matches_pallas_interpret(dtype, b, s, h, p, n, g, chunk):
    jin, tin = _inputs(s + h, b, s, h, p, n, g, dtype)
    y_want, f_want = pallas_ssd(*jin, chunk=chunk, interpret=True)
    y, final = ssd_scan_plain(*tin, chunk=chunk)
    assert y.dtype == TDT[dtype] and final.dtype == torch.float32
    _close(y, y_want, dtype, 1e-4)
    _close(final, f_want, "float32", 1e-4)


@pytest.mark.parametrize("b,s,h,p,n,g,chunk", SHAPES)
def test_plain_matches_sequential_oracles(b, s, h, p, n, g, chunk):
    jin, tin = _inputs(1, b, s, h, p, n, g, "float32")
    y, final = ssd_scan_plain(*tin, chunk=chunk)
    y_ref, f_ref = jref.ssd_ref(*jin)
    _close(y, y_ref, "float32", 2e-3)
    _close(final, f_ref, "float32", 2e-3)
    ty, tf = tref.ssd_ref(*tin)
    _close(ty, y_ref, "float32", 1e-4)
    _close(tf, f_ref, "float32", 1e-4)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", SHAPES)
def test_ssd_chunked_matches_jax(b, s, h, p, n, g, chunk, with_state):
    """The models' "xla" SSD path (every chunk at once, then a short
    loop over the chunk states) against the JAX package's, from a given
    entering state too, and against the sequential oracle."""
    jin, tin = _inputs(9, b, s, h, p, n, g, "float32")
    init = np.random.default_rng(9).standard_normal(
        (b, h, p, n)).astype(np.float32) if with_state else None
    y_want, f_want = jssd_chunked(
        *jin, chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init),
        return_final_state=True)
    tinit = None if init is None else torch.from_numpy(init)
    y, final = tssm.ssd_chunked(*tin, chunk, initial_state=tinit,
                                return_final_state=True)
    _close(y, y_want, "float32", 1e-4)
    _close(final, f_want, "float32", 1e-4)
    y_ref, f_ref = tssm.ssd_reference(*tin, initial_state=tinit)
    _close(y, y_ref.numpy(), "float32", 2e-3)
    _close(final, f_ref.numpy(), "float32", 2e-3)
    assert torch.equal(tssm.ssd_chunked(*tin, chunk, initial_state=tinit),
                       y)


def test_chunk_invariance():
    """The chunked algorithm is exact: the chunk size must not matter."""
    _, tin = _inputs(2, 1, 96, 2, 16, 8, 1, "float32")
    y32, f32_ = ssd_scan_plain(*tin, chunk=32)
    y48, f48 = ssd_scan_plain(*tin, chunk=48)
    y96, f96 = ssd_scan_plain(*tin, chunk=96)
    for y, f in ((y48, f48), (y96, f96)):
        torch.testing.assert_close(y, y32, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(f, f32_, atol=1e-4, rtol=1e-4)


def test_padding_leaves_the_state_untouched():
    """dt = 0 padding: a sequence cut at s gives the prefix's state."""
    _, (x, dt, A, B, C) = _inputs(3, 1, 50, 2, 16, 8, 1, "float32")
    y, final = ssd_scan_plain(x, dt, A, B, C, chunk=32)
    y_s, f_s = ssd_scan_plain(x[:, :40], dt[:, :40], A, B[:, :40], C[:, :40],
                              chunk=32)
    torch.testing.assert_close(y[:, :40], y_s, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(final, f_s)
    _, f_ref = tref.ssd_ref(x[:, :40], dt[:, :40], A, B[:, :40], C[:, :40])
    torch.testing.assert_close(f_s, f_ref, atol=2e-3, rtol=2e-3)


def test_wrapper_runs_plain_on_cpu_and_counts_nothing():
    _, tin = _inputs(4, 1, 40, 2, 16, 8, 1, "bfloat16")
    before = ssd_scan.launches
    y, final = ssd_scan(*tin, chunk=16)
    assert ssd_scan.launches == before
    y_p, f_p = ssd_scan_plain(*tin, chunk=16)
    assert torch.equal(y, y_p) and torch.equal(final, f_p)
    assert torch.equal(ops.ssd(*tin, chunk=16, interpret=True), y)
    y2, f2 = ops.ssd_with_state(*tin, chunk=16)
    assert torch.equal(y2, y) and torch.equal(f2, final)


def test_wrapper_checks():
    _, (x, dt, A, B, C) = _inputs(5, 1, 16, 4, 8, 8, 2, "float32")
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), A, B, C)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :8], A, B, C)
    with pytest.raises(ValueError):
        ssd_scan(x[:, :, :3], dt[:, :, :3], A[:3], B, C)   # h % g != 0


CP_SHAPES = [
    # b, s, h, p, n, g, chunk
    (1, 70, 4, 32, 16, 1, 32),     # hymba's d_state, one group, ragged s
    (1, 48, 4, 32, 128, 2, 32),    # mamba2's d_state, grouped (hpg 2)
    (2, 20, 2, 32, 16, 1, 32),     # a single chunk, s < chunk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", CP_SHAPES)
def test_chunk_parallel_plain_matches_pallas_interpret(dtype, b, s, h, p, n,
                                                       g, chunk):
    """The card kernel's decomposition, with the bf16 path's hi + lo
    rounding of M, w·B and the entering state, against the Pallas kernel:
    f32 at 1e-4, bf16 y within one bf16 ulp + 1e-3, the state at 1e-4."""
    jin, tin = _inputs(7 * s + n, b, s, h, p, n, g, dtype)
    y_want, f_want = pallas_ssd(*jin, chunk=chunk, interpret=True)
    y, final = ssd_chunk_parallel_plain(*tin, chunk=chunk)
    assert y.dtype == TDT[dtype] and final.dtype == torch.float32
    _close(y, y_want, dtype, 1e-4)
    _close(final, f_want, "float32", 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", CP_SHAPES)
def test_chunk_parallel_plain_matches_plain(dtype, b, s, h, p, n, g, chunk):
    """Against the sequential plain version the card kernel is held to on
    the card, at the card tests' tolerances: f32 1e-4 abs + rel; bf16 y
    within one bf16 ulp + 1e-4, the state 1e-4 abs + rel."""
    _, tin = _inputs(3 * s + h, b, s, h, p, n, g, dtype)
    y, final = ssd_chunk_parallel_plain(*tin, chunk=chunk)
    y_p, f_p = ssd_scan_plain(*tin, chunk=chunk)
    a, r = y.float(), y_p.float()
    tol = (1e-4 + 1e-4 * r.abs() if dtype == "float32"
           else 2.0 ** -7 * r.abs() + 1e-4)
    assert not ((a - r).abs() > tol).any()
    torch.testing.assert_close(final, f_p, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chunk,p,n,dtype,fits", [
    (128, 64, 16, torch.bfloat16, True),     # hymba-1.5b
    (128, 64, 16, torch.float32, True),
    (128, 64, 128, torch.bfloat16, True),    # mamba2
    (128, 64, 128, torch.float32, True),
    (128, 128, 128, torch.float32, False),   # the kernel refuses it
])
def test_smem_bytes(chunk, p, n, dtype, fits):
    assert (tssd.smem_bytes(chunk, p, n, dtype) <= tssd.SMEM_LIMIT) == fits
