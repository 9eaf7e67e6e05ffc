"""``repro_torch.kernels.fused_update``: each kernel's plain version
against the JAX package's Pallas kernel in interpret mode, plus the
wrappers' contract.

Inputs are made with numpy from a seed and handed to both sides.  The
plain versions run here (CPU tensors); the CUDA kernels are held against
them on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``, which skips without a card.

Tolerances: f32 at rtol 1e-6, atol 1e-7 (XLA's CPU backend may contract
a multiply-add into an FMA, which rounds once where torch rounds
twice).  For ``weighted_delta`` the rtol is taken against the magnitude
of the summed terms, |p| + Σ|w̄ₖ·(sₖ − p)| + |e|, not of the result: the
weights sum to 1, so the result can cancel to far below its terms while
a contraction's rounding difference stays at the terms' scale.  The
plain version is also held BITWISE against a sequential numpy f32
reference, which rounds every step.  bf16 within one bf16 ulp (2⁻⁷
relative) of the f32-computed value, since either side may land on the
other neighbour after such a contraction.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import fused_update as jfu
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import ops

SIZES = (1, 1000, 4096)
DTYPES = ("float32", "bfloat16")
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round f32 → bf16 to nearest even)."""
    return (jnp.asarray(a, JAX_DTYPE[dtype]),
            torch.from_numpy(a.copy()).to(TORCH_DTYPE[dtype]))


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, dtype: str, scale=None):
    a, b = _to_np(t), _to_np(j)
    if dtype == "float32":
        ref = np.abs(b) if scale is None else np.maximum(np.abs(b), scale)
        bad = np.abs(a - b) > 1e-6 * ref + 1e-7
        assert not bad.any(), (np.abs(a - b)[bad].max(), int(bad.sum()))
    else:
        ulp = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b))
        assert np.all(np.abs(a - b) <= ulp + 1e-30), np.max(np.abs(a - b))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("has_m", [False, True])
@pytest.mark.parametrize("has_c", [False, True])
def test_local_step_matches_pallas(n, dtype, has_m, has_c):
    jp, tp = _both(_np(1, n), dtype)
    jg, tg = _both(_np(2, n), dtype)
    jm, tm_ = _both(_np(3, n), dtype) if has_m else (None, None)
    jc, tc = _both(_np(4, n), dtype) if has_c else (None, None)
    beta = 0.9 if has_m else 0.0
    jp2, jm2 = jfu.local_step(jp, jg, jm, jc, jnp.float32(0.7),
                              jnp.float32(0.05), weight_decay=1e-3,
                              momentum=beta, interpret=True)
    scalars = torch.tensor([0.7, 0.05], dtype=torch.float32)
    tp2, tm2 = fu.local_step(tp, tg, tm_, tc, scalars, weight_decay=1e-3,
                             momentum=beta)
    assert tp2 is tp and tm2 is tm_            # in place
    _close(tp2, jp2, dtype)
    if has_m:
        _close(tm2, jm2, dtype)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("K", [1, 10, 25])
@pytest.mark.parametrize("has_extra", [False, True])
@pytest.mark.parametrize("deltas", [False, True])
def test_weighted_delta_matches_pallas(n, K, has_extra, deltas):
    js, ts = _both(_np(5, K, n), "float32")
    jp, tp = _both(_np(6, n), "float32")
    w = np.random.default_rng(7).random(K).astype(np.float32)
    w /= w.sum()
    je, te = _both(_np(8, n), "float32") if has_extra else (None, None)
    want = jfu.weighted_delta(js, jp, jnp.asarray(w), extra=je,
                              deltas=deltas, interpret=True)
    got = fu.weighted_delta(ts, tp, torch.from_numpy(w), extra=te,
                            deltas=deltas)
    s, p = _np(5, K, n), _np(6, n)
    e = _np(8, n) if has_extra else np.zeros(n, np.float32)
    terms = [w[k] * (s[k] if deltas else s[k] - p) for k in range(K)]
    scale = np.abs(p) + np.abs(e) + np.sum(np.abs(terms), axis=0)
    _close(got, want, "float32", scale)
    # the plain version rounds every step, exactly like this loop
    acc = e.copy()
    for k in range(K):
        acc = acc + np.float32(w[k]) * (s[k] if deltas else s[k] - p)
    np.testing.assert_array_equal(got.numpy(), p + acc)


@pytest.mark.parametrize("n", SIZES)
def test_weighted_delta_bf16_matches_pallas(n):
    js, ts = _both(_np(9, 10, n), "bfloat16")
    jp, tp = _both(_np(10, n), "bfloat16")
    w = np.full(10, 0.1, np.float32)
    want = jfu.weighted_delta(js, jp, jnp.asarray(w), interpret=True)
    got = fu.weighted_delta(ts, tp, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("opt", ["none", "momentum", "adam"])
def test_server_update_matches_pallas(n, opt):
    jp, tp = _both(_np(11, n), "float32")
    d = 0.01 * _np(12, n)
    n_m = {"none": 0, "momentum": 1, "adam": 2}[opt]
    moms = [np.abs(_np(13 + i, n)) for i in range(n_m)]
    sc = [0.5, 0.19, 0.0199][:3 if opt == "adam" else 1]
    jp2, jms = jfu.server_update(jp, jnp.asarray(d),
                                 tuple(jnp.asarray(m) for m in moms),
                                 tuple(jnp.float32(s) for s in sc), opt=opt,
                                 beta=0.9, b1=0.9, b2=0.99, interpret=True)
    tms = tuple(torch.from_numpy(m.copy()) for m in moms)
    tp2, tms2 = fu.server_update(tp, torch.from_numpy(d), tms,
                                 torch.tensor(sc, dtype=torch.float32),
                                 opt=opt, beta=0.9, b1=0.9, b2=0.99)
    _close(tp2, jp2, "float32")
    for a, b in zip(tms2, jms):
        _close(a, b, "float32")


def _padded(seed, n, pad):
    a = np.zeros(n + pad, np.float32)
    a[:n] = _np(seed, n)
    return torch.from_numpy(a)


def test_pad_lanes_stay_zero():
    n, pad = 1000, fu.GRID_ALIGN - 1000
    p, g, m = _padded(1, n, pad), _padded(2, n, pad), _padded(3, n, pad)
    fu.local_step(p, g, m, None, torch.tensor([0.7, 0.05]),
                  weight_decay=1e-3, momentum=0.9)
    assert not p[n:].any() and not m[n:].any()
    stacked = torch.stack([_padded(4 + k, n, pad) for k in range(3)])
    out = fu.weighted_delta(stacked, p, torch.full((3,), 1 / 3),
                            extra=_padded(9, n, pad))
    assert not out[n:].any()
    mu, nu = _padded(10, n, pad).abs(), _padded(11, n, pad).abs()
    fu.server_update(p, _padded(12, n, pad), (mu, nu),
                     torch.tensor([0.5, 0.19, 0.0199]), opt="adam")
    assert not p[n:].any() and not mu[n:].any() and not nu[n:].any()


def test_cpu_tensors_never_count_launches():
    fu.reset_launch_counts()
    p, g = torch.ones(8), torch.ones(8)
    fu.local_step(p, g, None, None, torch.tensor([1.0, 0.1]))
    fu.weighted_delta(torch.ones(2, 8), p, torch.tensor([0.5, 0.5]))
    fu.server_update(p, torch.ones(8), (torch.zeros(8),), torch.tensor([1.0]),
                     opt="momentum")
    assert [k.launches for k in fu.KERNELS] == [0, 0, 0]


def test_interpret_selects_plain_versions():
    """``update_impl="fused_interpret"`` routes through the plain
    versions, which give the wrappers' results."""
    assert ops.fused_interpret("fused_interpret")
    assert not ops.fused_interpret("fused")
    a, b = torch.arange(6.0), torch.arange(6.0)
    g = torch.ones(6)
    sc = torch.tensor([1.0, 0.5])
    ops.fused_local_step(a, g, None, None, sc, interpret=True)
    ops.fused_local_step(b, g, None, None, sc, interpret=False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "shape", "scalars", "momentum"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    p = torch.zeros(16)
    g = torch.zeros(16, dtype=torch.float64) if bad == "dtype" \
        else torch.zeros(8 if bad == "shape" else 16)
    sc = torch.zeros(3 if bad == "scalars" else 2)
    m = torch.zeros(16) if bad == "momentum" else None
    with pytest.raises((TypeError, ValueError)):
        fu.local_step(p, g, m, None, sc)


def test_weighted_delta_rejects_mismatched_stack():
    with pytest.raises(ValueError):
        fu.weighted_delta(torch.zeros(3, 8), torch.zeros(16),
                          torch.zeros(3))
    with pytest.raises(ValueError):
        fu.server_update(torch.zeros(8), torch.zeros(8), (), torch.zeros(1),
                         opt="adam")


def test_bf16_inputs_round_the_same_on_both_sides():
    a = _np(20, 64)
    j, t = _both(a, "bfloat16")
    np.testing.assert_array_equal(np.asarray(j).astype(np.float32),
                                  t.float().numpy())
    assert np.asarray(j).dtype == ml_dtypes.bfloat16
