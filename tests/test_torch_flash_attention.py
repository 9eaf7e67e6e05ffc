"""``repro_torch.kernels.flash_attention``: the plain version of K7 against
the JAX package's Pallas kernel in interpret mode and against both
packages' dense oracles, the decode kernel's split-then-merge arithmetic
(``split_merge_plain``) against both, plus the wrapper's contract on the
CPU.

Inputs are made with numpy from a seed and handed to both sides.  The
CUDA kernel itself is held against the plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).

Tolerances: f32 at atol = rtol = 2e-5, the JAX package's own tolerance
for this kernel: the Pallas kernel takes the softmax online in blocks of
16 keys, the plain version densely, so sums and exponentials round in
another order.  bf16 outputs within one bf16 ulp (2⁻⁷ relative) plus
2e-5 absolute: both sides compute in f32 from the same bf16 inputs and
round once at the end, so they may land on neighbouring bf16 values.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro_torch.kernels import library, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain, split_merge_plain)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# one compile per case instead of one per op
jattention_ref = jax.jit(jref.attention_ref,
                         static_argnames=("causal", "window", "q_offset"))


def _inputs(seed, B, S, T, H, KH, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, T, KH, hd), (B, T, KH, hd))]
    if dtype == "bfloat16":     # the same bf16 values on both sides
        arrs = [a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in arrs]
    j = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    t = [torch.from_numpy(a.copy()).to(TDT[dtype]) for a in arrs]
    return j, t


def _close(got: torch.Tensor, want, dtype: str):
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)
    else:
        bad = np.abs(a - b) > 2.0 ** -7 * np.abs(b) + 2e-5
        assert not bad.any(), (np.abs(a - b)[bad].max(), int(bad.sum()))


CASES = [
    # B, S, T, H, KH, hd, window, q_offset
    (2, 40, 40, 6, 2, 32, None, 0),        # GQA G=3, ragged S = T
    (1, 40, 40, 5, 5, 64, 8, 0),           # MHA, sliding window
    (2, 24, 37, 4, 1, 32, None, 13),       # MQA, ragged S and T, offset
    (2, 1, 50, 6, 2, 32, None, 17),        # decode against a longer cache
    (2, 1, 50, 6, 2, 32, 8, 49),           # decode, window, last position
    (1, 3, 50, 4, 2, 16, 5, 30),           # a few queries against a cache
    (1, 20, 20, 4, 2, 32, 0, 0),           # window 0: no key, output 0
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,KH,hd,window,q_offset", CASES)
def test_plain_matches_pallas_interpret(dtype, B, S, T, H, KH, hd, window,
                                        q_offset):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B + S + T, B, S, T, H, KH, hd, dtype)
    jw = None if window is None else jnp.int32(window)
    want = pallas_fa(jq, jk, jv, causal=True, window=jw,
                     q_offset=jnp.int32(q_offset), block_q=16, block_k=16,
                     interpret=True)
    got = flash_attention_plain(tq, tk, tv, window=window, q_offset=q_offset)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, hd)
    _close(got, want, dtype)


@pytest.mark.parametrize("B,S,T,H,KH,hd,window,q_offset",
                         [c for c in CASES if c[6] != 0])
def test_plain_matches_dense_oracles(B, S, T, H, KH, hd, window, q_offset):
    """Where every query sees a key, the plain version is the dense
    softmax: against the JAX oracle and the port's own."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, B, S, T, H, KH, hd, "float32")
    got = flash_attention_plain(tq, tk, tv, window=window, q_offset=q_offset)
    want = jattention_ref(jq, jk, jv, window=window, q_offset=q_offset)
    _close(got, want, "float32")
    _close(tref.attention_ref(tq, tk, tv, window=window, q_offset=q_offset),
           want, "float32")


def test_fully_masked_rows_are_zero_not_nan():
    _, (q, k, v) = _inputs(3, 1, 6, 6, 2, 1, 16, "float32")
    out = flash_attention_plain(q, k, v, kv_len=0)
    assert torch.equal(out, torch.zeros_like(out))
    # kv_len cuts keys off the end: the same as a shorter cache
    part = flash_attention_plain(q, k, v, q_offset=2, kv_len=4)
    short = flash_attention_plain(q, k[:, :4], v[:, :4], q_offset=2)
    torch.testing.assert_close(part, short, rtol=0, atol=0)


def test_wrapper_runs_plain_on_cpu_and_counts_nothing():
    _, (q, k, v) = _inputs(4, 1, 8, 8, 4, 2, 32, "bfloat16")
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=3)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_plain(q, k, v, window=3))
    assert torch.equal(ops.flash_attention(q, k, v, window=3, interpret=True),
                       out)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v, causal=False)


def test_wrapper_checks():
    _, (q, k, v) = _inputs(5, 1, 8, 8, 4, 2, 32, "float32")
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        flash_attention(q, k[..., :16], v[..., :16])
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :3], k, v)        # H % KH != 0
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv_len=9)


# The split decode: per-chunk partials (m, l, acc) merged as the kernel's
# last block merges them, held to the plain version (and through the first
# case list to the Pallas kernel) at the tolerances above: the merge only
# regroups the same f32 sums.
SPLIT_CASES = [
    # B, S, T, H, KH, hd, window, q_offset, kv_len, chunk
    (2, 1, 50, 6, 2, 32, None, 17, None, 8),    # chunks past the query: empty
    (2, 1, 50, 6, 2, 32, 8, 49, None, 16),      # window in one chunk, rest empty
    (1, 3, 50, 4, 2, 16, 5, 30, None, 4),       # rows with their own qpos
    (2, 4, 64, 8, 2, 32, None, 60, None, 64),   # S·G = 16 in one chunk
    (2, 2, 40, 10, 5, 16, None, 30, 25, 7),     # kv_len < T, a ragged last chunk
    (1, 1, 37, 5, 1, 16, 3, 36, None, 1),       # one key per chunk
    (1, 4, 20, 4, 1, 32, 0, 0, None, 8),        # window 0: every row empty
    (1, 1, 10, 2, 1, 16, None, 5, 0, 4),        # kv_len 0: every row empty
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,KH,hd,window,q_offset,kv_len,chunk",
                         SPLIT_CASES)
def test_split_merge_matches_plain(dtype, B, S, T, H, KH, hd, window,
                                   q_offset, kv_len, chunk):
    _, (tq, tk, tv) = _inputs(B * S + T + chunk, B, S, T, H, KH, hd, dtype)
    kw = dict(window=window, q_offset=q_offset, kv_len=kv_len)
    got = split_merge_plain(tq, tk, tv, chunk=chunk, **kw)
    want = flash_attention_plain(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype] and got.shape == want.shape
    assert torch.isfinite(got).all()
    _close(got, want.float().numpy(), dtype)
    if window == 0 or kv_len == 0:          # 0, not NaN
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("chunk", [3, 16, 64])
@pytest.mark.parametrize("B,S,T,H,KH,hd,window,q_offset",
                         [c for c in CASES if c[1] * c[3] // c[4] <= 16])
def test_split_merge_matches_pallas_interpret(chunk, B, S, T, H, KH, hd,
                                              window, q_offset):
    """The decode-shaped cases (S·G <= 16 rows per kv head) in bf16, where
    the kernel runs the split path."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(B + S + T, B, S, T, H, KH, hd,
                                         "bfloat16")
    jw = None if window is None else jnp.int32(window)
    want = pallas_fa(jq, jk, jv, causal=True, window=jw,
                     q_offset=jnp.int32(q_offset), block_q=16, block_k=16,
                     interpret=True)
    got = split_merge_plain(tq, tk, tv, chunk=chunk, window=window,
                            q_offset=q_offset)
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("owner", ["flash_attention", "another kernel"])
def test_workspace_is_one_per_stream(owner):
    """``library.workspace``, which keeps K7 decode's partials and tickets:
    two streams of one device get different buffers, one stream gets the
    same buffer back, and a buffer grows by being made anew, zero-filled.
    On the CPU any int names a stream."""
    dev = torch.device("cpu")
    need = dict(parts=(64, torch.uint8), tickets=(8, torch.int32))
    parts_a, tickets_a = library.workspace(owner, dev, 1001, **need)
    parts_b, tickets_b = library.workspace(owner, dev, 1002, **need)
    assert parts_a.data_ptr() != parts_b.data_ptr()
    assert tickets_a.data_ptr() != tickets_b.data_ptr()
    assert not tickets_a.any() and not parts_b.any()
    tickets_a[3] = 7              # a kernel in flight on stream 1001
    again = library.workspace(owner, dev, 1001, **need)
    assert again[0] is parts_a and again[1] is tickets_a
    assert int(library.workspace(owner, dev, 1002, **need)[1][3]) == 0
    grown = library.workspace(owner, dev, 1001, parts=(64, torch.uint8),
                              tickets=(16, torch.int32))[1]
    assert grown.numel() == 16 and not grown.any()
    assert grown.data_ptr() != tickets_a.data_ptr()
