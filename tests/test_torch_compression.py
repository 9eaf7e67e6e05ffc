"""``repro_torch.fl.compression`` and its kernels' plain versions against
the JAX package (``repro.fl.compression``), on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
The plain versions run here; the CUDA kernels are held against them on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:
  - the compressor (``compress_delta_plain`` with ``topk_threshold_plain``,
    and ``reference_compress``) and the threshold: BITWISE against
    ``numpy_compress``, the JAX package's threefry-free NumPy oracle,
    and against the Pallas kernel in interpret mode / the jnp search;
  - the aggregate against the JAX one: the compressed deltas and the EF
    residuals bitwise; the new params at the summand-relative tolerance
    of ``tests/test_torch_fused_update.py`` (rtol 1e-6 of |p| + Σ|w̄ₖcₖ|,
    + 1e-7): the Pallas ``weighted_delta`` in interpret mode may contract
    a multiply-add into an FMA (ROADMAP §3);
  - the port's tree form against its fused form: bitwise;
  - full P2 runs against the JAX package: params at atol 1e-4 as in
    ``tests/test_torch_pipeline.py`` (the local runs' conv/matmul
    reductions sum in another order); the EF residuals at the same
    atol, except that an element whose delta sits within that
    difference of a rounding edge (the top-k threshold or a quantization
    midpoint) may land on the other side: at most 0.1% of the elements
    may then differ, each by no more than one quantization step plus τ;
    ledger bytes exactly;
  - a bf16 bucket: its bound above plus one bf16 ulp of the result
    (2⁻⁷·|x|), since f32 sums that agree to it can round apart.
"""
import functools

import numpy as np
import pytest
import torch
from torch_parity import index_source, jax_engine_indices, jax_numpy_params

import jax
import jax.numpy as jnp
from repro.core import comm_accounting as jacc
from repro.data.federated import FederatedDataset as JFederatedDataset
from repro.fl import compression as jcomp
from repro.fl import engine as jengine
from repro.fl.local import FlatParamOps as JFlatParamOps
from repro.fl.local import LocalSpec as JLocalSpec
from repro.fl.privacy import DPSpec as JDPSpec
from repro.fl.simulation import FLConfig as JFLConfig
from repro.fl.task import vision_task as j_vision_task
from repro.kernels import ops as jops
from repro.utils.flatten import FlatView as JFlatView
from repro_torch import bridge
from repro_torch.core import comm_accounting as acc
from repro_torch.core.comm_accounting import CommLedger
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import compression as comp
from repro_torch.fl import engine
from repro_torch.fl.compression import CompressionSpec
from repro_torch.fl.local import FlatParamOps, LocalSpec
from repro_torch.fl.privacy import DPSpec
from repro_torch.fl.simulation import FLConfig
from repro_torch.fl.task import vision_task
from repro_torch.kernels import fused_update as fu
from repro_torch.utils.flatten import FlatView

SIZES = (1, 127, 128, 1000, 4099)
BITS = (8, 16, 32)
DENSITIES = (1.0, 0.25, 0.01)


def _delta(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=n) * scale).astype(np.float32)
    if n >= 256:
        d[128:256] = 0.0        # a whole zero row: the guarded division
    return d


def _port_compress(d: np.ndarray, spec, *, logical_size=None,
                   with_residual=True):
    t = torch.from_numpy(d.copy())
    tau = (fu.topk_threshold_plain(
        t, comp.topk_k(spec, logical_size or d.shape[-1]))
        if spec.sparsifies else None)
    return fu.compress_delta_plain(t, tau, bits=spec.bits,
                                   topk=spec.sparsifies,
                                   with_residual=with_residual)


def _jspec(spec):
    return jcomp.CompressionSpec(spec.bits, spec.density,
                                 spec.error_feedback)


# ---------------------------------------------------------------------------
# the compressor and the threshold, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("density", DENSITIES)
def test_plain_compressor_matches_numpy_oracle_bitwise(n, bits, density):
    spec = CompressionSpec(bits=bits, density=density)
    d = _delta(n, seed=n + bits)
    c_np, r_np = jcomp.numpy_compress(d, _jspec(spec))
    c, r = _port_compress(d, spec)
    np.testing.assert_array_equal(c.numpy(), c_np)
    np.testing.assert_array_equal(r.numpy(), r_np)
    c_only = _port_compress(d, spec, with_residual=False)
    np.testing.assert_array_equal(c_only.numpy(), c_np)
    c_ref, r_ref = comp.reference_compress(torch.from_numpy(d), spec)
    np.testing.assert_array_equal(c_ref.numpy(), c_np)
    np.testing.assert_array_equal(r_ref.numpy(), r_np)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("topk", [False, True])
def test_plain_compressor_matches_pallas_kernel_bitwise(n, bits, topk):
    """The Pallas kernel in interpret mode, called as the JAX package's
    FlatParamOps calls it (threshold outside, density 0.25)."""
    d = _delta(n, seed=7 * n + bits)
    k = comp.topk_k(CompressionSpec(density=0.25), n)
    jd = jnp.asarray(d)
    jtau = jcomp.topk_threshold(jd, k) if topk else jnp.float32(0.0)
    jc, jr = jops.fused_compress_delta(jd, jtau, bits=bits, topk=topk,
                                       with_residual=True, interpret=True)
    t = torch.from_numpy(d)
    tau = fu.topk_threshold_plain(t, k) if topk else None
    c, r = fu.compress_delta_plain(t, tau, bits=bits, topk=topk,
                                   with_residual=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    # the wrapper takes the plain version on a CPU tensor
    c2, r2 = fu.compress_delta(t, tau, bits=bits, topk=topk,
                               with_residual=True)
    assert torch.equal(c2, c) and torch.equal(r2, r)


def _threshold_cases():
    rng = np.random.default_rng(11)
    normal = rng.normal(size=777).astype(np.float32)
    ties = (rng.integers(-3, 4, size=500) / 4).astype(np.float32)
    zeros = np.zeros(300, np.float32)
    zeros[[3, 50, 299]] = [0.5, -2.0, 0.5]
    sub = (rng.normal(size=400) * 1e-39).astype(np.float32)   # subnormals
    sub[::7] = 0.0
    sub[5] = np.float32(1e-45)
    mixed = np.concatenate([sub[:100], normal[:100], -ties[:100]])
    cases = []
    for name, d in [("normal", normal), ("ties", ties), ("zeros", zeros),
                    ("subnormal", sub), ("mixed", mixed)]:
        n = d.shape[0]
        for k in sorted({1, 2, 3, n // 4, n // 2, n - 1, n}):
            cases.append(pytest.param(d, k, id=f"{name}-k{k}"))
    return cases


@pytest.mark.parametrize("d,k", _threshold_cases())
def test_topk_threshold_plain_matches_jax_bitwise(d, k):
    want = np.asarray(jcomp.topk_threshold(jnp.asarray(d), k))
    got = fu.topk_threshold_plain(torch.from_numpy(d), k)
    assert got.shape == () and got.dtype == torch.float32
    assert got.numpy().view(np.uint32) == want.view(np.uint32)
    a = np.abs(d)
    assert got.numpy() == np.partition(a, a.size - k)[a.size - k]
    assert torch.equal(comp.topk_threshold(torch.from_numpy(d), k), got)


def _cluster_input(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "ties":
        return (rng.integers(-3, 4, size=n) / 4).astype(np.float32)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    d = rng.normal(size=n).astype(np.float32)
    if kind == "subnormal":
        d = (d * 1e-39).astype(np.float32)
        d[::7] = 0.0
    return d


@functools.lru_cache(maxsize=None)
def _jax_threshold(kind: str, n: int, k: int) -> int:
    tau = np.asarray(jcomp.topk_threshold(jnp.asarray(_cluster_input(kind, n)),
                                          k))
    return int(tau.view(np.uint32))


@pytest.mark.parametrize("n_ctas", [1, 8, 16])
@pytest.mark.parametrize("n", [1, 127, 4099, 137_216])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "subnormal"])
def test_topk_cluster_plain_matches_jax_bitwise(kind, n, n_ctas):
    """The cluster kernel's arithmetic (slices, four 8-bit passes,
    per-slice histograms summed, the suffix scan) lands on the JAX
    package's threshold bit for bit, n a multiple of n_ctas or not."""
    d = torch.from_numpy(_cluster_input(kind, n))
    for k in sorted({1, max(1, n // 4), max(1, n // 2), n}):
        got = fu.topk_cluster_plain(d, k, n_ctas)
        assert got.shape == () and got.dtype == torch.float32
        assert int(got.view(torch.int32)) & 0xFFFFFFFF == \
            _jax_threshold(kind, n, k), (k, n_ctas)


def test_topk_slices_and_launches():
    """The cluster kernel's slices cover n in granules of 128 keys, the
    cut is the cluster's 16 CTAs × the largest slice, and a call launches
    once up to the cut and four times above it."""
    for n in (1, 127, 4099, 137_216, fu.topk_cut()):
        for c in (1, 8, 16):
            sl = fu.topk_slice(n, c)
            assert sl % fu.TOPK_SLICE_GRANULE == 0 and c * sl >= n
            assert c * (sl - fu.TOPK_SLICE_GRANULE) < n
    assert fu.topk_cut() == fu.TOPK_CLUSTER * fu.TOPK_SLICE_MAX == 655_360
    assert fu.topk_slice(fu.topk_cut()) == fu.TOPK_SLICE_MAX
    assert fu.topk_launches(137_216) == 1
    assert fu.topk_launches(fu.topk_cut()) == 1
    assert fu.topk_launches(fu.topk_cut() + 1) == fu.TOPK_RADIX_LAUNCHES
    assert fu.topk_launches(16_777_216) == 4
    with pytest.raises(ValueError):
        fu.topk_cluster_plain(torch.ones(4), 2, 0)
    with pytest.raises(ValueError):
        fu.topk_cluster_plain(torch.ones(4), 2, 17)


def test_cpu_tensors_never_count_upload_launches():
    fu.reset_launch_counts()
    g = torch.randn(300)
    tau = fu.topk_threshold(g, 4)
    fu.compress_delta(g, tau, bits=8, topk=True, with_residual=True)
    fu.topk_compress(g, 4, bits=8, with_residual=True)
    fu.dp_clip_noise(g, g, torch.tensor([1.0, 0.1]))
    assert fu.topk_compress in fu.UPLOAD_KERNELS
    assert [k.launches for k in fu.KERNELS + fu.UPLOAD_KERNELS] == [0] * 7


# ---------------------------------------------------------------------------
# the top-k compressed upload in one call (on the card one fused launch)
# ---------------------------------------------------------------------------

def _upload_input(n):
    d = _delta(n, seed=n + 11)          # a whole zero row from 128 on
    d[5] = -0.0
    return d


@functools.lru_cache(maxsize=None)
def _jax_topk_compress(n, bits):
    """The JAX package's threshold and its Pallas compress_delta in
    interpret mode, at density 0.25 with the residual."""
    jd = jnp.asarray(_upload_input(n))
    jtau = jcomp.topk_threshold(jd, comp.topk_k(CompressionSpec(density=0.25),
                                                n))
    jc, jr = jops.fused_compress_delta(jd, jtau, bits=bits, topk=True,
                                       with_residual=True, interpret=True)
    return np.asarray(jc), np.asarray(jr), np.asarray(jtau)


def _bits_of(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", [1000, 2048, 137_216])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("res", [False, True])
def test_topk_compress_plain_matches_jax_bitwise(n, bits, res):
    """``topk_compress_plain`` (the cluster threshold's arithmetic, then
    compress_delta's) against the JAX package's threshold + Pallas
    kernel: c, r and τ bit for bit (an all-zero row, a -0.0, a partial
    last row at 1,000, CTAs with empty slices at 1,000 and 2,048), and
    the wrapper on a CPU tensor takes it without counting a launch."""
    jc, jr, jtau = _jax_topk_compress(n, bits)
    d = torch.from_numpy(_upload_input(n))
    k = comp.topk_k(CompressionSpec(density=0.25), n)
    c, r, tau = fu.topk_compress_plain(d, k, bits=bits, with_residual=res)
    np.testing.assert_array_equal(_bits_of(c), _bits_of(jc))
    assert tau.shape == () and _bits_of(tau) == _bits_of(jtau)
    if res:
        np.testing.assert_array_equal(_bits_of(r), _bits_of(jr))
    else:
        assert r is None
    before = fu.topk_compress.launches
    c2, r2, tau2 = fu.topk_compress(d, k, bits=bits, with_residual=res)
    assert fu.topk_compress.launches == before
    assert torch.equal(c2, c) and torch.equal(tau2, tau)
    assert (r2 is None) if not res else torch.equal(r2, r)


@pytest.mark.parametrize("spec,fused", [
    (CompressionSpec(bits=8, density=0.25, error_feedback=True), True),
    (CompressionSpec(bits=32, density=0.5), True),
    (CompressionSpec(bits=16), False),
    (CompressionSpec(bits=8, error_feedback=True), False)])
def test_flat_ops_send_topk_uploads_through_one_call(monkeypatch, spec,
                                                      fused):
    """FlatParamOps.compress_delta makes one ``fused_topk_compress``
    call per bucket when it sparsifies and one ``fused_compress_delta``
    call when it only quantizes; the result equals numpy_compress."""
    from repro_torch.kernels import ops
    calls = []
    for name in ("fused_topk_compress", "fused_compress_delta",
                 "fused_topk_threshold"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    n = 700
    d = _delta(n, seed=5)
    view = FlatView.of({"w": torch.zeros(n)})
    fops = FlatParamOps(view=view, interpret=False, device=torch.device("cpu"))
    c, r = fops.compress_delta(fops.pad({"float32": torch.from_numpy(d)}),
                               spec)
    assert calls == ["fused_topk_compress" if fused else
                     "fused_compress_delta"]
    c_np, r_np = jcomp.numpy_compress(d, _jspec(spec))
    np.testing.assert_array_equal(c["float32"][:n].numpy(), c_np)
    if spec.error_feedback:
        np.testing.assert_array_equal(r["float32"][:n].numpy(), r_np)
    else:
        assert r is None


@pytest.mark.parametrize("kw,err", [
    (dict(k=0, bits=8), ValueError), (dict(k=301, bits=8), ValueError),
    (dict(k=4, bits=4), ValueError)])
def test_topk_compress_rejects_bad_arguments(kw, err):
    with pytest.raises(err):
        fu.topk_compress(torch.ones(300), kw["k"], bits=kw["bits"])
    with pytest.raises(TypeError):
        fu.topk_compress(torch.ones(300, dtype=torch.float64), 4, bits=8)


def test_topk_threshold_rejects_bad_k():
    t = torch.ones(10)
    for k in (0, 11):
        with pytest.raises(ValueError):
            fu.topk_threshold(t, k)


def test_zero_delta_compresses_to_zero():
    for spec in (CompressionSpec(bits=8), CompressionSpec(density=0.5),
                 CompressionSpec(bits=16, density=0.5)):
        c, r = _port_compress(np.zeros(300, np.float32), spec)
        assert not c.any() and not r.any()
        c_np, _ = jcomp.numpy_compress(np.zeros(300, np.float32),
                                       _jspec(spec))
        np.testing.assert_array_equal(c.numpy(), c_np)


def test_padded_buffer_with_logical_k_is_exact():
    """FlatParamOps.compress_delta over a GRID_ALIGN-padded bucket with
    the logical k equals numpy_compress of the logical prefix."""
    spec = CompressionSpec(bits=8, density=0.5, error_feedback=True)
    n = 700
    d = _delta(n, seed=3)
    view = FlatView.of({"w": torch.zeros(n)})
    fops = FlatParamOps(view=view, interpret=False, device=torch.device("cpu"))
    padded = fops.pad({"float32": torch.from_numpy(d)})
    assert padded["float32"].shape[0] == fu.GRID_ALIGN
    c, r = fops.compress_delta(padded, spec)
    c_np, r_np = jcomp.numpy_compress(d, _jspec(spec))
    np.testing.assert_array_equal(c["float32"][:n].numpy(), c_np)
    np.testing.assert_array_equal(r["float32"][:n].numpy(), r_np)
    assert not c["float32"][n:].any() and not r["float32"][n:].any()


# ---------------------------------------------------------------------------
# specs, validation and wire accounting
# ---------------------------------------------------------------------------

def _same_error(port_fn, jax_fn):
    with pytest.raises(ValueError) as pe:
        port_fn()
    with pytest.raises(ValueError) as je:
        jax_fn()
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("kw", [dict(bits=7), dict(density=0.0),
                                dict(density=-0.1), dict(density=1.5),
                                dict(error_feedback=True)],
                         ids=["bits7", "density0", "density-", "density1.5",
                              "ef-identity"])
def test_spec_rejects_like_jax(kw):
    _same_error(lambda: CompressionSpec(**kw),
                lambda: jcomp.CompressionSpec(**kw))


@pytest.mark.parametrize("case", ["secure_agg", "dp"])
def test_lossy_combinations_rejected_like_jax(case):
    spec, jspec = CompressionSpec(bits=8), jcomp.CompressionSpec(bits=8)
    if case == "secure_agg":
        kw, jkw = dict(secure_agg=True), dict(secure_agg=True)
    else:
        kw, jkw = dict(dp=DPSpec(1.0, 0.1)), dict(dp=JDPSpec(1.0, 0.1))
    _same_error(lambda: FLConfig(compression=spec, **kw),
                lambda: JFLConfig(compression=jspec, **jkw))
    _same_error(lambda: LocalSpec(2, 4, 0.1, compression=spec, **kw),
                lambda: JLocalSpec(2, 4, 0.1, compression=jspec, **jkw))


def test_relay_rejects_lossy_compression_like_jax():
    _same_error(
        lambda: engine.RelayStrategy(spec=LocalSpec(
            2, 4, 0.1, compression=CompressionSpec(bits=8))),
        lambda: jengine.RelayStrategy(spec=JLocalSpec(
            2, 4, 0.1, compression=jcomp.CompressionSpec(bits=8))))


def test_identity_spec_is_off():
    assert not comp.compression_on(None)
    assert not comp.compression_on(CompressionSpec())
    assert comp.compression_on(CompressionSpec(density=0.5))


@pytest.mark.parametrize("spec", [
    None, CompressionSpec(), CompressionSpec(bits=8), CompressionSpec(bits=16),
    CompressionSpec(density=0.25), CompressionSpec(8, 0.25, True),
    CompressionSpec(16, 0.01)], ids=str)
def test_payload_bytes_match_jax(spec):
    jspec = None if spec is None else _jspec(spec)
    for sizes in [(136_886,), (1, 127, 128, 129), (5000, 0, 77)]:
        assert comp.payload_bytes(spec, sizes) == \
            jcomp.payload_bytes(jspec, sizes)
        assert comp.payload_ratio(spec, sizes) == \
            jcomp.payload_ratio(jspec, sizes)
    assert comp.topk_k(CompressionSpec(density=0.25), 136_886) == 34_222


def test_lenet5_upload_payload():
    """The chip run's compressed cell: 173,250 bytes per client against
    547,544 uncompressed (136,886 f32 params)."""
    spec = CompressionSpec(8, 0.25, True)
    task = vision_task("lenet5", n_classes=10, in_ch=3)
    assert engine._upload_payload_bytes(task, spec) == 173_250
    assert engine._upload_payload_bytes(task, None) == 547_544
    assert round(comp.payload_ratio(spec, (136_886,)), 3) == 3.160


# ---------------------------------------------------------------------------
# the aggregates
# ---------------------------------------------------------------------------

def _agg_inputs(K=3, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"b": (50,), "w": (37, 50)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    wl = {k: (p[k][None] + 0.05 * rng.normal(size=(K,) + s)).astype(
        np.float32) for k, s in shapes.items()}
    weights = rng.integers(1, 9, size=K).astype(np.float32)
    return p, wl, weights


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            tree.items()}


@pytest.mark.parametrize("spec", [
    CompressionSpec(bits=8), CompressionSpec(density=0.25),
    CompressionSpec(8, 0.25, True), CompressionSpec(16, 0.5, True)],
    ids=["int8", "topk", "int8+topk+ef", "int16+topk+ef"])
def test_fused_compressed_aggregate_matches_jax(spec):
    p, wl, weights = _agg_inputs()
    K = weights.shape[0]
    rng = np.random.default_rng(5)
    jview = JFlatView.of(jax.tree_util.tree_map(jnp.asarray, p))
    jfops = JFlatParamOps(view=jview, interpret=True)
    jp = jfops.pad(jview.flatten(jax.tree_util.tree_map(jnp.asarray, p)))
    jwl = jfops.pad(jview.flatten_stacked(
        jax.tree_util.tree_map(jnp.asarray, wl)))
    n = jview.buffer_sizes["float32"]
    res = None
    if spec.error_feedback:
        r0 = np.zeros((K, jp["float32"].shape[0]), np.float32)
        r0[:, :n] = 0.01 * rng.normal(size=(K, n))
        res = {"float32": r0}
    jnew, jr = jcomp.fused_compressed_aggregate(
        _jspec(spec), jfops, jp, jwl, jnp.asarray(weights),
        None if res is None else {"float32": jnp.asarray(res["float32"])})

    view = FlatView.of(_t(p))
    fops = FlatParamOps(view=view, interpret=False, device=torch.device("cpu"))
    tp = fops.pad(view.flatten(_t(p)))
    twl = {"float32": torch.from_numpy(np.array(jwl["float32"]))}
    tres = None if res is None else {"float32": torch.from_numpy(
        res["float32"])}
    new, r = comp.fused_compressed_aggregate(
        spec, fops, tp, twl, torch.from_numpy(weights), tres)

    # the compressed deltas the aggregate sums, and their magnitude
    wbar = weights / weights.sum()
    mag = np.abs(np.asarray(jp["float32"]))
    for k in range(K):
        d = np.asarray(jwl["float32"][k]) - np.asarray(jp["float32"])
        if res is not None:
            d = d + res["float32"][k]
        c_k, _ = jcomp.numpy_compress(d[:n], _jspec(spec))
        mag[:n] += np.abs(np.float32(wbar[k]) * c_k)
    got, want = new["float32"].numpy(), np.asarray(jnew["float32"])
    bad = np.abs(got - want) > 1e-6 * mag + 1e-7
    assert not bad.any(), np.abs(got - want)[bad].max()
    if spec.error_feedback:
        np.testing.assert_array_equal(r["float32"].numpy(),
                                      np.asarray(jr["float32"]))
    else:
        assert r is None and jr is None


@pytest.mark.parametrize("spec", [
    CompressionSpec(bits=8), CompressionSpec(density=0.5),
    CompressionSpec(bits=8, density=0.5, error_feedback=True)],
    ids=["int8", "topk", "int8+topk+ef"])
def test_tree_aggregate_equals_fused_bitwise(spec):
    p, wl, weights = _agg_inputs(K=4, seed=2)
    view = FlatView.of(_t(p))
    fops = FlatParamOps(view=view, interpret=False, device=torch.device("cpu"))
    n = view.buffer_sizes["float32"]
    res_l = torch.from_numpy(
        0.01 * np.random.default_rng(1).normal(size=(4, n)).astype(np.float32))
    res_p = torch.zeros((4, fops.padded_sizes["float32"]))
    res_p[:, :n] = res_l
    ef = spec.error_feedback
    tree_p, tree_r = comp.tree_compressed_aggregate(
        spec, view, _t(p), _t(wl), torch.from_numpy(weights),
        {"float32": res_l} if ef else None)
    fused_p, fused_r = comp.fused_compressed_aggregate(
        spec, fops, fops.pad(view.flatten(_t(p))),
        fops.pad(view.flatten_stacked(_t(wl))), torch.from_numpy(weights),
        {"float32": res_p} if ef else None)
    fused_tree = fops.unflatten(fused_p)
    for k in p:
        assert torch.equal(tree_p[k], fused_tree[k])
    if ef:
        assert torch.equal(tree_r["float32"], fused_r["float32"][:, :n])
        assert not fused_r["float32"][:, n:].any()


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 values, kept as f32 (exact in both packages)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("spec", [
    CompressionSpec(8, 0.25, True), CompressionSpec(16, 0.5, True)],
    ids=["int8+topk+ef", "int16+topk+ef"])
def test_bf16_params_compressed_aggregate_matches_jax(spec):
    """Params with a bf16 bucket beside the f32 one: the f32 compressed
    deltas aggregate over the bf16 buffer (K2 takes an f32 stack when
    ``deltas=True``), as the JAX kernel does.  Tolerances: the EF
    residuals bitwise; the f32 bucket at the summand-relative rtol 1e-6
    of the test above; the bf16 bucket at that bound plus one bf16 ulp
    (2⁻⁷·|x|: f32 sums that agree to 1e-6 can round to neighbouring
    bf16 values).  The port's tree form equals its fused form bitwise."""
    p, wl, weights = _agg_inputs(K=3, seed=4)
    p["w"], wl["w"] = _bf16(p["w"]), _bf16(wl["w"])
    K = weights.shape[0]
    jtree = {"b": jnp.asarray(p["b"]), "w": jnp.asarray(p["w"], jnp.bfloat16)}
    jstack = {"b": jnp.asarray(wl["b"]),
              "w": jnp.asarray(wl["w"], jnp.bfloat16)}
    jview = JFlatView.of(jtree)
    jfops = JFlatParamOps(view=jview, interpret=True)
    jp = jfops.pad(jview.flatten(jtree))
    jwl = jfops.pad(jview.flatten_stacked(jstack))
    assert sorted(jp) == ["bfloat16", "float32"]
    rng = np.random.default_rng(6)
    res = {}
    for name, buf in jp.items():
        n = jview.buffer_sizes[name]
        res[name] = np.zeros((K, buf.shape[0]), np.float32)
        res[name][:, :n] = 0.01 * rng.normal(size=(K, n))
    jnew, jr = jcomp.fused_compressed_aggregate(
        _jspec(spec), jfops, jp, jwl, jnp.asarray(weights),
        {k: jnp.asarray(v) for k, v in res.items()})

    def to_t(x, name):
        t = torch.from_numpy(np.array(x, np.float32))
        return t.bfloat16() if name == "bfloat16" else t
    ttree = {"b": torch.from_numpy(p["b"]),
             "w": torch.from_numpy(p["w"]).bfloat16()}
    tstack = {"b": torch.from_numpy(wl["b"]),
              "w": torch.from_numpy(wl["w"]).bfloat16()}
    view = FlatView.of(ttree)
    fops = FlatParamOps(view=view, interpret=False, device=torch.device("cpu"))
    tp = fops.pad(view.flatten(ttree))
    twl = fops.pad(view.flatten_stacked(tstack))
    for name in jp:
        assert torch.equal(tp[name], to_t(jp[name], name))
        assert torch.equal(twl[name], to_t(jwl[name], name))
    new, r = comp.fused_compressed_aggregate(
        spec, fops, tp, twl, torch.from_numpy(weights),
        {k: torch.from_numpy(v) for k, v in res.items()})

    wbar = weights / weights.sum()
    for name in jp:
        n = jview.buffer_sizes[name]
        p32 = np.asarray(jp[name], np.float32)
        mag = np.abs(p32)
        for k in range(K):
            d = np.asarray(jwl[name][k], np.float32) - p32 + res[name][k]
            c_k, _ = jcomp.numpy_compress(d[:n], _jspec(spec))
            mag[:n] += np.abs(np.float32(wbar[k]) * c_k)
        assert new[name].dtype == tp[name].dtype
        got = new[name].float().numpy()
        want = np.asarray(jnew[name], np.float32)
        bound = 1e-6 * mag + 1e-7
        if name == "bfloat16":
            bound = bound + 2.0 ** -7 * np.abs(want)
        bad = np.abs(got - want) > bound
        assert not bad.any(), np.abs(got - want)[bad].max()
        np.testing.assert_array_equal(r[name].numpy(), np.asarray(jr[name]))

    tree_p, tree_r = comp.tree_compressed_aggregate(
        spec, view, ttree, tstack, torch.from_numpy(weights),
        {k: torch.from_numpy(v[:, :view.buffer_sizes[k]])
         for k, v in res.items()})
    fused_tree = fops.unflatten(new)
    for k in ttree:
        assert tree_p[k].dtype == ttree[k].dtype
        assert torch.equal(tree_p[k], fused_tree[k])
    for name, n in view.buffer_sizes.items():
        assert torch.equal(tree_r[name], r[name][:, :n])


# ---------------------------------------------------------------------------
# full P2 runs against the JAX package
# ---------------------------------------------------------------------------

SEED = 0
N_CLIENTS, PER, STEPS, BATCH, ROUNDS = 8, 16, 2, 8, 2
MLP_KW = {"img": 8, "d_hidden": 16}


@pytest.fixture(scope="module")
def run_setup():
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(N_CLIENTS, PER, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(N_CLIENTS, PER)).astype(np.int32)
    common = dict(x=x, y=y, n_real=np.full((N_CLIENTS,), PER, np.int32),
                  test_x=x[0], test_y=y[0], n_classes=10)
    jtask = j_vision_task("mlp", in_ch=1, seed_kwargs=MLP_KW)
    ttask = vision_task("mlp", in_ch=1, seed_kwargs=MLP_KW)
    init = jtask.init(jax.random.PRNGKey(SEED))
    return (jtask, JFederatedDataset(**common), ttask,
            FederatedDataset(**common), init)


def _runs(run_setup, spec, impl="fused"):
    """One P2 phase (ROUNDS rounds, 4 of 8 clients) in each package from
    the same init, with the JAX engine's batch indices injected."""
    jtask, jdata, ttask, tdata, init = run_setup
    sched = dict(rounds=ROUNDS, eval_every=0, seed=SEED, chunk_size=1,
                 sampling="host", host_rng_offset=17)
    jstrat = jengine.AggregateStrategy(
        spec=JLocalSpec(STEPS, BATCH, 0.05, update_impl="fused_interpret",
                        compression=_jspec(spec)), participation=0.5)
    jledger = jacc.CommLedger()
    jres = jengine.run_rounds(jtask, jdata, jstrat,
                              jengine.RoundSchedule(**sched),
                              init_params=init, ledger=jledger)
    idx = jax_engine_indices(SEED, ROUNDS, 4, STEPS, BATCH, PER)
    tstrat = engine.AggregateStrategy(
        spec=LocalSpec(STEPS, BATCH, 0.05, update_impl=impl,
                       compression=spec), participation=0.5)
    ledger = CommLedger()
    tres = engine.run_rounds(
        ttask, tdata, tstrat, engine.RoundSchedule(
            **sched, batch_indices=index_source(idx)),
        init_params=bridge.params_from_numpy(jax_numpy_params(init)),
        ledger=ledger, device="cpu")
    return jres, jledger, tres, ledger


@pytest.mark.parametrize("impl", ["fused", "tree"])
def test_compressed_ef_run_matches_jax(run_setup, impl):
    spec = CompressionSpec(8, 0.25, True)
    jres, jledger, tres, ledger = _runs(run_setup, spec, impl)
    for a, b in zip(jax.tree_util.tree_leaves(jres.params),
                    torch_leaves(tres.params)):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=1e-4,
                                   rtol=0)
    np.testing.assert_allclose([h["local_loss"] for h in tres.history],
                               [h["local_loss"] for h in jres.history],
                               rtol=1e-4)
    jr = np.asarray(jres.algo_state["ef_residuals"]["float32"])
    tr = tres.algo_state["ef_residuals"]["float32"].numpy()
    n = jr.shape[1] if impl == "fused" else tr.shape[1]
    jr, tr = jr[:, :n], tr[:, :n]
    assert tr.shape == jr.shape and tr.shape[0] == N_CLIENTS
    off = np.abs(tr - jr) > 1e-4
    # rounding-edge flips (module docstring): rare and bounded by one
    # quantization step plus τ; both are below 2·max|r| here
    assert off.sum() <= max(1, tr.size // 1000), int(off.sum())
    assert np.all(np.abs(tr - jr)[off] <= 2 * np.abs(jr).max())
    assert np.any(jr != 0)
    # ledger: equal to the JAX ledger and to the closed form, exactly
    assert ledger.summary() == jledger.summary()
    x = acc.model_bytes(tres.params)
    payload = engine._upload_payload_bytes(run_setup[2], spec)
    assert ledger.total_bytes == ROUNDS * acc.compressed_round_bytes(
        "fedavg", 4, x, payload)


def torch_leaves(tree):
    from repro_torch.utils.tree_math import tree_leaves
    return [t.detach().float().numpy() for t in tree_leaves(tree)]


def test_ef_residuals_ride_the_dense_store(run_setup):
    """Residual rows of clients that were never selected stay zero;
    the selected ones carry δ − c."""
    spec = CompressionSpec(8, 0.25, True)
    _, _, tres, _ = _runs(run_setup, spec)
    rows = tres.algo_state["ef_residuals"]["float32"]
    touched = rows.abs().sum(dim=1) > 0
    assert 1 <= int(touched.sum()) <= min(N_CLIENTS, 4 * ROUNDS)
    assert isinstance(engine.AggregateStrategy(
        spec=LocalSpec(2, 4, 0.1)).state_store, engine.DenseClientStateStore)
    with pytest.raises(ValueError, match="state_store"):
        engine.AggregateStrategy(spec=LocalSpec(2, 4, 0.1),
                                 state_store=object())
