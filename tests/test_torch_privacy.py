"""``repro_torch.fl.privacy`` (DP-FedAvg, secure-aggregation masks) and
the ``dp_clip_noise`` plain version against the JAX package
(``repro.fl.privacy``), on the CPU.

The two packages draw their noise from different generators (threefry
folds there, seeded ``torch.Generator``s here), so parity with the JAX
package runs on the JAX package's draws, injected through the port's
``normal_fn`` / ``RoundSchedule.noise_draws`` hooks; the port's own
draws are checked for their statistics and their bitwise symmetries.

Tolerances:
  - ``dp_clip_noise_plain`` against the Pallas kernel in interpret
    mode: bitwise without noise; with noise within one ulp of the
    result (XLA contracts ``cs·d + ns·z`` into an FMA there), while the
    plain version is bitwise a numpy f32 sequence of the same steps;
  - the aggregates against the JAX ones: rtol 1e-6 of the summands'
    magnitude (|p| + Σₖ|coeffₖ·δₖ| + Σᵢ(|w̄ᵢσC·zᵢ| + Σⱼ|z_ij|)) + 1e-7, as
    in ``tests/test_torch_fused_update.py``: the Pallas ``weighted_delta``
    in interpret mode may contract a multiply-add, and the JAX package
    sums the masks inside a scan XLA may reassociate (ROADMAP §3); the
    tree form's ``tensordot`` sums the clients in another order;
  - the materialized upload (``dp_clip_noise`` per client) against the
    folded aggregate: rtol 1e-5 of the same magnitude (it associates
    ``w̄ₖ·(scaleₖ·δₖ + σC·zₖ)`` where the folded form has
    ``(w̄ₖ·scaleₖ)·δₖ + w̄ₖ·σC·zₖ``);
  - full P2 runs against the JAX package: params atol 1e-4, as in
    ``tests/test_torch_pipeline.py``; ledger bytes exactly;
  - masked against unmasked runs: atol 1e-5 (the masks cancel up to
    f32 reassociation of O(K) unit-variance terms);
  - a bf16 bucket: its bound above plus one bf16 ulp of the result
    (2⁻⁷·|x|), since f32 sums that agree to it can round apart.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch_parity import (index_source, jax_draw, jax_engine_indices,
                          jax_noise_draws, jax_numpy_params)

import jax
import jax.numpy as jnp
from repro.core import comm_accounting as jacc
from repro.data.federated import FederatedDataset as JFederatedDataset
from repro.fl import engine as jengine
from repro.fl import privacy as jpriv
from repro.fl.local import FlatParamOps as JFlatParamOps
from repro.fl.local import LocalSpec as JLocalSpec
from repro.fl.task import vision_task as j_vision_task
from repro.kernels import fused_update as jfu
from repro.utils.flatten import FlatView as JFlatView
from repro_torch import bridge
from repro_torch.core import comm_accounting as acc
from repro_torch.core.comm_accounting import CommLedger
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import engine, privacy
from repro_torch.fl.local import FlatParamOps, LocalSpec, host_flat_ops
from repro_torch.fl.privacy import DPSpec
from repro_torch.fl.simulation import FLConfig, run_federated
from repro_torch.fl.task import vision_task
from repro_torch.kernels import fused_update as fu
from repro_torch.utils.flatten import FlatView
from repro_torch.utils.tree_math import tree_leaves

CPU = torch.device("cpu")


def _same_error(port_fn, jax_fn):
    with pytest.raises(ValueError) as pe:
        port_fn()
    with pytest.raises(ValueError) as je:
        jax_fn()
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("args", [(0.0,), (-1.0,), (1.0, -0.5),
                                  (math.inf, 0.1)], ids=str)
def test_dpspec_rejects_like_jax(args):
    _same_error(lambda: DPSpec(*args), lambda: jpriv.DPSpec(*args))


def test_dpspec_switches():
    assert DPSpec(1.0, 0.1).clips and DPSpec(1.0, 0.1).noised
    assert not DPSpec(math.inf, 0.0).clips
    assert not privacy.privacy_on(None, False)
    assert privacy.privacy_on(None, True)


@pytest.mark.parametrize("kw", ["dp", "secure_agg"])
def test_relay_rejects_privacy_like_jax(kw):
    tkw = {"dp": DPSpec(1.0)} if kw == "dp" else {"secure_agg": True}
    jkw = {"dp": jpriv.DPSpec(1.0)} if kw == "dp" else {"secure_agg": True}
    _same_error(lambda: engine.RelayStrategy(spec=LocalSpec(2, 4, 0.1, **tkw)),
                lambda: jengine.RelayStrategy(spec=JLocalSpec(2, 4, 0.1,
                                                              **jkw)))


# ---------------------------------------------------------------------------
# dp_clip_noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 1000, 4096])
@pytest.mark.parametrize("has_z", [False, True])
def test_dp_clip_noise_plain_matches_pallas(n, has_z):
    rng = np.random.default_rng(n)
    d = rng.normal(size=n).astype(np.float32)
    z = rng.normal(size=n).astype(np.float32) if has_z else None
    want = jfu.dp_clip_noise(jnp.asarray(d),
                             None if z is None else jnp.asarray(z),
                             jnp.float32(0.37), jnp.float32(0.11),
                             interpret=True)
    sc = torch.tensor([0.37, 0.11])
    tz = None if z is None else torch.from_numpy(z)
    got = fu.dp_clip_noise_plain(torch.from_numpy(d), tz, sc)
    # the plain version rounds each step, like a numpy f32 sequence
    seq = np.float32(0.37) * d
    if z is not None:
        seq = seq + np.float32(0.11) * z
    np.testing.assert_array_equal(got.numpy(), seq)
    if z is None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        # XLA contracts cs·d + ns·z into one FMA in interpret mode: one
        # rounding where the plain version (and the CUDA kernel) round
        # twice, so the two may differ by an ulp of the result
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2.0 ** -23, atol=1e-7)
    assert torch.equal(fu.dp_clip_noise(torch.from_numpy(d), tz, sc), got)


def _per_client_uploads(w, p, z, scales, noise_scale):
    """The chain the rows form replaces: per client the torch
    subtraction, then one ``dp_clip_noise`` (its plain version here),
    then the stack."""
    return torch.stack([
        fu.dp_clip_noise(w[k].float() - p.float(),
                         None if z is None else z[k],
                         torch.stack([scales[k], noise_scale.reshape(())]))
        for k in range(w.shape[0])])


@pytest.mark.parametrize("K", [1, 3, 10])
@pytest.mark.parametrize("has_z", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_clip_noise_rows_plain_matches_pallas(K, has_z, dtype):
    """The rows form (all K uploads of a round in one pass) against the
    Pallas ``dp_clip_noise`` in interpret mode row by row on
    ``w[k]₃₂ − p₃₂`` (bitwise without noise; within an ulp with it, as
    above: XLA contracts cs·d + ns·z), and bitwise against the
    per-client chain it replaces."""
    n = 1000
    rng = np.random.default_rng(100 + K)
    p = rng.normal(size=n).astype(np.float32)
    w = (p[None] + 0.05 * rng.normal(size=(K, n))).astype(np.float32)
    z = rng.normal(size=(K, n)).astype(np.float32) if has_z else None
    scales = rng.uniform(0.2, 1.0, size=K).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tw, tp = torch.from_numpy(w).to(tdt), torch.from_numpy(p).to(tdt)
    tz = None if z is None else torch.from_numpy(z)
    ts, tns = torch.from_numpy(scales), torch.tensor([0.11])
    got = fu.dp_clip_noise_rows(tw, tp, tz, ts, tns)
    assert got.shape == (K, n) and got.dtype == torch.float32
    assert torch.equal(got, fu.dp_clip_noise_rows_plain(tw, tp, tz, ts, tns))
    assert torch.equal(got, _per_client_uploads(tw, tp, tz, ts, tns))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jw, jp = jnp.asarray(w, jdt), jnp.asarray(p, jdt)
    for k in range(K):
        d = jw[k].astype(jnp.float32) - jp.astype(jnp.float32)
        want = np.asarray(jfu.dp_clip_noise(
            d, None if z is None else jnp.asarray(z[k]),
            jnp.float32(scales[k]), jnp.float32(0.11), interpret=True))
        if z is None:
            np.testing.assert_array_equal(got[k].numpy(), want)
        else:
            np.testing.assert_allclose(got[k].numpy(), want,
                                       rtol=2.0 ** -23, atol=1e-7)


@pytest.mark.parametrize("bad", ["scales_len", "z_shape", "z_dtype",
                                 "w_dtype", "w_shape", "noise_scale"])
def test_dp_clip_noise_rows_rejects_bad_arguments(bad):
    K, n = 3, 16
    w = torch.zeros(K, n, dtype=torch.bfloat16 if bad == "w_dtype"
                    else torch.float32)
    if bad == "w_shape":
        w = torch.zeros(K, n + 1)
    z = {"z_shape": torch.zeros(K, n - 1),
         "z_dtype": torch.zeros(K, n, dtype=torch.float64)}.get(
        bad, torch.zeros(K, n))
    scales = torch.ones(K + 1 if bad == "scales_len" else K)
    ns = torch.ones(2 if bad == "noise_scale" else 1)
    with pytest.raises((TypeError, ValueError)):
        fu.dp_clip_noise_rows(w, torch.zeros(n), z, scales, ns)


# ---------------------------------------------------------------------------
# the port's draws
# ---------------------------------------------------------------------------

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"conv": {"w": torch.randn(3, 3, 2, 4, generator=g),
                     "b": torch.randn(4, generator=g)},
            "dense": torch.randn(37, 5, generator=g),
            "step": torch.zeros(2, dtype=torch.int32)}


def test_flat_normal_matches_tree_normal_bitwise():
    tree = _tree()
    view = FlatView.of(tree)
    flat = view.normal(1234)
    as_tree = view.unflatten(flat)
    twin = privacy.tree_normal(1234, tree)
    for a, b in zip(tree_leaves(as_tree), tree_leaves(twin)):
        assert torch.equal(a.float(), b)
    assert not twin["step"].any()
    assert not torch.equal(twin["dense"], privacy.tree_normal(1235,
                                                              tree)["dense"])
    fops = FlatParamOps(view=view, interpret=False, device=CPU)
    padded = fops.normal(1234)
    n = view.buffer_sizes["float32"]
    assert torch.equal(padded["float32"][:n], flat["float32"])
    assert not padded["float32"][n:].any()


def test_pair_masks_antisymmetric_bitwise():
    ids = [5, 1, 3, 2]
    tree = {"w": torch.zeros(64)}
    normal_fn = privacy.keyed_normal_fn(
        99, lambda key: privacy.tree_normal(key, tree))
    for i in ids:
        for j in ids:
            if i == j:
                assert privacy.pair_sign(i, j) == 0.0
                continue
            zi = normal_fn("mask", min(i, j), max(i, j))["w"]
            zj = normal_fn("mask", min(j, i), max(j, i))["w"]
            m_ij = privacy.pair_sign(i, j) * zi
            m_ji = privacy.pair_sign(j, i) * zj
            assert torch.equal(m_ij, -m_ji)
    assert privacy.draw_key(99, "mask", 1, 3) != \
        privacy.draw_key(99, "dp", 1, 3)


@pytest.mark.parametrize("flat", [False, True])
def test_masks_telescope_to_zero(flat):
    ids = [7, 0, 3, 12, 5]
    tree = {"a": torch.zeros(300), "b": torch.zeros(10, 10)}
    view = FlatView.of(tree)
    fops = FlatParamOps(view=view, interpret=False, device=CPU)
    if flat:
        zeros_fn, draw = (lambda: fops.zeros(torch.float32)), fops.normal
    else:
        zeros_fn = lambda: {k: torch.zeros_like(v) for k, v in tree.items()}  # noqa: E731
        draw = lambda key: privacy.tree_normal(key, tree)  # noqa: E731
    normal_fn = privacy.keyed_normal_fn(5, draw)
    total = zeros_fn()
    for cid in ids:
        m = privacy.client_mask(cid, ids, normal_fn, zeros_fn)
        total = {k: total[k] + m[k] for k in total}
        assert max(float(v.abs().max()) for v in m.values()) > 0.1
    for v in total.values():
        assert float(v.abs().max()) < 1e-5


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_noise_variance_sigma2_c2_over_k(impl):
    sigma, clip, K, n = 1.0, 0.1, 8, 1 << 17
    dp = DPSpec(clip, sigma)
    params = {"w": torch.zeros(n)}
    w_locals = {"w": torch.zeros(K, n)}              # δᵢ = 0
    weights, ids = torch.ones(K), list(range(K))
    if impl == "tree":
        normal_fn = privacy.keyed_normal_fn(
            123, lambda key: privacy.tree_normal(key, params))
        new_p = privacy.tree_dp_aggregate(dp, False, ids, params, w_locals,
                                          weights, normal_fn)
    else:
        view = FlatView.of(params)
        fops = FlatParamOps(view=view, interpret=False, device=CPU)
        new_p = fops.unflatten(privacy.fused_dp_aggregate(
            dp, False, fops, ids, fops.pad(view.flatten(params)),
            fops.pad(view.flatten_stacked(w_locals)), weights,
            privacy.keyed_normal_fn(123, fops.normal)))
    noise = new_p["w"].double().numpy()
    want_var = sigma ** 2 * clip ** 2 / K
    # the sample variance's standard error is var·sqrt(2/n) ≈ 0.4%: the
    # 5% bound is ~13 standard errors at a fixed seed
    assert abs(np.var(noise) / want_var - 1.0) < 0.05, np.var(noise)
    assert abs(noise.mean()) < 5e-4


def test_fused_and_tree_noise_bits_identical():
    sigma, clip, K, n = 0.7, 0.2, 4, 4096
    dp = DPSpec(clip, sigma)
    params = {"w": torch.zeros(n)}
    w_locals = {"w": torch.zeros(K, n)}
    weights, ids = torch.tensor([1.0, 2.0, 3.0, 4.0]), [5, 1, 3, 2]
    tree_p = privacy.tree_dp_aggregate(
        dp, True, ids, params, w_locals, weights,
        privacy.keyed_normal_fn(9, lambda k: privacy.tree_normal(k, params)))
    view = FlatView.of(params)
    fops = FlatParamOps(view=view, interpret=False, device=CPU)
    fused_p = fops.unflatten(privacy.fused_dp_aggregate(
        dp, True, fops, ids, fops.pad(view.flatten(params)),
        fops.pad(view.flatten_stacked(w_locals)), weights,
        privacy.keyed_normal_fn(9, fops.normal)))
    assert torch.equal(tree_p["w"], fused_p["w"])


# ---------------------------------------------------------------------------
# the aggregates against the JAX package, on its draws
# ---------------------------------------------------------------------------

SPECS = [(DPSpec(0.5, 0.3), False), (DPSpec(0.5, 0.0), False),
         (DPSpec(0.5, 0.3), True), (None, True)]
SPEC_IDS = ["dp", "clip-only", "dp+secure_agg", "secure_agg"]


def _jdp(dp):
    return None if dp is None else jpriv.DPSpec(dp.clip, dp.sigma)


def _agg_case(K=4, seed=0):
    rng = np.random.default_rng(seed)
    p = {"b": rng.normal(size=(20,)).astype(np.float32),
         "w": rng.normal(size=(30, 20)).astype(np.float32)}
    scale = np.array([0.05, 0.3, 1.0, 0.01], np.float32)[:K]
    wl = {k: (v[None] + scale.reshape((K,) + (1,) * v.ndim) *
              rng.normal(size=(K,) + v.shape)).astype(np.float32)
          for k, v in p.items()}
    weights = rng.integers(1, 9, size=K).astype(np.float32)
    ids = [6, 2, 9, 4][:K]
    return p, wl, weights, ids


def _magnitude(p_flat, wl_flat, coeffs, wbar, dp, secure_agg, draws, ids):
    mag = np.abs(p_flat).astype(np.float64)
    for k in range(wl_flat.shape[0]):
        mag += np.abs(coeffs[k] * (wl_flat[k] - p_flat))
    for i, cid in enumerate(ids):
        if dp is not None and dp.noised:
            mag += np.abs(wbar[i] * dp.sigma * dp.clip * draws("dp", cid))
        if secure_agg:
            for other in ids:
                if other != cid:
                    mag += np.abs(draws("mask", min(cid, other),
                                        max(cid, other)))
    return mag


@pytest.mark.parametrize("dp,secure_agg", SPECS, ids=SPEC_IDS)
def test_fused_dp_aggregate_matches_jax(dp, secure_agg):
    p, wl, weights, ids = _agg_case()
    rk = jax.random.PRNGKey(31)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jview = JFlatView.of(jp)
    jfops = JFlatParamOps(view=jview, interpret=True)
    jp_bufs = jfops.pad(jview.flatten(jp))
    jwl = jfops.pad(jview.flatten_stacked(jax.tree_util.tree_map(
        jnp.asarray, wl)))
    want = jpriv.fused_dp_aggregate(_jdp(dp), secure_agg, jfops, rk,
                                    jnp.asarray(ids), jp_bufs, jwl,
                                    jnp.asarray(weights))["float32"]

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    view = FlatView.of(tp)
    fops = FlatParamOps(view=view, interpret=False, device=CPU)
    n = view.buffer_sizes["float32"]

    def flat_draw(kind, a, b=None):
        tree = jax_draw(rk, jp, kind, a, b)
        return fops.pad(view.flatten({k: torch.from_numpy(np.array(v))
                                      for k, v in tree.items()}))
    t_p = fops.pad(view.flatten(tp))
    t_wl = {"float32": torch.from_numpy(np.array(jwl["float32"]))}
    got = privacy.fused_dp_aggregate(dp, secure_agg, fops, ids, t_p, t_wl,
                                     torch.from_numpy(weights), flat_draw)
    wbar = weights / weights.sum()
    scales = (np.ones_like(wbar) if dp is None else np.asarray(
        jpriv.stacked_clip_scales(_jdp(dp), [jp_bufs["float32"]],
                                  [jwl["float32"]])))
    mag = _magnitude(np.asarray(jp_bufs["float32"])[:n],
                     np.asarray(jwl["float32"])[:, :n], wbar * scales, wbar,
                     dp, secure_agg,
                     lambda *a: flat_draw(*a)["float32"][:n].numpy(), ids)
    diff = np.abs(got["float32"].numpy()[:n] - np.asarray(want)[:n])
    bad = diff > 1e-6 * mag + 1e-7
    assert not bad.any(), diff[bad].max()
    assert not got["float32"][n:].any()

    # the tree form, on the same draws
    tree_got = privacy.tree_dp_aggregate(
        dp, secure_agg, ids, tp, {k: torch.from_numpy(v)
                                  for k, v in wl.items()},
        torch.from_numpy(weights),
        lambda kind, a, b=None: {k: torch.from_numpy(v) for k, v in
                                 jax_draw(rk, jp, kind, a, b).items()})
    diff = np.abs(view.flatten(tree_got)["float32"].numpy() -
                  np.asarray(want)[:n])
    bad = diff > 1e-6 * mag + 1e-7
    assert not bad.any(), diff[bad].max()

    # the materialized uploads (one dp_clip_noise per client)
    if dp is not None:
        mat = privacy.materialized_dp_aggregate(
            dp, secure_agg, fops, ids, t_p, t_wl, torch.from_numpy(weights),
            flat_draw)
        diff = np.abs(mat["float32"].numpy()[:n] - np.asarray(want)[:n])
        bad = diff > 1e-5 * mag + 1e-7
        assert not bad.any(), diff[bad].max()


def _torch_magnitude(dp, secure_agg, ids, p, stacked, wbar, scales,
                     normal_fn, name):
    """|p| + Σₖ|w̄ₖ·scaleₖ·δₖ| + Σₖ|w̄ₖσC·zₖ| + Σ masks, for one bucket."""
    p32 = p[name].float()
    mag = p32.abs()
    for k, cid in enumerate(ids):
        mag = mag + (wbar[k] * scales[k] * (stacked[name][k].float() -
                                            p32)).abs()
        if dp is not None and dp.noised:
            mag = mag + (wbar[k] * dp.sigma * dp.clip *
                         normal_fn("dp", cid)[name]).abs()
        if secure_agg:
            for other in ids:
                if other != cid:
                    mag = mag + normal_fn("mask", min(cid, other),
                                          max(cid, other))[name].abs()
    return mag


def test_bf16_params_materialized_upload_matches_folded():
    """Params with a bf16 bucket: the f32 uploads of the materialized
    form aggregate over the bf16 buffer.  Tolerance: rtol 1e-5 of the
    summands (as for f32 above) plus one bf16 ulp of the result
    (2⁻⁷·|x|)."""
    p, wl, weights, ids = _agg_case()
    dp = DPSpec(0.5, 0.3)
    tp = {"b": torch.from_numpy(p["b"]),
          "w": torch.from_numpy(p["w"]).bfloat16()}
    twl = {"b": torch.from_numpy(wl["b"]),
           "w": torch.from_numpy(wl["w"]).bfloat16()}
    view = FlatView.of(tp)
    fops = FlatParamOps(view=view, interpret=False, device=CPU)
    pb, sb = fops.pad(view.flatten(tp)), fops.pad(view.flatten_stacked(twl))
    assert sorted(pb) == ["bfloat16", "float32"]
    w = torch.from_numpy(weights)
    normal_fn = privacy.keyed_normal_fn(11, fops.normal)
    folded = privacy.fused_dp_aggregate(dp, True, fops, ids, pb, sb, w,
                                        normal_fn)
    mat = privacy.materialized_dp_aggregate(dp, True, fops, ids, pb, sb, w,
                                            normal_fn)
    wbar = w / w.sum()
    names = list(pb)
    scales = privacy.stacked_clip_scales(dp, [pb[n] for n in names],
                                         [sb[n] for n in names])
    for name in names:
        assert mat[name].dtype == folded[name].dtype == pb[name].dtype
        mag = _torch_magnitude(dp, True, ids, pb, sb, wbar, scales,
                               normal_fn, name)
        want = folded[name].float()
        bound = 1e-5 * mag + 1e-7
        if name == "bfloat16":
            bound = bound + 2.0 ** -7 * want.abs()
        diff = (mat[name].float() - want).abs()
        assert not (diff > bound).any(), float(diff.max())


def _materialized_per_client(dp, secure_agg, fops, ids, p_bufs,
                             stacked_bufs, weights, normal_fn):
    """``materialized_dp_aggregate`` as it was before the rows form: one
    subtraction and one ``dp_clip_noise`` per client, the uploads
    stacked, then one ``weighted_delta(deltas=True)`` per bucket."""
    wbar = (weights / torch.sum(weights)).to(torch.float32)
    names = list(stacked_bufs)
    scales = privacy.stacked_clip_scales(dp, [p_bufs[n] for n in names],
                                         [stacked_bufs[n] for n in names])
    if scales is None:
        scales = torch.ones_like(wbar)
    noise_scale = torch.full_like(wbar[0], dp.sigma * dp.clip
                                  if dp.noised else 0.0)
    rows = []
    for k, cid in enumerate(ids):
        z = normal_fn("dp", cid, None) if dp.noised else None
        sc = torch.stack([scales[k], noise_scale])
        rows.append({n: fu.dp_clip_noise(
            stacked_bufs[n][k].float() - p_bufs[n].float(),
            None if z is None else z[n], sc) for n in names})
    uploads = {n: torch.stack([u[n] for u in rows]) for n in names}
    masks = privacy.round_extra(None, secure_agg, ids, wbar,
                                zeros_fn=lambda: fops.zeros(torch.float32),
                                normal_fn=normal_fn)
    return fops.weighted_delta(p_bufs, uploads, wbar, extra=masks,
                               deltas=True)


@pytest.mark.parametrize("dp,secure_agg", SPECS[:3], ids=SPEC_IDS[:3])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16+f32"])
def test_materialized_dp_aggregate_matches_per_client_form_bitwise(
        dp, secure_agg, bf16):
    """One rows-form launch per bucket gives exactly the aggregate of
    the per-client form it replaced, on the same draws."""
    p, wl, weights, ids = _agg_case()
    cast = (lambda t: t.bfloat16()) if bf16 else (lambda t: t)
    tp = {"b": torch.from_numpy(p["b"]), "w": cast(torch.from_numpy(p["w"]))}
    twl = {"b": torch.from_numpy(wl["b"]),
           "w": cast(torch.from_numpy(wl["w"]))}
    view = FlatView.of(tp)
    fops = FlatParamOps(view=view, interpret=False, device=CPU)
    pb, sb = fops.pad(view.flatten(tp)), fops.pad(view.flatten_stacked(twl))
    w = torch.from_numpy(weights)
    normal_fn = privacy.keyed_normal_fn(11, fops.normal)
    got = privacy.materialized_dp_aggregate(dp, secure_agg, fops, ids, pb,
                                            sb, w, normal_fn)
    want = _materialized_per_client(dp, secure_agg, fops, ids, pb, sb, w,
                                    normal_fn)
    assert sorted(got) == sorted(want) == sorted(pb)
    for name in pb:
        assert got[name].dtype == pb[name].dtype
        assert torch.equal(got[name], want[name]), name


def test_delta_sqnorms_match_jax():
    """One client's ‖w − p‖² over trees and over padded buffers, against
    the JAX package's (f32 sums in another order: rtol 1e-6)."""
    p, wl, _, _ = _agg_case(K=1)
    w = {k: v[0] for k, v in wl.items()}
    tp, tw = ({k: torch.from_numpy(np.array(v)) for k, v in t.items()}
              for t in (p, w))
    want = float(jpriv.tree_delta_sqnorm(
        jax.tree_util.tree_map(jnp.asarray, w),
        jax.tree_util.tree_map(jnp.asarray, p)))
    got_tree = float(privacy.tree_delta_sqnorm(tw, tp))
    view = FlatView.of(tp)
    fops = FlatParamOps(view=view, interpret=False, device=CPU)
    got_flat = float(privacy.flat_delta_sqnorm(fops.pad(view.flatten(tw)),
                                               fops.pad(view.flatten(tp))))
    assert got_tree == pytest.approx(want, rel=1e-6)
    assert got_flat == pytest.approx(want, rel=1e-6)


def test_clip_scale_matches_jax():
    sq = np.array([0.0, 1e-30, 0.25, 1.0, 4.0, 1e6], np.float32)
    for clip in (0.5, 1.0, 3.0):
        got = privacy.clip_scale(DPSpec(clip), torch.from_numpy(sq))
        want = jpriv.clip_scale(jpriv.DPSpec(clip), jnp.asarray(sq))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# full P2 runs
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


@pytest.mark.parametrize("impl", ["fused", "tree"])
def test_dp_secure_agg_run_matches_jax(run_setup, impl):
    jtask, jdata, ttask, tdata, init = run_setup
    dp = DPSpec(1.0, 0.1)
    sched = dict(rounds=ROUNDS, eval_every=0, seed=SEED, chunk_size=1,
                 sampling="host", host_rng_offset=17)
    jstrat = jengine.AggregateStrategy(
        spec=JLocalSpec(STEPS, BATCH, 0.05, update_impl="fused_interpret",
                        dp=_jdp(dp), secure_agg=True), participation=0.5)
    jledger = jacc.CommLedger()
    jres = jengine.run_rounds(jtask, jdata, jstrat,
                              jengine.RoundSchedule(**sched),
                              init_params=init, ledger=jledger)
    idx = jax_engine_indices(SEED, ROUNDS, 4, STEPS, BATCH, PER)
    tstrat = engine.AggregateStrategy(
        spec=LocalSpec(STEPS, BATCH, 0.05, update_impl=impl, dp=dp,
                       secure_agg=True), participation=0.5)
    ledger = CommLedger()
    tres = engine.run_rounds(
        ttask, tdata, tstrat, engine.RoundSchedule(
            **sched, batch_indices=index_source(idx),
            noise_draws=jax_noise_draws(SEED, ROUNDS, init)),
        init_params=bridge.params_from_numpy(jax_numpy_params(init)),
        ledger=ledger, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(jres.params),
                    tree_leaves(tres.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose([h["local_loss"] for h in tres.history],
                               [h["local_loss"] for h in jres.history],
                               rtol=1e-4)
    assert ledger.summary() == jledger.summary()
    x = acc.model_bytes(tres.params)
    assert ledger.mask_bytes == ROUNDS * acc.secure_agg_mask_bytes(4)
    assert ledger.total_bytes == acc.overhead_without_cyclic(
        "fedavg", 4, ROUNDS, x) + ROUNDS * acc.secure_agg_mask_bytes(4)


def _host_cfg(**kw):
    kw.setdefault("update_impl", "fused")
    return FLConfig(rounds=2, chunk_size=2, participation=0.5, local_steps=2,
                    batch_size=8, lr=0.05, eval_every=0, seed=SEED,
                    sampling="host", **kw)


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_masked_run_matches_unmasked(run_setup, impl):
    _, _, task, data, _ = run_setup
    base = run_federated(task, data, _host_cfg(update_impl=impl),
                         device="cpu")
    masked = run_federated(task, data, _host_cfg(update_impl=impl,
                                                 secure_agg=True),
                           device="cpu")
    for a, b in zip(tree_leaves(base.params), tree_leaves(masked.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("sampling", ["host", "device"])
def test_dp_runs_repeat_bitwise_and_noise_moves_params(run_setup, sampling):
    _, _, task, data, _ = run_setup
    cfg = _host_cfg(dp=DPSpec(0.5, 0.3), secure_agg=True)
    cfg = FLConfig(**{**cfg.__dict__, "sampling": sampling})
    a = run_federated(task, data, cfg, device="cpu")
    b = run_federated(task, data, cfg, device="cpu")
    base = run_federated(task, data, FLConfig(**{**_host_cfg().__dict__,
                                                 "sampling": sampling}),
                         device="cpu")
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    diffs = [float((x - y).abs().max())
             for x, y in zip(tree_leaves(a.params), tree_leaves(base.params))]
    assert max(diffs) > 1e-3, diffs


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_on_aggregate_sees_every_round(run_setup, impl):
    """``RoundSchedule.on_aggregate`` gets each round's index, inputs,
    start params, stacked client end states and new params; the last
    new params are the run's result."""
    _, _, task, data, _ = run_setup
    cfg = _host_cfg(update_impl=impl, dp=DPSpec(0.5, 0.3), secure_agg=True)
    seen = []

    def hook(rnd, inputs, params, stacked, new_params):
        seen.append((rnd, inputs.id_list(), stacked, new_params))
    sched = dataclasses.replace(cfg.schedule(), on_aggregate=hook)
    res = engine.run_rounds(task, data, cfg.strategy(), sched, device="cpu")
    assert [s[0] for s in seen] == list(range(cfg.rounds))
    K = cfg.n_selected(data.n_clients)
    assert all(len(s[1]) == K for s in seen)
    last = seen[-1][3]
    if impl == "fused":
        last = host_flat_ops(task, False, CPU).unflatten(last)
        assert all(b.shape[0] == K for b in seen[-1][2].values())
    for a, b in zip(tree_leaves(last), tree_leaves(res.params)):
        assert torch.equal(a, b)


def test_materialized_upload_of_an_engine_round_matches_folded(run_setup):
    """What ``chip_smoke.py``'s dp_upload phase checks on the card, here
    on the CPU: one private engine round seen through ``on_aggregate``,
    its uploads rebuilt by ``dp_clip_noise`` from the round's keyed
    draws, held against the engine's folded aggregate at rtol 1e-5 of
    the summands."""
    _, _, task, data, _ = run_setup
    cfg = _host_cfg(dp=DPSpec(0.5, 0.3), secure_agg=True)
    seen = {}

    def hook(rnd, inputs, params, stacked, new_params):
        if rnd == 0:
            seen.update(inputs=inputs, p=params, stacked=stacked,
                        folded=new_params)
    engine.run_rounds(task, data, cfg.strategy(),
                      dataclasses.replace(cfg.schedule(), on_aggregate=hook),
                      device="cpu")
    inputs, p, stacked = seen["inputs"], seen["p"], seen["stacked"]
    fops = host_flat_ops(task, False, CPU)
    normal_fn = privacy.keyed_normal_fn(inputs.round_key, fops.normal)
    ids = inputs.id_list()
    mat = privacy.materialized_dp_aggregate(cfg.dp, True, fops, ids, p,
                                            stacked, inputs.weights,
                                            normal_fn)
    wbar = inputs.weights / inputs.weights.sum()
    names = list(p)
    scales = privacy.stacked_clip_scales(cfg.dp, [p[n] for n in names],
                                         [stacked[n] for n in names])
    for name in names:
        mag = _torch_magnitude(cfg.dp, True, ids, p, stacked, wbar, scales,
                               normal_fn, name)
        diff = (mat[name] - seen["folded"][name]).abs()
        assert not (diff > 1e-5 * mag + 1e-7).any(), float(diff.max())


def test_ids_are_read_from_the_device_once_per_round():
    calls = []

    class Ids(torch.Tensor):
        def tolist(self):
            calls.append(1)
            return super().tolist()
    inputs = engine.RoundInputs(ids=torch.tensor([3, 1]).as_subclass(Ids),
                                weights=torch.ones(2), sampler=None)
    assert inputs.id_list() == [3, 1] and inputs.id_list() == [3, 1]
    assert len(calls) == 1
    known = engine.RoundInputs(ids=torch.tensor([3, 1]).as_subclass(Ids),
                               weights=torch.ones(2), sampler=None,
                               host_ids=[3, 1])
    assert known.id_list() == [3, 1] and len(calls) == 1
