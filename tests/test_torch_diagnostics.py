"""The Fig. 7 diagnostics (``repro_torch.core.diagnostics``) and the tree
helpers they stand on, against the JAX package on the CPU.

Inputs are made with numpy from a seed: a LeNet-5 initialized by the JAX
package (carried across with ``repro_torch.bridge``) and a batch of 16
32×32×3 images.  The random directions and the power iteration's start
vector are the JAX package's own draws (``repro.utils.tree_math.
random_like`` of the keys the JAX functions split), injected into the
port; the port's own ``torch.Generator`` draws are checked for shape,
seeding and statistics.

Tolerances (f32 convolutions reduce in another order than XLA's):
  - the tree helpers: ``dot`` and ``cosine_similarity``, f32 sums of
    mixed-sign products over LeNet-5's 136,886 params in another order,
    rtol 1e-4; ``distance`` (a sum of squares) rtol 1e-5;
    ``filter_normalize`` elementwise, rtol 1e-6;
  - losses (base, slice points): rtol 1e-5;
  - sharpness entries, differences of two losses of ~8–36: atol 1e-4
    (about 1e-5 of the larger loss);
  - the top Hessian eigenvalue after 10 power iterations: rtol 1e-3
    (each HVP carries the conv double backward's f32 reassociation, and
    the iteration amplifies it where the top two eigenvalues are close);
  - client_similarity is numpy on both sides: equal.
"""
import numpy as np
import pytest
import torch
from torch_parity import jax_numpy_params, torch_leaves

import jax
from repro.core import diagnostics as jdiag
from repro.fl.task import vision_task as j_vision_task
from repro.utils import tree_math as jtm
from repro_torch import bridge
from repro_torch.core import diagnostics as diag
from repro_torch.fl.task import vision_task
from repro_torch.models.paper_models import PAPER_MODELS
from repro_torch.utils import tree_math as tm

SEED = 0
N = 16
ALPHAS = (0.1, 0.5, 1.0)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(N, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(N,)).astype(np.int32)
    jtask = j_vision_task("lenet5", n_classes=10, in_ch=3)
    ttask = vision_task("lenet5", n_classes=10, in_ch=3)
    jparams = jtask.init(jax.random.PRNGKey(SEED))
    tparams = bridge.params_from_numpy(jax_numpy_params(jparams))
    jloss = jdiag.make_batch_loss(jtask, x, y)
    tloss = diag.make_batch_loss(ttask, x, y, device="cpu")
    return jparams, tparams, jloss, tloss


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_dirs(key, params, n):
    return [_np_tree(jtm.random_like(k, params))
            for k in jax.random.split(key, n)]


def test_tree_helpers_match_jax(setup):
    jparams, tparams, _, _ = setup
    key = jax.random.PRNGKey(3)
    jd = jtm.random_like(key, jparams)
    td = bridge.params_from_numpy(_np_tree(jd))
    pairs = [
        (tm.dot(tparams, td), jtm.dot(jparams, jd), 1e-4),
        (tm.distance(tparams, td), jtm.distance(jparams, jd), 1e-5),
        (tm.cosine_similarity(tparams, td),
         jtm.cosine_similarity(jparams, jd), 1e-4),
    ]
    for got, want, rtol in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    got = torch_leaves(tm.filter_normalize(td, tparams))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jtm.filter_normalize(jd, jparams))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # the normalization gives each direction leaf its reference's norm
    for d, p in zip(tm.tree_leaves(tm.filter_normalize(td, tparams)),
                    tm.tree_leaves(tparams)):
        np.testing.assert_allclose(float(d.norm()), float(p.norm()),
                                   rtol=1e-5)


def test_random_like_is_seeded_and_standard_normal(setup):
    _, tparams, _, _ = setup
    draw = [tm.random_like(torch.Generator().manual_seed(s), tparams, 2.0)
            for s in (5, 5, 6)]
    for a, b, c in zip(*(tm.tree_leaves(d) for d in draw)):
        assert torch.equal(a, b) and not torch.equal(a, c)
    leaves = tm.tree_leaves(draw[0])
    assert [x.shape for x in leaves] == [x.shape for x in
                                         tm.tree_leaves(tparams)]
    flat = torch.cat([x.reshape(-1) for x in leaves]) / 2.0
    assert abs(float(flat.mean())) < 0.01
    assert abs(float(flat.std()) - 1.0) < 0.01


def test_sharpness_probe_matches_jax(setup):
    jparams, tparams, jloss, tloss = setup
    key = jax.random.PRNGKey(SEED + 100)
    want = jdiag.sharpness_probe(jloss, jparams, key, n_dirs=3,
                                 alphas=ALPHAS)
    got = diag.sharpness_probe(tloss, tparams, n_dirs=3, alphas=ALPHAS,
                               directions=_jax_dirs(key, jparams, 3))
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["base_loss"], want["base_loss"],
                               rtol=1e-5)
    for a in ALPHAS:
        k = f"sharpness@{a}"
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0)
    assert got["sharpness@1.0"] > got["sharpness@0.1"]


def test_sharpness_probe_own_draws_are_seeded(setup):
    _, tparams, _, tloss = setup
    runs = [diag.sharpness_probe(tloss, tparams,
                                 torch.Generator().manual_seed(s), n_dirs=2)
            for s in (1, 1, 2)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(np.isfinite(v) for v in runs[0].values())


def test_landscape_slice_matches_jax(setup):
    jparams, tparams, jloss, tloss = setup
    key = jax.random.PRNGKey(SEED + 100)
    want = jdiag.landscape_slice(jloss, jparams, key, n_points=9, radius=1.0)
    got = diag.landscape_slice(tloss, tparams, n_points=9, radius=1.0,
                               direction=_np_tree(jtm.random_like(key,
                                                                  jparams)))
    np.testing.assert_array_equal(got["alpha"], want["alpha"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    # the middle point is the unperturbed loss
    np.testing.assert_allclose(got["loss"][4], float(tloss(tparams)),
                               rtol=1e-6)


def test_hessian_top_eig_matches_jax(setup):
    jparams, tparams, jloss, tloss = setup
    key = jax.random.PRNGKey(SEED + 100)
    want = jdiag.hessian_top_eig(jloss, jparams, key, n_iter=10)
    got = diag.hessian_top_eig(tloss, tparams, n_iter=10,
                               v0=_np_tree(jtm.random_like(key, jparams)))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got > 0


def test_hessian_vector_product_is_the_hessian(setup):
    """The double backward's power iteration against the spectrum of the
    full Hessian (the Jacobian of the gradient) of a small mlp in f64."""
    init_fn, apply_fn, _ = PAPER_MODELS.get("mlp")
    params = tm.tree_map(lambda t: t.double(), init_fn(
        torch.Generator().manual_seed(0), in_ch=1, img=8, d_hidden=8))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(8, 8, 8, 1)))
    y = torch.as_tensor(rng.integers(0, 10, size=(8,)))

    def loss(p):
        return torch.nn.functional.cross_entropy(apply_fn(p, x), y)
    eig = diag.hessian_top_eig(loss, params, torch.Generator().manual_seed(1),
                               n_iter=500)
    leaves, treedef = tm.tree_flatten(params)
    sizes = [t.numel() for t in leaves]

    def grad_at(flat):
        parts = torch.split(flat, sizes)
        w = [p.reshape(t.shape).requires_grad_(True)
             for p, t in zip(parts, leaves)]
        g = torch.autograd.grad(loss(tm.tree_unflatten(treedef, w)), w,
                                create_graph=True)
        return torch.cat([t.reshape(-1) for t in g])
    flat = torch.cat([t.reshape(-1) for t in leaves]).detach()
    h = torch.autograd.functional.jacobian(grad_at, flat)
    top = float(torch.linalg.eigvalsh((h + h.T) / 2).abs().max())
    np.testing.assert_allclose(abs(eig), top, rtol=1e-4)


def test_client_similarity_matches_jax():
    rng = np.random.default_rng(SEED)
    labels = rng.integers(0, 10, size=(6, 40))
    labels[:3] %= 3                         # three skewed clients
    assert diag.client_similarity(labels, 10) == \
        jdiag.client_similarity(labels, 10)
    same = diag.client_similarity(np.tile(labels[:1], (4, 1)), 10)
    assert same["mean_pairwise_cos"] == pytest.approx(1.0)
    assert same["mean_tv_from_global"] == pytest.approx(0.0)


def test_make_batch_loss_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    task = vision_task("mlp", in_ch=1, seed_kwargs={"img": 8})
    with pytest.raises(RuntimeError, match="CUDA"):
        diag.make_batch_loss(task, np.zeros((1, 8, 8, 1), np.float32),
                             np.zeros((1,), np.int32))


def test_injected_numpy_direction_equals_tensor_direction(setup):
    jparams, tparams, _, tloss = setup
    d = _np_tree(jtm.random_like(jax.random.PRNGKey(9), jparams))
    a = diag.landscape_slice(tloss, tparams, n_points=3, direction=d)
    b = diag.landscape_slice(tloss, tparams, n_points=3,
                             direction=bridge.params_from_numpy(d))
    np.testing.assert_array_equal(a["loss"], b["loss"])


def test_probes_leave_params_untouched(setup):
    """The probes leave the caller's params as they were."""
    _, tparams, _, tloss = setup
    before = [t.clone() for t in tm.tree_leaves(tparams)]
    diag.sharpness_probe(tloss, tparams, torch.Generator().manual_seed(0),
                         n_dirs=1)
    diag.hessian_top_eig(tloss, tparams, torch.Generator().manual_seed(0),
                         n_iter=2)
    for a, b in zip(before, tm.tree_leaves(tparams)):
        assert torch.equal(a, b) and not b.requires_grad
