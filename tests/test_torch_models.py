"""``repro_torch.models.paper_models`` against the JAX package's models
with the same weights (carried by ``repro_torch.bridge``): logits and
parameter gradients of the task loss.

Tolerances: logits rtol 1e-5, atol 1e-5; gradients rtol 1e-4, atol
1e-6 — convolution and matmul reductions sum in another order on the
two sides.
"""
import numpy as np
import pytest
import torch
from torch_parity import jax_leaves, jax_numpy_params, torch_leaves

import jax
import jax.numpy as jnp
from repro.fl.task import vision_task as j_vision_task
from repro.models.paper_models import PAPER_MODELS as J_PAPER_MODELS
from repro_torch import bridge
from repro_torch.fl.task import vision_task
from repro_torch.models.paper_models import PAPER_MODELS
from repro_torch.utils.tree_math import tree_leaves

CASES = {
    "lenet5": dict(n_classes=10, in_ch=3, hw=32),
    "mlp": dict(n_classes=10, in_ch=1, hw=28),
    "cnn_femnist": dict(n_classes=62, in_ch=1, hw=28),
}


def _setup(model):
    kw = CASES[model]
    jtask = j_vision_task(model, n_classes=kw["n_classes"], in_ch=kw["in_ch"])
    task = vision_task(model, n_classes=kw["n_classes"], in_ch=kw["in_ch"])
    jparams = jtask.init(jax.random.PRNGKey(1))
    params = bridge.params_from_numpy(jax_numpy_params(jparams))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, kw["hw"], kw["hw"], kw["in_ch"])) \
        .astype(np.float32)
    y = rng.integers(0, kw["n_classes"], size=4).astype(np.int32)
    return jtask, task, jparams, params, x, y


@pytest.mark.parametrize("model", sorted(CASES))
def test_logits_match_jax(model):
    jtask, task, jparams, params, x, _ = _setup(model)
    _, japply, _ = J_PAPER_MODELS.get(model)
    _, apply, _ = PAPER_MODELS.get(model)
    want = np.asarray(japply(jparams, jnp.asarray(x)))
    got = apply(params, torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        task.predict_fn(params, torch.from_numpy(x)).numpy(),
        np.asarray(jtask.predict_fn(jparams, jnp.asarray(x))))


@pytest.mark.parametrize("model", sorted(CASES))
def test_loss_and_gradients_match_jax(model):
    jtask, task, jparams, params, x, y = _setup(model)
    jloss, jgrads = jax.value_and_grad(jtask.loss_fn)(
        jparams, jnp.asarray(x), jnp.asarray(y))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = task.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for g, jg in zip(torch_leaves(list(grads)), jax_leaves(jgrads)):
        assert g.shape == jg.shape
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-6)


def test_lenet5_keeps_the_jax_layout():
    """HWIO conv weights, (d_in, d_out) fc weights, and f1's rows in
    (H, W, C) order: zeroing the f1 rows of channel 0 changes the logits
    exactly as it does in the JAX package."""
    jtask, task, jparams, params, x, _ = _setup("lenet5")
    assert tuple(params["c1"]["w"].shape) == (5, 5, 3, 6)
    assert tuple(params["f1"]["w"].shape) == (16 * 8 * 8, 120)
    rows = np.arange(16 * 8 * 8) % 16 == 0          # NHWC: c is fastest
    jparams["f1"]["w"] = jparams["f1"]["w"].at[rows].set(0.0)
    params["f1"]["w"][torch.from_numpy(rows)] = 0.0
    want = np.asarray(jtask.repr_fn(jparams, jnp.asarray(x)))
    got = task.repr_fn(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_draws_from_the_generator():
    init = PAPER_MODELS.get("lenet5")[0]
    a = init(torch.Generator().manual_seed(0))
    b = init(torch.Generator().manual_seed(0))
    c = init(torch.Generator().manual_seed(1))
    assert torch.equal(a["c1"]["w"], b["c1"]["w"])
    assert not torch.equal(a["c1"]["w"], c["c1"]["w"])
    std = float(a["f1"]["w"].std())
    assert abs(std - (2.0 / 1024) ** 0.5) < 0.01
