"""``repro_torch.utils.flatten.FlatView`` against the JAX package's
``FlatView``: the same leaf order (sorted dict keys), offsets and
buffers element for element, exact round trips (stacked included), and
the packed gradient the fused path consumes."""
import numpy as np
import pytest
import torch
from torch_parity import jax_numpy_params

import jax
import jax.numpy as jnp
from repro.fl.task import vision_task as j_vision_task
from repro.utils.flatten import FlatView as JFlatView
from repro_torch import bridge
from repro_torch.utils.flatten import FlatView
from repro_torch.utils.tree_math import tree_leaves

MODELS = {"lenet5": dict(n_classes=10, in_ch=3),
          "cnn_femnist": dict(n_classes=62, in_ch=1)}


def _params(model):
    jtask = j_vision_task(model, **MODELS[model])
    jparams = jtask.init(jax.random.PRNGKey(0))
    return jparams, bridge.params_from_numpy(jax_numpy_params(jparams))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_offsets_and_buffers_match_jax(model):
    jparams, params = _params(model)
    jview, view = JFlatView.of(jparams), FlatView.of(params)
    assert [(s.buffer, s.offset, s.size, s.shape) for s in view.slots] == \
        [(s.buffer, s.offset, s.size, s.shape) for s in jview.slots]
    assert view.buffer_sizes == jview.buffer_sizes
    jbufs, bufs = jview.flatten(jparams), view.flatten(params)
    assert bufs.keys() == jbufs.keys()
    for name in bufs:
        np.testing.assert_array_equal(bufs[name].numpy(),
                                      np.asarray(jbufs[name]))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_round_trip(model):
    _, params = _params(model)
    view = FlatView.of(params)
    back = view.unflatten(view.flatten(params))
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("K", [1, 3])
def test_stacked_round_trip_matches_jax(model, K):
    jparams, params = _params(model)
    jstack = jax.tree_util.tree_map(
        lambda x: jnp.stack([x * (k + 1) for k in range(K)]), jparams)
    stack = bridge.params_from_numpy(jax_numpy_params(jstack))
    view = FlatView.of(params)
    bufs = view.flatten_stacked(stack)
    jbufs = JFlatView.of(jparams).flatten_stacked(jstack)
    for name in bufs:
        assert bufs[name].shape == (K, view.buffer_sizes[name])
        np.testing.assert_array_equal(bufs[name].numpy(),
                                      np.asarray(jbufs[name]))
    back = view.unflatten_stacked(bufs)
    for a, b in zip(tree_leaves(back), tree_leaves(stack)):
        assert torch.equal(a, b)


def test_mixed_dtypes_and_nesting():
    tree = {"b": {"y": torch.ones(3, dtype=torch.bfloat16),
                  "x": torch.arange(4.0).reshape(2, 2)},
            "a": torch.tensor(5.0), "c": [torch.zeros(2), torch.ones(1)]}
    view = FlatView.of(tree)
    bufs = view.flatten(tree)
    assert view.buffer_sizes == {"float32": 1 + 4 + 2 + 1, "bfloat16": 3}
    # sorted keys: a, then b.x, b.y, then c[0], c[1]
    np.testing.assert_array_equal(bufs["float32"].numpy(),
                                  [5, 0, 1, 2, 3, 0, 0, 1])
    back = view.unflatten(bufs)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_empty_tree_round_trips():
    """The empty tree is its own round trip (the JAX package's
    ``unflatten_stacked`` raises StopIteration here; the port returns
    the empty tree)."""
    view = FlatView.of({})
    assert view.flatten({}) == {} and view.zeros() == {}
    assert view.unflatten({}) == {}
    assert view.flatten_stacked({}) == {}
    assert view.unflatten_stacked({}) == {}


def test_unflatten_returns_views_and_packs_the_gradient():
    _, params = _params("lenet5")
    view = FlatView.of(params)
    buf = view.flatten(params)["float32"]
    padded = torch.cat([buf, torch.zeros(40)]).requires_grad_(True)
    tree = view.unflatten({"float32": padded})
    loss = sum((leaf * leaf).sum() * (i + 1)
               for i, leaf in enumerate(tree_leaves(tree)))
    (g,) = torch.autograd.grad(loss, [padded])
    assert g.shape == padded.shape
    want = torch.cat([2 * (i + 1) * leaf.reshape(-1) for i, leaf in
                      enumerate(tree_leaves(params))] + [torch.zeros(40)])
    torch.testing.assert_close(g, want, rtol=0, atol=0)
    with torch.no_grad():
        views = tree_leaves(view.unflatten({"float32": padded}))
    assert views[0].data_ptr() == padded.data_ptr()


def test_structure_mismatch_raises():
    view = FlatView.of({"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        view.flatten({"b": torch.zeros(2)})
