"""ResNet-8 (``repro_torch.models.paper_models``) against the JAX
package's, on the CPU: forward only, as in the JAX package.

The params are the JAX package's ``resnet8_init`` carried by the bridge
(its int ``stride`` and string ``norm_kind`` leaves as they are); the
input is a numpy-seeded NHWC batch at ``cifar100c-hard``'s shape (32 ×
32 × 3, 20 classes).  Logits within 1e-5 (the convolutions and the
normalizations' reductions sum in another order).  Training it raises
``TypeError`` in both packages, under both update impls: the engines
train array leaves only.
"""
import numpy as np
import pytest
import torch

import jax
from repro.models import paper_models as jpm
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.models import paper_models as tpm
from repro_torch.utils import tree_math as tm

TOL = 1e-5


def _jax_params(norm, seed=0):
    return jpm.resnet8_init(jax.random.PRNGKey(seed), n_classes=20,
                            norm=norm)


def _numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape")
                        else x, tree)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_resnet8_forward_matches_jax(norm):
    jp = _jax_params(norm)
    tp = params_from_numpy(_numpy(jp))
    assert tp["b2"]["stride"] == 2 and tp["norm_kind"] == norm
    x = np.random.default_rng(1).standard_normal((8, 32, 32, 3)) \
        .astype(np.float32)
    want = np.asarray(jpm.resnet8_apply(jp, x))
    got = tpm.resnet8_apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == (8, 20)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_resnet8_init_has_the_jax_tree(norm):
    jp = _numpy(_jax_params(norm))
    tp = tpm.resnet8_init(torch.Generator().manual_seed(0), n_classes=20,
                          norm=norm)
    assert tm.tree_paths(tp) == tm.tree_paths(params_from_numpy(jp))
    for a, b in zip(tm.tree_leaves(tp), tm.tree_leaves(jp)):
        if isinstance(a, torch.Tensor):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        else:
            assert a == b
    back = params_to_numpy(params_from_numpy(jp))
    assert back["norm_kind"] == norm and back["b3"]["stride"] == 2
    assert tpm.PAPER_MODELS.get("resnet8")[:2] == (tpm.resnet8_init,
                                                   tpm.resnet8_apply)


def test_strided_same_convolution_pads_as_xla():
    """A 3×3 "SAME" convolution at stride 2 pads after, as XLA does."""
    jc = jpm.init_conv(jax.random.PRNGKey(3), 3, 4, 5)
    x = np.random.default_rng(2).standard_normal((2, 9, 8, 4)) \
        .astype(np.float32)
    want = np.asarray(jpm.conv2d(jc, x, stride=2))
    got = tpm.conv2d(params_from_numpy(_numpy(jc)), torch.from_numpy(x),
                     stride=2).numpy()
    assert got.shape == want.shape == (2, 5, 4, 5)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _train(pkg, impl):
    if pkg == "jax":
        from repro.core.cyclic import CyclicConfig
        from repro.core.pipeline import run_cyclic_then_federated
        from repro.data.synthetic import DATASETS
        from repro.fl.simulation import FLConfig
        from repro.fl.task import vision_task
        extra = {}
    else:
        from repro_torch.core.cyclic import CyclicConfig
        from repro_torch.core.pipeline import run_cyclic_then_federated
        from repro_torch.data.synthetic import DATASETS
        from repro_torch.fl.simulation import FLConfig
        from repro_torch.fl.task import vision_task
        extra = {"device": "cpu"}
    data = DATASETS.get("cifar100c-hard")(n_clients=4, n_train=64, n_test=16)
    kw = dict(rounds=1, local_steps=1, batch_size=4, update_impl=impl,
              eval_every=0)
    run_cyclic_then_federated(vision_task("resnet8", n_classes=20), data,
                              CyclicConfig(participation=0.5, **kw),
                              FLConfig(participation=0.5, **kw), **extra)


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_training_resnet8_raises_type_error_in_both(impl):
    with pytest.raises(TypeError):
        _train("jax", impl)
    with pytest.raises(TypeError, match="not a tensor"):
        _train("torch", impl)
