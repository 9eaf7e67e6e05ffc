"""``repro_torch.data``: the synthetic vision and charlm sets and their
federated partitions are byte-identical to the JAX package's (same
numpy code, same seeds), and device placement / batch sampling follow
the torch idiom."""
import numpy as np
import pytest
import torch

from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import DATASETS as J_DATASETS
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import DATASETS


@pytest.mark.parametrize("name,kw", [
    ("cifar10-like", dict(n_clients=8, n_train=300, n_test=50)),
    ("femnist-like", dict(n_clients=10, n_train=400, n_test=50)),
    ("cifar100c-hard", dict(n_clients=8, n_train=300, n_test=50)),
    ("shakespeare-like", dict(n_clients=5, seq_len=12, n_seq_per_client=6,
                              n_test=20)),
])
@pytest.mark.parametrize("beta", [None, 0.5])
def test_federated_sets_are_byte_identical(name, kw, beta):
    if name == "shakespeare-like":
        # clients are its own Markov chains: no partition, no beta
        kw = dict(kw, vocab=32 if beta is None else 64)
    else:
        kw = dict(kw, beta=beta)
    a = DATASETS.get(name)(seed=3, **kw)
    b = J_DATASETS.get(name)(seed=3, **kw)
    for field in ("x", "y", "n_real", "test_x", "test_y"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes(), field
    assert a.n_classes == b.n_classes and a.name == b.name


def test_dirichlet_partition_is_identical():
    labels = np.random.default_rng(0).integers(0, 10, size=500)
    a = dirichlet_partition(labels, 12, 0.3, np.random.default_rng(1))
    b = j_dirichlet(labels, 12, 0.3, np.random.default_rng(1))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_registry_lists_the_ported_vision_sets():
    """Every set of the JAX package's registry is ported (the token
    stream since the LM slice); an unknown name raises."""
    assert set(DATASETS.names()) == {"cifar10-like", "cifar100-like",
                                     "cifar100c-hard", "fashion-like",
                                     "femnist-like", "shakespeare-like",
                                     "tokenlm-bigram"}
    assert set(DATASETS.names()) == set(J_DATASETS.names())
    with pytest.raises(KeyError):
        DATASETS.get("imagenet-like")


def test_device_arrays_and_client_batches():
    data = DATASETS.get("cifar10-like")(n_clients=4, beta=0.5, seed=0,
                                        n_train=64, n_test=16)
    x, y, n_real = data.device_arrays("cpu")
    assert x.shape == data.x.shape and y.dtype == torch.int64
    assert data.device_arrays("cpu")[0] is x            # uploaded once
    np.testing.assert_array_equal(n_real.numpy(), data.n_real)
    gen = torch.Generator().manual_seed(0)
    bx, by = data.client_batches(2, 5, gen, 3, "cpu")
    assert bx.shape == (3, 5) + data.x.shape[2:] and by.shape == (3, 5)
    gen2 = torch.Generator().manual_seed(0)
    bx2, _ = data.client_batches(2, 5, gen2, 3, "cpu")
    assert torch.equal(bx, bx2)
