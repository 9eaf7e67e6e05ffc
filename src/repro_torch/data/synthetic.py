"""Procedural stand-ins for the paper's benchmarks.

The counterpart of the vision and charlm families of
``repro/data/synthetic.py``, made by the same numpy code from the same
seeds, so every array is byte-identical to the JAX package's:

- vision : class-conditional images (a fixed random low-frequency
           template per class under a random shift + Gaussian noise +
           random contrast); ``cifar100c-hard`` is ``cifar100-like``
           with 20 coarse classes and heavy noise, the benchmarks'
           default set.
- charlm : character streams from per-client Markov chains (the
           Shakespeare stand-in, ``shakespeare-like``): each client's
           chain mixes a global transition matrix with its own, so the
           split is naturally non-IID.
- tokenlm: token streams for the LLM-class archs (``tokenlm-bigram``):
           bigram topic teachers over a bucketed vocab, each client
           sampling from its own Dirichlet mixture of topics.
"""
from __future__ import annotations

import functools

from typing import Optional, Tuple

import numpy as np

from repro_torch.data.federated import FederatedDataset
from repro_torch.utils.registry import Registry

DATASETS: Registry = Registry("dataset")


def _class_templates(rng: np.random.Generator, n_classes: int, h: int, w: int, c: int) -> np.ndarray:
    """Low-frequency class templates: random coefficients over a small 2D
    Fourier basis so that classes are distinguishable but overlapping."""
    fy, fx = 4, 4
    coef = rng.normal(size=(n_classes, c, fy, fx))
    ys = np.linspace(0, np.pi, h)[:, None, None, None]
    xs = np.linspace(0, np.pi, w)[None, :, None, None]
    basis = np.cos(ys * np.arange(fy)[None, None, :, None]) * np.cos(
        xs * np.arange(fx)[None, None, None, :])  # (h, w, fy, fx)
    tmpl = np.einsum("ncyx,hwyx->nhwc", coef, basis)
    tmpl /= np.abs(tmpl).max(axis=(1, 2, 3), keepdims=True) + 1e-8
    return tmpl.astype(np.float32)


def make_synthetic_vision(
    n_train: int = 20000,
    n_test: int = 2000,
    n_classes: int = 10,
    image_hw: Tuple[int, int] = (32, 32),
    channels: int = 3,
    noise: float = 0.35,
    max_shift: int = 4,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (train_x, train_y, test_x, test_y); x in NHWC float32."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    tmpl = _class_templates(rng, n_classes, h, w, channels)

    def gen(n, r):
        y = r.integers(0, n_classes, size=n)
        # random circular shift per sample (translation invariance
        # pressure): np.roll by (sy, sx) as one gather of rows and columns
        sy = r.integers(-max_shift, max_shift + 1, size=n)
        sx = r.integers(-max_shift, max_shift + 1, size=n)
        rows = (np.arange(h)[None, :] - sy[:, None]) % h
        cols = (np.arange(w)[None, :] - sx[:, None]) % w
        x = tmpl[y[:, None, None], rows[:, :, None], cols[:, None, :]]
        contrast = r.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
        x = x * contrast + r.normal(scale=noise, size=x.shape).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    train_x, train_y = gen(n_train, rng)
    test_x, test_y = gen(n_test, np.random.default_rng(seed + 1))
    return train_x, train_y, test_x, test_y


def make_synthetic_charlm(
    n_clients: int = 64,
    seq_len: int = 80,
    n_seq_per_client: int = 64,
    vocab: int = 64,
    style_mix: float = 0.35,
    n_test: int = 512,
    seed: int = 0,
) -> FederatedDataset:
    """Shakespeare stand-in: next-char prediction over stored sequences
    (x = seq[:-1] predicts y = seq[1:]).  Client i's chain is
    (1 − style_mix)·global + style_mix·client_specific."""
    rng = np.random.default_rng(seed)

    def row_norm(m):
        return m / m.sum(axis=1, keepdims=True)

    # sparse-ish global chain: every char strongly prefers a few successors
    global_T = row_norm(rng.dirichlet(np.full(vocab, 0.1), size=vocab))

    def sample_stream(T, n, L, r):
        out = np.empty((n, L), dtype=np.int32)
        state = r.integers(0, vocab, size=n)
        cdf = np.cumsum(T, axis=1)
        for t in range(L):
            out[:, t] = state
            u = r.random(n)
            state = (u[:, None] < cdf[state]).argmax(axis=1)
        return out

    xs = []
    for cid in range(n_clients):
        r = np.random.default_rng(seed + 1000 + cid)
        local_T = row_norm(r.dirichlet(np.full(vocab, 0.1), size=vocab))
        T = row_norm((1 - style_mix) * global_T + style_mix * local_T)
        xs.append(sample_stream(T, n_seq_per_client, seq_len + 1, r))
    x = np.stack(xs)  # (clients, n_seq, L+1)
    test = sample_stream(global_T, n_test, seq_len + 1,
                         np.random.default_rng(seed + 7))
    return FederatedDataset(
        x=x[:, :, :-1],
        y=x[:, :, 1:],
        n_real=np.full(n_clients, n_seq_per_client, dtype=np.int64),
        test_x=test[:, :-1],
        test_y=test[:, 1:],
        n_classes=vocab,
        name="synthetic-charlm",
    )


@functools.lru_cache(maxsize=1)
def _topic_cdfs(seed: int, bucket: int, n_topics: int) -> np.ndarray:
    """The ``n_topics`` bigram teachers' row CDFs, (n_topics, bucket,
    bucket): the costly part of a token dataset (8 x 4096² Dirichlet
    draws at a large vocab), drawn from ``seed`` alone, so datasets that
    differ only in vocab (above the bucket), clients or lengths share
    it.  Read only."""
    rng = np.random.default_rng(seed)

    def row_norm(m):
        return m / m.sum(axis=1, keepdims=True)

    chains = np.stack([
        row_norm(rng.dirichlet(np.full(bucket, 0.05), size=bucket))
        for _ in range(n_topics)
    ])
    cdfs = np.cumsum(chains, axis=2)
    cdfs.setflags(write=False)
    return cdfs


def make_synthetic_tokenlm(
    n_clients: int,
    seq_len: int,
    n_seq_per_client: int,
    vocab: int,
    n_topics: int = 8,
    beta: float = 0.5,
    n_test: int = 64,
    seed: int = 0,
) -> FederatedDataset:
    """Token-LM federated data for the LLM-class architectures.

    A set of ``n_topics`` bigram teachers; each client draws a topic
    mixture from Dir(beta) (non-IID across clients) and samples token
    streams from its mixture — CyclicFL's P1/P2 both consume this.
    """
    # topic chains over a *bucketed* vocab to keep memory bounded for huge vocabs
    bucket = min(vocab, 4096)
    cdfs = _topic_cdfs(seed, bucket, n_topics)

    def sample(topic_probs, n, L, r):
        out = np.empty((n, L), dtype=np.int32)
        topics = r.choice(n_topics, size=n, p=topic_probs)
        state = r.integers(0, bucket, size=n)
        for t in range(L):
            out[:, t] = state
            u = r.random(n)
            rowcdf = cdfs[topics, state]  # (n, bucket)
            state = (u[:, None] < rowcdf).argmax(axis=1)
        if vocab > bucket:
            # spread bucketed ids over the true vocab deterministically
            out = out * (vocab // bucket) + (out % (vocab // bucket))
        return out

    xs = []
    for cid in range(n_clients):
        r = np.random.default_rng(seed + 500 + cid)
        mix = r.dirichlet(np.full(n_topics, beta))
        xs.append(sample(mix, n_seq_per_client, seq_len + 1, r))
    x = np.stack(xs)
    test = sample(np.full(n_topics, 1.0 / n_topics), n_test, seq_len + 1,
                  np.random.default_rng(seed + 9))
    return FederatedDataset(
        x=x[:, :, :-1],
        y=x[:, :, 1:],
        n_real=np.full(n_clients, n_seq_per_client, dtype=np.int64),
        test_x=test[:, :-1],
        test_y=test[:, 1:],
        n_classes=vocab,
        name="synthetic-tokenlm",
    )


@DATASETS.register("cifar10-like")
def _cifar10_like(n_clients: int = 100, beta: Optional[float] = 0.5, seed: int = 0,
                  n_train: int = 20000, n_test: int = 2000,
                  noise: float = 0.35) -> FederatedDataset:
    tx, ty, ex, ey = make_synthetic_vision(n_train=n_train, n_test=n_test,
                                           n_classes=10, image_hw=(32, 32),
                                           channels=3, noise=noise, seed=seed)
    return FederatedDataset.from_arrays(tx, ty, ex, ey, n_clients, beta, seed,
                                        n_classes=10, name="cifar10-like")


@DATASETS.register("cifar100-like")
def _cifar100_like(n_clients: int = 100, beta: Optional[float] = 0.5, seed: int = 0,
                   n_train: int = 20000, n_test: int = 2000,
                   coarse: bool = False, noise: float = 0.35) -> FederatedDataset:
    n_classes = 20 if coarse else 100
    tx, ty, ex, ey = make_synthetic_vision(n_train=n_train, n_test=n_test,
                                           n_classes=n_classes, image_hw=(32, 32),
                                           channels=3, noise=noise, seed=seed)
    return FederatedDataset.from_arrays(tx, ty, ex, ey, n_clients, beta, seed,
                                        n_classes=n_classes, name="cifar100-like")


# the benchmarks' default set: 20 coarse classes and heavy noise, so
# short runs have headroom
@DATASETS.register("cifar100c-hard")
def _cifar100c_hard(n_clients: int = 100, beta: Optional[float] = 0.5,
                    seed: int = 0, n_train: int = 20000,
                    n_test: int = 2000) -> FederatedDataset:
    return _cifar100_like(n_clients=n_clients, beta=beta, seed=seed,
                          n_train=n_train, n_test=n_test, coarse=True,
                          noise=0.9)


@DATASETS.register("fashion-like")
def _fashion_like(n_clients: int = 100, beta: Optional[float] = 0.5, seed: int = 0,
                  n_train: int = 20000, n_test: int = 2000,
                  noise: float = 0.35) -> FederatedDataset:
    tx, ty, ex, ey = make_synthetic_vision(n_train=n_train, n_test=n_test,
                                           n_classes=10, image_hw=(28, 28),
                                           channels=1, noise=noise, seed=seed)
    return FederatedDataset.from_arrays(tx, ty, ex, ey, n_clients, beta, seed,
                                        n_classes=10, name="fashion-like")


@DATASETS.register("femnist-like")
def _femnist_like(n_clients: int = 190, beta: Optional[float] = 0.3, seed: int = 0,
                  n_train: int = 19000, n_test: int = 2000,
                  noise: float = 0.35) -> FederatedDataset:
    tx, ty, ex, ey = make_synthetic_vision(n_train=n_train, n_test=n_test,
                                           n_classes=62, image_hw=(28, 28),
                                           channels=1, noise=noise, seed=seed)
    return FederatedDataset.from_arrays(tx, ty, ex, ey, n_clients, beta, seed,
                                        n_classes=62, name="femnist-like")


@DATASETS.register("shakespeare-like")
def _shakespeare_like(n_clients: int = 66, seed: int = 0,
                      **kw) -> FederatedDataset:
    return make_synthetic_charlm(n_clients=n_clients, seed=seed, **kw)


# token-LM stream for the pod backend / LLM-class archs: registered so
# benchmarks and CLIs can stream per-round batches by dataset name
@DATASETS.register("tokenlm-bigram")
def _tokenlm_bigram(n_clients: int = 16, seed: int = 0, seq_len: int = 64,
                    n_seq_per_client: int = 64, vocab: int = 256,
                    beta: float = 0.5, n_test: int = 64) -> FederatedDataset:
    return make_synthetic_tokenlm(
        n_clients=n_clients, seq_len=seq_len,
        n_seq_per_client=n_seq_per_client, vocab=vocab, beta=beta,
        n_test=n_test, seed=seed)
