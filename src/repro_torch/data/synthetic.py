"""Procedural stand-ins for the paper's vision benchmarks.

The counterpart of the vision half of ``repro/data/synthetic.py``:
class-conditional images (a fixed random low-frequency template per
class under a random shift + Gaussian noise + random contrast), made by
the same numpy code from the same seeds, so every array is
byte-identical to the JAX package's.  The charlm and tokenlm families
are not ported yet (ROADMAP.md items M2d and M12).
"""
from __future__ import annotations

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
        x = tmpl[y].copy()
        # random circular shift per sample (translation invariance pressure)
        sy = r.integers(-max_shift, max_shift + 1, size=n)
        sx = r.integers(-max_shift, max_shift + 1, size=n)
        for i in range(n):
            x[i] = np.roll(np.roll(x[i], sy[i], axis=0), sx[i], axis=1)
        contrast = r.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
        x = x * contrast + r.normal(scale=noise, size=x.shape).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    train_x, train_y = gen(n_train, rng)
    test_x, test_y = gen(n_test, np.random.default_rng(seed + 1))
    return train_x, train_y, test_x, test_y


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
