"""Federated dataset container + client batch sampling.

The counterpart of ``repro/data/federated.py``: every client's data is
kept as fixed-size stacked numpy arrays ``(n_clients, n_per_client,
...)``, built by the same numpy code from the same seed, so the arrays
are byte-identical to the JAX package's.  Device placement takes an
explicit ``device``; random batch indices come from a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.partition import dirichlet_partition


@dataclasses.dataclass
class FederatedDataset:
    """Stacked per-client data.

    x: (n_clients, n_per_client, *feature_shape)
    y: (n_clients, n_per_client) int labels
    n_real: (n_clients,) number of genuine (non-resampled) samples per
        client — the FedAvg aggregation weights N_i.
    test_x / test_y: held-out global test set.
    """

    x: np.ndarray
    y: np.ndarray
    n_real: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    n_classes: int
    name: str = "federated"
    _device_cache: Dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]

    @property
    def n_per_client(self) -> int:
        return self.x.shape[1]

    def client_weights(self) -> np.ndarray:
        return self.n_real.astype(np.float64) / self.n_real.sum()

    @classmethod
    def from_arrays(
        cls,
        x: np.ndarray,
        y: np.ndarray,
        test_x: np.ndarray,
        test_y: np.ndarray,
        n_clients: int,
        beta: Optional[float],
        seed: int,
        n_classes: Optional[int] = None,
        n_per_client: Optional[int] = None,
        name: str = "federated",
    ) -> "FederatedDataset":
        """Partition a centralized dataset into clients.

        beta=None means IID (uniform random split); otherwise per-class
        Dirichlet(beta).  Each client is padded to ``n_per_client`` by
        resampling its own data (with replacement) so the stacked layout
        is rectangular; ``n_real`` records true sizes for weighting.
        """
        rng = np.random.default_rng(seed)
        n = len(y)
        if beta is None:
            perm = rng.permutation(n)
            parts = np.array_split(perm, n_clients)
        else:
            parts = dirichlet_partition(y, n_clients, beta, rng)
        if n_per_client is None:
            n_per_client = max(int(np.ceil(n / n_clients)), 2)
        xs, ys, n_real = [], [], []
        for idx in parts:
            n_real.append(len(idx))
            if len(idx) >= n_per_client:
                take = rng.choice(idx, size=n_per_client, replace=False)
            else:
                pad = rng.choice(idx, size=n_per_client - len(idx), replace=True)
                take = np.concatenate([idx, pad])
            rng.shuffle(take)
            xs.append(x[take])
            ys.append(y[take])
        return cls(
            x=np.stack(xs),
            y=np.stack(ys),
            n_real=np.asarray(n_real, dtype=np.int64),
            test_x=test_x,
            test_y=test_y,
            n_classes=n_classes or int(y.max()) + 1,
            name=name,
        )

    def client_batches(self, client: int, batch_size: int,
                       generator: torch.Generator, n_batches: int,
                       device: torch.device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample ``n_batches`` batches for one client (uniform with
        replacement, from ``generator``, which must live on ``device``);
        returns stacked (n_batches, batch, ...) tensors."""
        idx = torch.randint(0, self.n_per_client, (n_batches, batch_size),
                            generator=generator, device=device)
        x_all, y_all, _ = self.device_arrays(device)
        return x_all[client][idx], y_all[client][idx]

    def device_arrays(self, device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(x, y, n_real)`` on ``device``, uploaded once per device and
        cached.  Labels are int64 (the index dtype torch's gathers
        take); ``n_real`` stays integer like the JAX package's."""
        device = torch.device(device)
        if device not in self._device_cache:
            self._device_cache[device] = (
                torch.as_tensor(self.x).to(device),
                torch.as_tensor(self.y).to(device=device, dtype=torch.int64),
                torch.as_tensor(self.n_real).to(device))
        return self._device_cache[device]
