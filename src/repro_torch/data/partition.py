"""Non-IID federated partitioning.

The paper follows Li et al. (ICDE'22): per-class Dirichlet(beta) splits
across clients.  Smaller beta = more heterogeneous.  beta in {0.1, 0.5, 1.0}
are the paper's three non-IID scenarios.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    beta: float,
    rng: np.random.Generator,
    min_per_client: int = 2,
    max_retries: int = 50,
) -> List[np.ndarray]:
    """Split sample indices over ``n_clients`` with per-class Dir(beta).

    Returns a list of index arrays, one per client.  Retries until every
    client holds at least ``min_per_client`` samples (standard practice —
    degenerate empty clients break local training).
    """
    if beta <= 0:
        raise ValueError(f"beta must be positive, got {beta}")
    labels = np.asarray(labels)
    n = len(labels)
    classes = np.unique(labels)
    for _ in range(max_retries):
        client_indices: List[List[int]] = [[] for _ in range(n_clients)]
        for c in classes:
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, beta))
            # cumulative split points over this class's samples
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, part in enumerate(np.split(idx_c, cuts)):
                client_indices[cid].extend(part.tolist())
        sizes = np.array([len(ci) for ci in client_indices])
        if sizes.min() >= min_per_client:
            return [np.array(sorted(ci), dtype=np.int64) for ci in client_indices]
    # fall back: top up tiny clients from the global pool
    pool = np.arange(n)
    out = []
    for ci in client_indices:
        ci = np.asarray(ci, dtype=np.int64)
        if len(ci) < min_per_client:
            extra = rng.choice(pool, size=min_per_client - len(ci), replace=False)
            ci = np.concatenate([ci, extra])
        out.append(np.sort(ci))
    return out


def partition_stats(labels: np.ndarray, parts: Sequence[np.ndarray]) -> Dict[str, float]:
    """Heterogeneity diagnostics for a partition: per-client size spread and
    mean label-distribution distance from the global distribution."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    global_dist = np.array([(labels == c).mean() for c in classes])
    tvs = []
    for idx in parts:
        if len(idx) == 0:
            tvs.append(1.0)
            continue
        local = labels[idx]
        local_dist = np.array([(local == c).mean() for c in classes])
        tvs.append(0.5 * np.abs(local_dist - global_dist).sum())
    sizes = np.array([len(p) for p in parts], dtype=np.float64)
    return {
        "n_clients": len(parts),
        "mean_size": float(sizes.mean()),
        "min_size": float(sizes.min()),
        "max_size": float(sizes.max()),
        "mean_tv_from_global": float(np.mean(tvs)),
        "coverage": float(len(np.unique(np.concatenate(parts))) / max(len(labels), 1)),
    }
