"""Helpers shared by the ``test_torch_*`` parity tests (not a test module).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's threefry batch draws are recomputed here with ``jax`` and
injected into the port through its ``batch_indices`` source.
"""
import jax
import numpy as np
import torch


def jax_local_indices(key, n_steps: int, batch: int, n_data: int) -> np.ndarray:
    """The (n_steps, batch) indices ``repro.fl.local``'s local fn draws
    from ``key``: ``split(key, n_steps)``, then one randint per step."""
    keys = jax.random.split(key, n_steps)
    return np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (batch,), 0, n_data))(keys))


def jax_engine_indices(seed: int, rounds: int, K: int, n_steps: int,
                       batch: int, n_data: int) -> np.ndarray:
    """The (rounds, K, n_steps, batch) indices ``repro.fl.engine`` draws
    under ``sampling="host"``: per round ``key, rk = split(key)``, per
    client ``split(rk, K)``, then the local fn's per-step draws."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        key, rk = jax.random.split(key)
        out.append(np.stack([jax_local_indices(ck, n_steps, batch, n_data)
                             for ck in jax.random.split(rk, K)]))
    return np.stack(out)


def index_source(idx: np.ndarray):
    """``(round, slot, step) -> LongTensor`` over a precomputed array."""
    def source(rnd: int, slot: int, step: int) -> torch.Tensor:
        return torch.from_numpy(np.asarray(idx[rnd, slot, step], np.int64))
    return source


def jax_leaves(tree):
    """Leaves of a JAX tree as f32 numpy, in tree_flatten order."""
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def torch_leaves(tree):
    from repro_torch.utils.tree_math import tree_leaves
    return [t.detach().float().cpu().numpy() for t in tree_leaves(tree)]


def jax_numpy_params(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


__all__ = ["jax_local_indices", "jax_engine_indices", "index_source",
           "jax_leaves", "torch_leaves", "jax_numpy_params"]
