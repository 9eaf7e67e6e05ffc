"""Helpers shared by the ``test_torch_*`` parity tests (not a test module).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's threefry batch draws are recomputed here with ``jax`` and
injected into the port through its ``batch_indices`` source, and their
dropout keep-masks through ``step_masks``.
"""
import dataclasses

import jax
import jax.numpy as jnp
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


def jax_local_masks(key, n_steps: int, shape, keep_prob: float
                    ) -> np.ndarray:
    """The (n_steps, *shape) dropout keep-masks the JAX package's models
    draw in one local run from ``key``: the step key of
    ``jax_local_indices`` (the loss's ``rng``), then
    ``bernoulli(step_key, keep_prob, shape)``."""
    return np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
        k, keep_prob, tuple(shape)))(jax.random.split(key, n_steps)))


def jax_engine_masks(seed: int, rounds: int, K: int, n_steps: int,
                     shape, keep_prob: float) -> np.ndarray:
    """The (rounds, K, n_steps, *shape) keep-masks of
    :func:`jax_local_masks` in ``repro.fl.engine`` under
    ``sampling="host"``, with the client keys of
    :func:`jax_engine_indices`."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        key, rk = jax.random.split(key)
        out.append(np.stack([jax_local_masks(ck, n_steps, shape, keep_prob)
                             for ck in jax.random.split(rk, K)]))
    return np.stack(out)


def mask_source(masks: np.ndarray):
    """``(round, slot, step) -> BoolTensor`` over a precomputed array."""
    def source(rnd: int, slot: int, step: int) -> torch.Tensor:
        return torch.from_numpy(np.array(masks[rnd, slot, step]))
    return source


def jax_round_keys(seed: int, rounds: int):
    """The round keys ``repro.fl.engine`` threads into each round body
    under ``sampling="host"``: per round ``key, rk = split(key)``."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        key, rk = jax.random.split(key)
        out.append(rk)
    return out


def jax_draw(rk, template, kind: str, a: int, b=None):
    """The JAX package's per-leaf privacy draw (``tree_normal``) of one
    round key as a numpy tree: client ``a``'s DP noise (kind "dp") or
    the mask of the pair ``a < b`` (kind "mask")."""
    from repro.fl import privacy as jpriv
    if kind == "dp":
        key = jpriv.client_noise_key(jpriv.noise_base_key(rk), a)
    else:
        key = jpriv.pair_mask_key(jpriv.mask_base_key(rk), a, b)
    return jax.tree_util.tree_map(np.array,
                                  jpriv.tree_normal(key, template))


def jax_noise_draws(seed: int, rounds: int, template):
    """``(round, kind, a, b) -> numpy tree``: the JAX engine's privacy
    draws for the port's ``noise_draws`` hook (cached: each pair is
    asked for from both of its endpoints)."""
    keys = jax_round_keys(seed, rounds)
    cache = {}

    def draws(rnd: int, kind: str, a: int, b=None):
        k = (rnd, kind, a, b)
        if k not in cache:
            cache[k] = jax_draw(keys[rnd], template, kind, a, b)
        return cache[k]
    return draws


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


_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def torch_config(jcfg):
    """A JAX ``TransformerConfig`` mapped over field for field to the
    port's (jnp dtypes become torch dtypes)."""
    from repro_torch.models.transformer import TransformerConfig
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    for k in ("dtype", "param_dtype", "logit_dtype"):
        fields[k] = _DTYPES[fields[k]]
    return TransformerConfig(**fields)


def to_torch_params(jparams, device="cpu"):
    """A JAX param tree carried across through numpy and the bridge."""
    from repro_torch.bridge import params_from_numpy
    return params_from_numpy(jax_numpy_params(jparams), device)


__all__ = ["jax_local_indices", "jax_engine_indices", "index_source",
           "jax_engine_masks", "mask_source",
           "jax_round_keys", "jax_draw", "jax_noise_draws",
           "jax_leaves", "torch_leaves", "jax_numpy_params", "torch_config",
           "to_torch_params"]
