"""One client's local run: ``repro_torch.fl.local.make_local_fn`` against
the JAX package's, tree and fused paths, with and without momentum,
weight decay and the global-norm clip.

Both start from the same LeNet-5 weights and see the same batches: the
port's ``sample`` replays the indices the JAX local fn draws from its
key.  The JAX fused path runs its Pallas kernel in interpret mode.
End params within rtol 1e-4, atol 1e-5 (five SGD steps over conv
reductions summed in another order).
"""
import numpy as np
import pytest
import torch
from torch_parity import (jax_leaves, jax_local_indices, jax_numpy_params,
                          torch_leaves)

import jax
import jax.numpy as jnp
from repro.fl.local import LocalSpec as JLocalSpec
from repro.fl.local import host_flat_ops as j_host_flat_ops
from repro.fl.local import make_local_fn as j_make_local_fn
from repro.fl.task import vision_task as j_vision_task
from repro_torch import bridge
from repro_torch.fl.local import LocalSpec, host_flat_ops, make_local_fn
from repro_torch.fl.task import vision_task

STEPS, BATCH, N_DATA = 5, 8, 40
TAILS = {                      # (momentum, weight_decay, grad_clip)
    "plain": (0.0, 0.0, None),
    "momentum+wd": (0.9, 1e-3, None),
    "clip": (0.0, 0.0, 0.5),
    "all": (0.9, 1e-3, 0.5),
}


@pytest.fixture(scope="module")
def setup():
    jtask = j_vision_task("lenet5", n_classes=10, in_ch=3)
    task = vision_task("lenet5", n_classes=10, in_ch=3)
    jparams = jtask.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    cx = rng.standard_normal((N_DATA, 32, 32, 3)).astype(np.float32)
    cy = rng.integers(0, 10, size=N_DATA).astype(np.int32)
    return jtask, task, jparams, cx, cy


@pytest.mark.parametrize("impl", ["tree", "fused"])
@pytest.mark.parametrize("tail", sorted(TAILS))
def test_local_run_matches_jax(setup, impl, tail):
    jtask, task, jparams, cx, cy = setup
    momentum, wd, clip = TAILS[tail]
    common = dict(n_steps=STEPS, batch_size=BATCH, lr=0.05,
                  momentum=momentum, weight_decay=wd, grad_clip=clip)
    key = jax.random.PRNGKey(6)
    lr_scale = 0.9

    j_impl = "tree" if impl == "tree" else "fused_interpret"
    jlocal = j_make_local_fn(jtask, JLocalSpec(**common, update_impl=j_impl))
    if impl == "tree":
        jstart = jparams
    else:
        jfops = j_host_flat_ops(jtask, True)
        jstart = jfops.pad(jfops.flatten(jparams))
    jend, jaux = jlocal(key, jstart, {}, jnp.asarray(cx), jnp.asarray(cy),
                        jnp.float32(lr_scale))
    if impl != "tree":
        jend = jfops.unflatten(jend)

    idx = jax_local_indices(key, STEPS, BATCH, N_DATA)
    tx, ty = torch.from_numpy(cx), torch.from_numpy(cy).long()

    def sample(step):
        rows = torch.from_numpy(idx[step].astype(np.int64))
        return tx[rows], ty[rows], None

    spec = LocalSpec(**common, update_impl=impl)
    params = bridge.params_from_numpy(jax_numpy_params(jparams))
    fops = host_flat_ops(task, False, torch.device("cpu"))
    local = make_local_fn(task, spec, fops if impl == "fused" else None)
    start = params if impl == "tree" else fops.place(fops.flatten(params))
    end, loss = local(start, sample, torch.tensor(lr_scale))
    if impl == "fused":
        assert end is start                        # updated in place
        end = fops.unflatten(end)

    np.testing.assert_allclose(float(loss), float(jaux["loss"]), rtol=1e-5)
    for a, b in zip(torch_leaves(end), jax_leaves(jend)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
