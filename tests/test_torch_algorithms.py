"""FedProx, SCAFFOLD and MOON on the port's host engine against the JAX
package (``repro.fl``), on the CPU.

Both packages start from the same JAX-initialized params (carried with
``repro_torch.bridge``), draw the same client ids (``sampling="host"``)
and train on the JAX engine's threefry batch indices, injected into the
port through ``batch_indices``.  The JAX side runs its Pallas kernels in
interpret mode (``update_impl="fused_interpret"``); the port runs
``"fused"``, which on CPU tensors is each kernel's plain version, or the
tree path on both sides.  Data: a small numpy set made from a seed (8
clients of 16 samples, 8×8×1 images, an mlp of width 16).

Tolerances (the f32 tolerance of ``tests/test_torch_pipeline.py``):
  - losses rtol 1e-4; accuracies equal up to one test sample (an argmax
    tie may flip); final params and moon's ``w_prev`` rows atol 1e-4;
  - scaffold's control variates atol 1e-4/(S·lr): ``c_i⁺`` divides the
    clients' param change by S·lr (= 0.15 here), which scales the
    params' difference by 1/(S·lr);
  - moon at the same tolerances: its cosine norms and ``logsumexp``
    reduce in another order than XLA's, a difference of a few f32 ulps
    of the loss that the tolerances above already hold;
  - int8 uploads with error feedback as in
    ``tests/test_torch_compression.py``: within 1e-4, except that an
    element whose delta sits within that difference of a quantization
    midpoint may land on the other side (at most 0.1% of the elements,
    each by no more than twice the largest residual);
  - the exact invariants bitwise: fedprox at mu = 0 is fedavg, and
    scaffold's first round is fedavg's (c = c_i = 0, so ``g + (c − c_i)``
    adds zeros).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (index_source, jax_engine_indices, jax_leaves,
                          jax_local_indices, jax_noise_draws,
                          jax_numpy_params, torch_leaves)

import jax
import jax.numpy as jnp
from repro.data.federated import FederatedDataset as JFederatedDataset
from repro.fl import compression as jcomp
from repro.fl import engine as jengine
from repro.fl import privacy as jpriv
from repro.fl import simulation as jsim
from repro.fl.task import vision_task as j_vision_task
from repro_torch import bridge
from repro_torch.core import comm_accounting as acc
from repro_torch.core.cyclic import CyclicConfig
from repro_torch.core.pipeline import run_cyclic_then_federated
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import compression, engine, privacy, simulation
from repro_torch.fl.local import LocalSpec
from repro_torch.fl.simulation import FLConfig
from repro_torch.fl.task import vision_task
from repro_torch.utils import tree_math as tm

SEED = 0
N_CLIENTS, PER, STEPS, BATCH, ROUNDS = 8, 16, 3, 8, 2
K = 4                                   # participation 0.5
LR = 0.05
MLP_KW = {"img": 8, "d_hidden": 16}
ATOL = 1e-4
C_ATOL = ATOL / (STEPS * LR)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(N_CLIENTS, PER, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(N_CLIENTS, PER)).astype(np.int32)
    common = dict(x=x, y=y, n_real=np.full((N_CLIENTS,), PER, np.int32),
                  test_x=x[0], test_y=y[0], n_classes=10)
    jtask = j_vision_task("mlp", in_ch=1, seed_kwargs=MLP_KW)
    ttask = vision_task("mlp", in_ch=1, seed_kwargs=MLP_KW)
    init = jax.tree_util.tree_map(np.asarray,
                                  jtask.init(jax.random.PRNGKey(SEED)))
    return (jtask, JFederatedDataset(**common), ttask,
            FederatedDataset(**common), init)


def _cfg_kw(algorithm, impl, **kw):
    return dict(algorithm=algorithm, rounds=ROUNDS, participation=K /
                N_CLIENTS, local_steps=STEPS, batch_size=BATCH, lr=LR,
                eval_every=1, seed=SEED, sampling="host", chunk_size=1,
                update_impl=impl, **kw)


def _torch_init(init):
    return bridge.params_from_numpy(jax_numpy_params(init))


def _run_torch(setup, algorithm, impl, *, draws=False, **kw):
    _, _, ttask, tdata, init = setup
    cfg = FLConfig(**_cfg_kw(algorithm, impl, **kw), batch_indices=
                   index_source(jax_engine_indices(SEED, ROUNDS, K, STEPS,
                                                   BATCH, PER)))
    sched = cfg.schedule()
    if draws:
        sched = dataclasses.replace(sched, noise_draws=jax_noise_draws(
            SEED, ROUNDS, init))
    return engine.run_rounds(ttask, tdata, cfg.strategy(), sched,
                             init_params=_torch_init(init), device="cpu")


def _run_jax(setup, algorithm, impl, **kw):
    jtask, jdata, _, _, init = setup
    jimpl = "fused_interpret" if impl == "fused" else "tree"
    cfg = jsim.FLConfig(**_cfg_kw(algorithm, jimpl, **kw))
    return jengine.run_rounds(jtask, jdata, cfg.strategy(), cfg.schedule(),
                              init_params=jax.tree_util.tree_map(
                                  jnp.asarray, init))


def _np(tree):
    """Leaves of either package's tree (or buffer dict) as f32 numpy."""
    if isinstance(tree, dict) and tree and all(
            isinstance(v, torch.Tensor) for v in tm.tree_leaves(tree)):
        return torch_leaves(tree)
    return jax_leaves(tree)


def _assert_history(t_hist, j_hist):
    np.testing.assert_allclose([h["local_loss"] for h in t_hist],
                               [h["local_loss"] for h in j_hist], rtol=1e-4)
    for th, jh in zip(t_hist, j_hist):
        assert ("acc" in th) == ("acc" in jh)
        if "acc" in jh:
            assert abs(th["acc"] - jh["acc"]) * PER <= 1 + 1e-6


def _assert_close(got, want, atol):
    got, want = _np(got), _np(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _assert_state(algorithm, tres, jres):
    if algorithm == "scaffold":
        _assert_close(tres.algo_state["c_global"],
                      jres.algo_state["c_global"], C_ATOL)
        _assert_close(tres.algo_state["c_clients"],
                      jres.algo_state["c_clients"], C_ATOL)
        assert any(np.any(a != 0) for a in
                   _np(tres.algo_state["c_clients"]))
    elif algorithm == "moon":
        _assert_close(tres.algo_state["w_prev"], jres.algo_state["w_prev"],
                      ATOL)


# ---------------------------------------------------------------------------
# each algorithm, tree and fused, against the JAX package
# ---------------------------------------------------------------------------

ALGO_CASES = {
    # name: (algorithm, FLConfig kwargs)
    "fedprox": ("fedprox", {"mu": 0.5}),
    "scaffold": ("scaffold", {}),
    "moon": ("moon", {"mu": 0.5}),
}


@pytest.mark.parametrize("impl", ["tree", "fused"])
@pytest.mark.parametrize("case", ALGO_CASES)
def test_algorithm_matches_jax(setup, case, impl):
    algorithm, kw = ALGO_CASES[case]
    jres = _run_jax(setup, algorithm, impl, **kw)
    tres = _run_torch(setup, algorithm, impl, **kw)
    _assert_history(tres.history, jres.history)
    _assert_close(tres.params, jres.params, ATOL)
    _assert_state(algorithm, tres, jres)


# ---------------------------------------------------------------------------
# the algorithms combined with the server optimizer, compression and DP
# ---------------------------------------------------------------------------

def test_scaffold_with_fedavgm_matches_jax(setup):
    kw = {"server_opt": "momentum"}
    jres = _run_jax(setup, "scaffold", "fused", **kw)
    tres = _run_torch(setup, "scaffold", "fused", **kw)
    _assert_history(tres.history, jres.history)
    _assert_close(tres.params, jres.params, ATOL)
    _assert_state("scaffold", tres, jres)
    _assert_close(tres.server_state.inner, jres.server_state.inner, ATOL)


def _assert_compressed_close(pairs, bound):
    for a, b in pairs:
        off = np.abs(a - b) > 1e-4
        assert off.sum() <= max(1, a.size // 1000), int(off.sum())
        assert np.all(np.abs(a - b)[off] <= bound)


def test_scaffold_with_int8_error_feedback_matches_jax(setup):
    jres = _run_jax(setup, "scaffold", "fused", compression=jcomp.
                    CompressionSpec(bits=8, error_feedback=True))
    tres = _run_torch(setup, "scaffold", "fused", compression=compression.
                      CompressionSpec(bits=8, error_feedback=True))
    _assert_history(tres.history, jres.history)
    jr = _np(jres.algo_state["ef_residuals"])
    tr = _np(tres.algo_state["ef_residuals"])
    assert any(np.any(r != 0) for r in jr)
    bound = 2 * max(np.abs(r).max() for r in jr)
    _assert_compressed_close(
        list(zip(_np(tres.params), _np(jres.params))) + list(zip(tr, jr)),
        bound)
    # c_i⁺ reads the clients' end states, not their uploads
    _assert_close(tres.algo_state["c_clients"],
                  jres.algo_state["c_clients"], C_ATOL)


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_fedprox_with_dp_matches_jax(setup, impl):
    kw = {"mu": 0.5}
    jres = _run_jax(setup, "fedprox", impl, dp=jpriv.DPSpec(1.0, 0.1), **kw)
    tres = _run_torch(setup, "fedprox", impl, dp=privacy.DPSpec(1.0, 0.1),
                      draws=True, **kw)
    _assert_history(tres.history, jres.history)
    _assert_close(tres.params, jres.params, ATOL)


# ---------------------------------------------------------------------------
# exact invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_fedprox_at_mu_zero_is_fedavg_bitwise(setup, impl):
    a = _run_torch(setup, "fedprox", impl, mu=0.0)
    b = _run_torch(setup, "fedavg", impl)
    assert a.history == b.history
    for x, y in zip(torch_leaves(a.params), torch_leaves(b.params)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_scaffold_first_round_is_fedavg_bitwise(setup, impl):
    runs = {}
    for algorithm in ("scaffold", "fedavg"):
        _, _, ttask, tdata, init = setup
        cfg = FLConfig(**dict(_cfg_kw(algorithm, impl), rounds=1),
                       batch_indices=index_source(jax_engine_indices(
                           SEED, 1, K, STEPS, BATCH, PER)))
        runs[algorithm] = simulation.run_federated(
            ttask, tdata, cfg, init_params=_torch_init(init), device="cpu")
    assert runs["scaffold"].history == runs["fedavg"].history
    for x, y in zip(torch_leaves(runs["scaffold"].params),
                    torch_leaves(runs["fedavg"].params)):
        assert np.array_equal(x, y)
    st = runs["scaffold"].state
    assert st.c_global is not None and st.c_clients is not None
    assert st.w_prev is None


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox", "scaffold",
                                       "moon"])
def test_cyclic_then_each_algorithm(setup, algorithm):
    """"Cyclic+X" for each X through ``run_cyclic_then_federated``: P1
    relays, then X's P2 from the P1 model; the ledger is the Table-IV
    closed form (scaffold's P2 moves 4 X per client per round, the
    others 2 X) and X's client state comes back on the result."""
    _, _, ttask, tdata, init = setup
    cyc = CyclicConfig(rounds=2, participation=0.25, local_steps=STEPS,
                       batch_size=BATCH, lr=LR, eval_every=0, seed=SEED,
                       sampling="host", update_impl="fused")
    fed = FLConfig(**dict(_cfg_kw(algorithm, "fused"), eval_every=0))
    res = run_cyclic_then_federated(ttask, tdata, cyc, fed, device="cpu")
    assert [h["phase"] for h in res.history] == ["P1"] * 2 + ["P2"] * 2
    assert all(np.isfinite(h["local_loss"]) for h in res.history)
    x = acc.model_bytes(res.federated.params)
    assert res.ledger.total_bytes == acc.overhead_with_cyclic(
        algorithm, cyc.n_selected(N_CLIENTS), cyc.rounds, K, ROUNDS, x)
    st = res.federated.state
    assert (st.c_global is not None) == (algorithm == "scaffold")
    assert (st.w_prev is not None) == (algorithm == "moon")


# ---------------------------------------------------------------------------
# the single-round surfaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm,impl", [("scaffold", "tree"),
                                            ("moon", "tree"),
                                            ("scaffold", "fused")])
def test_init_server_state_matches_jax(setup, algorithm, impl):
    jtask, _, ttask, _, init = setup
    jimpl = "fused_interpret" if impl == "fused" else "tree"
    jst = jsim.init_server_state(
        jtask, jsim.FLConfig(algorithm=algorithm, update_impl=jimpl),
        N_CLIENTS, init_params=jax.tree_util.tree_map(jnp.asarray, init))
    tst = simulation.init_server_state(
        ttask, FLConfig(algorithm=algorithm, update_impl=impl), N_CLIENTS,
        init_params=_torch_init(init), device="cpu")
    for field in ("params", "c_global", "c_clients", "w_prev"):
        want = getattr(jst, field)
        got = getattr(tst, field)
        assert (got is None) == (want is None), field
        if want is not None:
            _assert_close(got, want, 0.0)


@pytest.mark.parametrize("algorithm", ["scaffold", "moon"])
def test_make_round_fn_matches_jax(setup, algorithm):
    """Two rounds through each package's ``make_round_fn`` from its
    ``init_server_state``, the port given the JAX round's batch indices
    through ``key``."""
    jtask, jdata, ttask, tdata, init = setup
    kw = {"mu": 0.5} if algorithm == "moon" else {}
    jcfg = jsim.FLConfig(**_cfg_kw(algorithm, "tree", **kw))
    tcfg = FLConfig(**_cfg_kw(algorithm, "tree", **kw))
    jinit = jax.tree_util.tree_map(jnp.asarray, init)
    jst = jsim.init_server_state(jtask, jcfg, N_CLIENTS, init_params=jinit)
    tst = simulation.init_server_state(ttask, tcfg, N_CLIENTS,
                                       init_params=_torch_init(init),
                                       device="cpu")
    keys = ("c_global", "c_clients", "w_prev")
    jstate = {k: getattr(jst, k) for k in keys if getattr(jst, k) is not None}
    tstate = {k: getattr(tst, k) for k in keys if getattr(tst, k) is not None}
    jround = jsim.make_round_fn(jtask, jcfg)
    tround = simulation.make_round_fn(ttask, tcfg, device="cpu")
    jx, jy, jn = jdata.device_arrays()
    rng = np.random.default_rng(SEED)
    jp, tp = jinit, tst.params
    key = jax.random.PRNGKey(SEED)
    for rnd in range(ROUNDS):
        ids = rng.choice(N_CLIENTS, size=K, replace=False)
        lr_scale = np.float32(jcfg.lr_decay ** rnd)
        key, rk = jax.random.split(key)
        idx = np.stack([jax_local_indices(ck, STEPS, BATCH, PER)
                        for ck in jax.random.split(rk, K)])
        jp, jstate, jm = jround(rk, jp, jx, jy, jnp.asarray(ids),
                                jn[jnp.asarray(ids)].astype(jnp.float32),
                                jnp.asarray(lr_scale), jstate)
        tp, tstate, tm_ = tround(
            lambda slot, step: torch.from_numpy(idx[slot, step].astype(
                np.int64)), tp, tdata.x, tdata.y, torch.from_numpy(ids),
            torch.full((K,), float(PER)), lr_scale, tstate)
        np.testing.assert_allclose(float(tm_["local_loss"]),
                                   float(jm["local_loss"]), rtol=1e-4)
    _assert_close(tp, jp, ATOL)
    for k in jstate:
        _assert_close(tstate[k], jstate[k],
                      C_ATOL if algorithm == "scaffold" else ATOL)


def test_make_server_update_speaks_trees(setup):
    """The fused server optimizer behind ``make_server_update`` takes and
    returns trees and equals the tree path's on one step."""
    _, _, ttask, _, init = setup
    p = _torch_init(init)
    avg = tm.tree_map(lambda t: t * 0.9, p)
    out = {}
    for impl in ("tree", "fused"):
        init_fn, update = simulation.make_server_update(
            FLConfig(server_opt="momentum", update_impl=impl), ttask,
            device="cpu")
        new_p, _ = update(p, avg, init_fn(p))
        out[impl] = torch_leaves(new_p)
    for a, b in zip(out["tree"], out["fused"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert simulation.make_server_update(FLConfig(), ttask,
                                         device="cpu") is None


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        LocalSpec(n_steps=1, batch_size=1, lr=0.1, variant="fedsplit")
