"""``repro_torch.checkpoint`` against ``repro.checkpoint``: one file
format read both ways.

The JAX package's round-trip properties (``tests/test_properties.py``)
on port trees (hypothesis trees of dicts, lists and tuples over f32,
i32, f64, i64, bf16 and 0-d leaves); a file the JAX package writes
(bf16 leaves included) read by the port bitwise; a file the port writes
read by the JAX package with the same entries, manifest, dtypes and
bytes as the file it writes itself; ``CheckpointManager``'s keep,
latest, restore and gc.  Everything is compared exactly (no tolerance).

One settled difference: the JAX package reads a bf16 leaf back as raw
``V2`` bytes (numpy has no bfloat16); the port reads it as
``torch.bfloat16``.  Both write a bf16 leaf's two bytes per element
unchanged; the ``.npy`` headers name the dtype ``<V2`` (ml_dtypes) and
``|V2`` (the port), which numpy reads as the same dtype.
"""
import json
import zipfile

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from repro.checkpoint import store as jstore
from repro_torch import checkpoint as tck
from repro_torch.utils import tree_math as tm


def _bf16(*shape):
    return (torch.arange(int(np.prod(shape)), dtype=torch.float32)
            .reshape(shape) / 7 - 1).to(torch.bfloat16)


_leaf = st.sampled_from([
    lambda: torch.zeros((2, 3), dtype=torch.float32),
    lambda: torch.arange(5, dtype=torch.int32),
    lambda: torch.ones((1,), dtype=torch.float64),
    lambda: torch.tensor(7, dtype=torch.int64),
    lambda: _bf16(3, 2),
])


@st.composite
def _trees(draw, depth=2):
    if depth == 0:
        return draw(_leaf)()
    kind = draw(st.sampled_from(["leaf", "dict", "list", "tuple"]))
    if kind == "leaf":
        return draw(_leaf)()
    n = draw(st.integers(1, 3))
    if kind == "dict":
        keys = draw(st.lists(st.sampled_from("abcdef"), min_size=n,
                             max_size=n, unique=True))
        return {k: draw(_trees(depth=depth - 1)) for k in keys}
    seq = [draw(_trees(depth=depth - 1)) for _ in range(n)]
    return seq if kind == "list" else tuple(seq)


def _same(a, b):
    a_leaves, a_def = tm.tree_flatten(a)
    b_leaves, b_def = tm.tree_flatten(b)
    assert a_def == b_def
    for x, y in zip(a_leaves, b_leaves):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@given(tree=_trees())
@settings(max_examples=25, deadline=None)
def test_checkpoint_roundtrip(tree, tmp_path_factory):
    path = tmp_path_factory.mktemp("rt") / "ckpt.npz"
    tck.save_pytree(str(path), tree, metadata={"round": 3})
    _same(tck.load_pytree(str(path)), tree)
    assert tck.load_metadata(str(path)) == {"round": 3}


def _jax_tree():
    return {"blocks": {"w": jnp.asarray(np.linspace(-2, 2, 12)
                                        .reshape(3, 4), jnp.bfloat16),
                       "b": jnp.arange(4, dtype=jnp.float32)},
            "seq": [jnp.ones((2,), jnp.float16), (jnp.int32(5),)],
            "embed": jnp.asarray(np.arange(6).reshape(2, 3), jnp.int32)}


def _port_tree():
    return {"blocks": {"w": torch.linspace(-2, 2, 12).reshape(3, 4).to(
                           torch.bfloat16),
                       "b": torch.arange(4, dtype=torch.float32)},
            "seq": [torch.ones((2,), dtype=torch.float16),
                    (torch.tensor(5, dtype=torch.int32),)],
            "embed": torch.arange(6, dtype=torch.int32).reshape(2, 3)}


def test_jax_written_file_reads_in_the_port_bitwise(tmp_path):
    path = str(tmp_path / "j.npz")
    jtree = _jax_tree()
    jstore.save_pytree(path, jtree, metadata={"round": 9, "arch": "x"})
    got = tck.load_pytree(path)
    assert got["blocks"]["w"].dtype == torch.bfloat16
    want_bits = np.asarray(jtree["blocks"]["w"]).view(np.uint16)
    np.testing.assert_array_equal(
        got["blocks"]["w"].view(torch.int16).numpy().view(np.uint16),
        want_bits)
    for t, j in zip(tm.tree_leaves(got), jax.tree_util.tree_leaves(jtree)):
        if t.dtype != torch.bfloat16:
            assert np.dtype(str(t.numpy().dtype)) == np.asarray(j).dtype
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tck.load_metadata(path) == {"round": 9, "arch": "x"}


def test_port_written_file_reads_in_jax_as_its_own(tmp_path):
    """Same zip entries in the same order, the same manifest bytes, and
    every leaf the same dtype and bytes as the JAX package's own file."""
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jstore.save_pytree(jp, _jax_tree(), metadata={"round": 2})
    tck.save_pytree(tp, _port_tree(), metadata={"round": 2})
    with zipfile.ZipFile(jp) as zj, zipfile.ZipFile(tp) as zt:
        assert zt.namelist() == zj.namelist()
        assert zt.read("__manifest__.npy") == zj.read("__manifest__.npy")
    with np.load(jp) as zj, np.load(tp) as zt:
        manifest = json.loads(bytes(zt["__manifest__"]).decode())
        assert manifest["keys"] == ["blocks/b", "blocks/w", "embed",
                                    "seq/0", "seq/1/0"]
        for k in manifest["keys"]:
            a, b = zt[f"leaf/{k}"], zj[f"leaf/{k}"]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    back = jstore.load_pytree(tp)
    want = jstore.load_pytree(jp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert jstore.load_metadata(tp) == {"round": 2}


def test_load_places_on_the_device(tmp_path):
    path = str(tmp_path / "c.npz")
    tck.save_pytree(path, _port_tree())
    got = tck.load_pytree(path, device="cpu")
    assert all(t.device.type == "cpu" for t in tm.tree_leaves(got))
    _same(got, _port_tree())


def test_checkpoint_manager_gc_and_latest(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest() is None and mgr.restore() is None
    for r in (1, 2, 3, 4):
        path = mgr.save(r, {"w": torch.full((2,), float(r)),
                            "h": torch.full((2,), float(r)).to(
                                torch.bfloat16)}, metadata={"tag": "x"})
        assert path.endswith(f"ckpt_{r}.npz")
    assert mgr.latest().endswith("ckpt_4.npz")
    restored = mgr.restore()
    assert torch.equal(restored["w"], torch.full((2,), 4.0))
    assert restored["h"].dtype == torch.bfloat16
    assert mgr._rounds() == [3, 4]
    assert tck.load_metadata(mgr.latest()) == {"tag": "x", "round": 4}
    # the JAX manager sees the port's files
    jm = jstore.CheckpointManager(str(tmp_path), keep=2)
    assert jm.latest() == mgr.latest()
    np.testing.assert_array_equal(jm.restore()["w"], np.full((2,), 4.0))


@pytest.mark.parametrize("keep", [1, 3])
def test_checkpoint_manager_keep_matches_jax(tmp_path, keep):
    """Rounds saved out of order: both managers keep the same newest
    ``keep``."""
    mgr = tck.CheckpointManager(str(tmp_path / "t"), keep=keep)
    jm = jstore.CheckpointManager(str(tmp_path / "j"), keep=keep)
    for r in (5, 1, 7, 3):
        mgr.save(r, {"w": torch.zeros(1)})
        jm.save(r, {"w": np.zeros(1, np.float32)})
        assert mgr._rounds() == jm._rounds()
    assert mgr._rounds() == [3, 5, 7][-keep:]
