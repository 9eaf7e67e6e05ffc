"""``repro_torch.sharding.rules`` and ``utils.flatten.ShardedFlatView``
against the JAX package's, on the CPU.

The rules read only a mesh's ``axis_names``, ``devices.shape`` and
``shape``, so both packages are given the same stand-in meshes (no
devices are needed): ``(1, 1)``, ``(2, 2)``, ``(4, 4)`` over
``("data", "model")`` and ``(2, 4, 4)`` over ``("pod", "data",
"model")``, under every layout.  Trees: LeNet-5, and the reduced
qwen1.5-0.5b, hymba-1.5b and mamba2-1.3b configs (shapes from
``jax.eval_shape``).  PartitionSpecs compare as tuples; the sharded
buffers of the same numpy tree compare bitwise (bf16 by bit pattern),
and ``unflatten`` gives the tree back bitwise.
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import ml_dtypes
from repro.configs import get_reduced as jget_reduced
from repro.fl.task import vision_task as j_vision_task
from repro.models import transformer as JT
from repro.sharding import rules as jrules
from repro_torch import bridge
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x4": ((4, 4), ("data", "model")),
    "2x4x4": ((2, 4, 4), ("pod", "data", "model")),
}
TREES = ("lenet5", "qwen1.5-0.5b", "hymba-1.5b", "mamba2-1.3b")


def _mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                                 shape=dict(zip(axes, shape)))


@functools.lru_cache(maxsize=None)
def _shapes(tree: str):
    """The tree's leaf shapes and dtypes (a JAX ShapeDtypeStruct tree)."""
    if tree == "lenet5":
        task = j_vision_task("lenet5", n_classes=10, in_ch=3)
        return jax.eval_shape(task.init, jax.random.PRNGKey(0))
    cfg = jget_reduced(tree)
    return jax.eval_shape(lambda k: JT.init_lm(k, cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _numpy_tree(tree: str):
    """A numpy tree of those shapes, values from a seed."""
    rng = np.random.default_rng(7)

    def leaf(s):
        a = rng.standard_normal(s.shape).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if s.dtype == jax.numpy.bfloat16 \
            else a.astype(s.dtype)
    return jax.tree_util.tree_map(leaf, _shapes(tree))


def _as_tuples(spec_tree_leaves):
    return [tuple(s) for s in spec_tree_leaves]


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("layout", rules.LAYOUTS)
def test_param_pspecs_and_buffers_match_jax(tree, mesh, layout):
    jm, m = _mesh(mesh), _mesh(mesh)
    np_tree = _numpy_tree(tree)
    t_tree = bridge.params_from_numpy(np_tree)
    jspecs = jax.tree_util.tree_leaves(
        jrules.param_pspecs(_shapes(tree), jm, layout),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tspecs, _ = tm.tree_flatten(rules.param_pspecs(t_tree, m, layout),
                                is_leaf=rules.is_pspec)
    assert _as_tuples(tspecs) == _as_tuples(jspecs)

    jview = jrules.sharded_flat_view(_shapes(tree), jm, layout)
    tview = rules.sharded_flat_view(t_tree, m, layout)
    assert [(g.name, g.dtype, g.axes, g.n_shards, g.size)
            for g in tview.groups] == \
        [(g.name, g.dtype, g.axes, g.n_shards, g.size) for g in jview.groups]
    assert [(s.buffer, s.offset, s.size, s.shape, s.dim_axes)
            for s in tview.slots] == \
        [(s.buffer, s.offset, s.size, s.shape, s.dim_axes)
         for s in jview.slots]
    for tg, jg in zip(tview.groups, jview.groups):
        assert tuple(rules.flat_buffer_pspec(tg)) == \
            tuple(jrules.flat_buffer_pspec(jg))

    jbufs = jview.flatten(jax.tree_util.tree_map(jax.numpy.asarray, np_tree))
    tbufs = tview.flatten(t_tree)
    assert list(tbufs) == list(jbufs)
    for name, jb in jbufs.items():
        got = bridge.params_to_numpy({"b": tbufs[name]})["b"]
        want = np.asarray(jb)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), name
    back = tview.unflatten(tbufs)
    for a, b in zip(tm.tree_leaves(back), tm.tree_leaves(t_tree)):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("mesh", MESHES)
def test_local_rows_pick_each_ranks_tile(mesh):
    """The row a rank holds is its row-major index over the group's axes;
    stacking every rank's rows in rank order over those axes gives the
    buffer back."""
    m = _mesh(mesh)
    t_tree = bridge.params_from_numpy(_numpy_tree("qwen1.5-0.5b"))
    view = rules.sharded_flat_view(t_tree, m, "fsdp_tp")
    shape, axes = MESHES[mesh]
    for g in view.groups:
        rows = []
        for coord in np.ndindex(*shape):
            c = dict(zip(axes, coord))
            if any(c[a] for a in axes if a not in g.axes):
                continue
            rows.append(view.local_rows(c)[g.name])
        assert rows == list(range(g.n_shards)), g.name


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_client_and_lane_pspecs_match_jax(mesh):
    jm, m = _mesh(mesh), _mesh(mesh)
    for rank in range(1, 6):
        for batch_axis in (0, 1, 2):
            assert tuple(rules.fl_batch_pspec(m, rank, batch_axis)) == \
                tuple(jrules.fl_batch_pspec(jm, rank, batch_axis))
        for n in (1, 2, 3, 4, 6, 8, 100):
            assert tuple(rules.client_axis_pspec(m, rank, n)) == \
                tuple(jrules.client_axis_pspec(jm, rank, n))
        assert tuple(rules.lane_axis_pspec(rank)) == \
            tuple(jrules.lane_axis_pspec(rank))
    assert rules.mesh_axis_size(m, "data") == jrules.mesh_axis_size(jm, "data")
    assert rules.mesh_axis_size(m, "pod") == jrules.mesh_axis_size(jm, "pod")


def test_vision_models_replicate_to_the_host_layout():
    """On every mesh and layout the paper's vision models pack into one
    replicated f32 row: the host FlatView's buffer."""
    from repro_torch.utils.flatten import FlatView
    t_tree = bridge.params_from_numpy(_numpy_tree("lenet5"))
    flat = FlatView.of(t_tree).flatten(t_tree)
    for mesh in MESHES:
        for layout in rules.LAYOUTS:
            view = rules.sharded_flat_view(t_tree, _mesh(mesh), layout)
            assert [g.axes for g in view.groups] == [()]
            local = view.local_view()
            assert local == FlatView.of(t_tree)
            assert torch.equal(view.flatten(t_tree)["float32"][0],
                               flat["float32"])


def test_sharded_groups_and_filters_raise_naming_their_items():
    """Sharded groups (M13b) are ported: a rank's view is the per-shard
    layout, each slot its leaf's local tile; the filters (M11) are
    ported: a filter splits the view into trainable and frozen groups
    (as the JAX package's), and one that selects no leaf raises."""
    t_tree = bridge.params_from_numpy(_numpy_tree("qwen1.5-0.5b"))
    view = rules.sharded_flat_view(t_tree, _mesh("2x2"), "fsdp_tp")
    local = view.local_view()
    assert local.buffer_sizes == {g.name: g.size for g in view.groups}
    for s, ls in zip(view.slots, local.slots):
        n = view.group_map[s.buffer].n_shards
        assert int(np.prod(ls.shape)) * n == int(np.prod(s.shape)), s
    head = rules.sharded_flat_view(t_tree, _mesh("1x1"), filter_spec="head")
    jhead = jrules.sharded_flat_view(_numpy_tree("qwen1.5-0.5b"),
                                     _mesh("1x1"), filter_spec="head")
    assert [(g.name, g.size) for g in head.groups] == \
        [(g.name, g.size) for g in jhead.groups]
    assert head.frozen_groups and head.local_view().frozen_sizes
    with pytest.raises(ValueError, match="matches zero leaves"):
        rules.sharded_flat_view(t_tree, _mesh("1x1"), filter_spec="lora")
