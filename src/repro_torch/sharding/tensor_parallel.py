"""Tensor-parallel compute over the mesh's ``model`` axis, Megatron style.

The counterpart of what XLA's SPMD partitioner does for the JAX package
when it jits a step under ``rules.param_pspecs``' ``fsdp_tp`` shardings:
the ranks of a ``model`` group split the heads, the MLP, the experts,
the SSM heads and the vocabulary of each step instead of each computing
the whole model.

A rank keeps its own ``model`` tile of the leaves the rules shard over
``model`` (``TPContext.local``): the q heads (and the kv heads, when
|model| divides them, else the kv projections' columns, gathered whole
after the GEMM) and their biases, MLA's per-head projections
(``wq`` or ``wq_b``, ``wkv_b``, the rows of ``wo``) and the columns of
its latent projections (``wq_a``, ``wkv_a``), the MLP's columns, the
rows of the out-projections, the experts of each MoE layer and the
shared experts' columns and rows, the SSM's ``in_proj`` columns (the
rules' tile, which packs z, x, B, C and dt and so is not the rank's
heads: its output is gathered whole),
the vocabulary of ``embed`` and ``lm_head`` (for several codebooks, the
rank's columns of the flattened ``(codebook, vocab)`` dim), the columns
of the MTP block's ``proj``, and the ``lora_b`` of the column-parallel
linears.  Everything else is whole on every rank of the group: MLA's
latent norms, the router, the SSM's conv, per-head vectors and
``out_proj`` (the rules shard its ``d_model`` columns over ``model``, so
its tile is not the rank's heads: a rank computes with its heads' rows
of the whole leaf).
:func:`plan` covers every family of the zoo; a part |model| does not
divide stays whole.

Six autograd functions carry the ``model`` collectives, each counted as
the pod's ``"tp"`` kind with its bytes (``repro_torch.fl.pod.COLLECTIVES``):

  * :func:`copy_to_model` — identity forward, all-reduce backward: the
    replicated input of a column-parallel linear (MLA's latents, an MoE
    layer's dispatch input and combine weights, the SSM's gathered
    in-projection), and a whole leaf whose ``model`` ranks compute
    different parts of its gradient (:meth:`TPContext.partial`:
    replicated kv projections, the per-head norms, the ``lora_a`` of a
    row-parallel linear, the SSM's conv, per-head vectors and
    ``out_proj``), so that
    every rank holds the whole gradient;
  * :func:`reduce_from_model` — all-reduce forward, identity backward:
    the partial output of a row-parallel linear or of a rank's experts,
    in its dtype (bf16 on the card, as Megatron reduces);
  * :func:`sum_over_model` — all-reduce forward and backward: a sum every
    rank reads whole (the Σx² of :func:`rmsnorm_over_model`, the SSM's
    gated norm over the whole ``d_inner``);
  * :func:`gather_from_model` — all-gather forward, the rank's columns
    backward: the output of a column-parallel linear that the next layer
    reads whole (MLA's latents, the MTP block's ``proj``, the SSM's
    in-projection);
  * :func:`vocab_embedding` — the lookup of the rank's vocabulary rows,
    zero outside them, then one all-reduce;
  * :func:`vocab_cross_entropy` — ``_xent`` over vocabulary-parallel
    logits, per codebook: the max, Σexp and the gold logit all-reduced in
    f32, the ignore label kept.

:class:`TPParams` is the model-local tree (``fl.pod.ShardedFlatOps``
builds it): a dict that carries its :class:`TPContext` to the model
(``fl.task.lm_task``, ``launch.steps``), and the batch group of a step
whose batch the pod splits (``sharding.batch_group``).
:func:`squared_distance` is FedProx's ‖w − w_g‖² over such trees.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.utils import tree_math as tm

Pytree = Any
MODEL = "model"


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Which parts of a block split over ``model`` ranks: the heads
    (|model| divides ``n_heads``; for GQA also divides ``n_kv_heads`` or
    is a multiple of it, so that a rank's q heads read whole kv groups or
    one kv head), the kv heads (|model| divides ``n_kv_heads``; else each
    rank computes the one kv head its q heads read: from its columns of
    the kv projections gathered whole where |model| divides their width,
    ``kv_cols``, else from the whole projections; MLA's heads split with
    its latent projections, whose
    widths |model| also divides), the MLP (divides ``d_ff``: the dense
    blocks and deepseek's dense-FFN prefix), the experts (divides
    ``n_experts`` and the shared experts' width), the vocabulary
    (divides ``n_codebooks × vocab_size`` with each rank's columns
    inside one codebook or whole codebooks), the MTP block's ``proj``
    (divides ``d_model``) and the SSM's heads (divides the SSM's head
    count and its in-projection's width, one group of B and C)."""
    attn: bool
    kv: bool
    mlp: bool
    vocab: bool
    experts: bool = False
    mtp: bool = False
    ssm: bool = False
    kv_cols: bool = False


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _vocab_splits(cfg, size: int) -> bool:
    total = cfg.vocab_size * cfg.n_codebooks
    if total % size:
        return False
    n = total // size
    return n % cfg.vocab_size == 0 or cfg.vocab_size % n == 0


def _ssm_splits(cfg, size: int) -> bool:
    if not cfg.has_ssm:
        return False
    sc = cfg.ssm_cfg()
    d_in_proj = 2 * sc.d_inner + 2 * sc.n_groups * sc.d_state + sc.n_heads
    return sc.n_groups == 1 and sc.n_heads % size == 0 and \
        d_in_proj % size == 0


def plan(cfg, size: int) -> Optional[TPPlan]:
    """The plan of ``cfg`` on ``size`` model ranks, or None: one rank, or
    a config none of whose parts |model| divides."""
    if size <= 1 or cfg.arch_type not in _FAMILIES \
            or (cfg.arch_type == "dense" and (cfg.is_moe or cfg.mtp)):
        return None
    if not cfg.has_attn or cfg.n_heads <= 0:
        attn = kv = False
    elif cfg.attention == "mla":
        attn = kv = cfg.n_heads % size == 0 and \
            (cfg.q_lora_rank or 0) % size == 0 and \
            (cfg.kv_lora_rank + cfg.qk_rope_dim) % size == 0
    else:
        kv = cfg.n_kv_heads % size == 0
        attn = cfg.n_heads % size == 0 and (kv or
                                            size % cfg.n_kv_heads == 0)
        kv = attn and kv
    shared = (cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared_experts) \
        if cfg.n_shared_experts else 0
    p = TPPlan(attn=attn, kv=kv, mlp=cfg.d_ff > 0 and cfg.d_ff % size == 0,
               vocab=_vocab_splits(cfg, size),
               experts=cfg.is_moe and cfg.n_experts % size == 0
               and shared % size == 0,
               mtp=cfg.mtp and cfg.d_model % size == 0,
               ssm=_ssm_splits(cfg, size),
               kv_cols=cfg.attention == "gqa" and attn and not kv and
               cfg.n_kv_heads * cfg.resolved_head_dim % size == 0)
    return p if any(dataclasses.astuple(p)) else None


# the blocks a plan splits: the trunk's stack, deepseek's dense-FFN
# prefix and its MTP block
_BLOCK = r"^(blocks|dense_blocks/\d+|mtp/block)/"
_LOCAL = {
    "attn": _BLOCK + r"attn/wq/(w|b|lora_b)$|" + _BLOCK +
    r"attn/(wq_a|wq_b|wkv_a|wkv_b|wo)/w$",
    "kv": _BLOCK + r"attn/(wk|wv)/(w|b|lora_b)$",
    "kv_cols": _BLOCK + r"attn/(wk|wv)/(w|b|lora_b)$",
    "mlp": _BLOCK + r"mlp/(w_gate|w_up)/(w|lora_b)$|" + _BLOCK +
    r"mlp/w_down/w$",
    "experts": _BLOCK + r"moe/experts/(w_gate|w_up|w_down)$|" + _BLOCK +
    r"moe/shared/(w_gate|w_up|w_down)/w$",
    "vocab": r"^(embed|lm_head)$",
    "mtp": r"^mtp/proj/w$",
    # in_proj's columns are the rules' tile of the packed (z, x, B, C,
    # dt), gathered after the GEMM
    "ssm": _BLOCK + r"ssm/in_proj/w$",
}
_PARTIAL = {
    # per-head norms on the local heads; the row-parallel lora_a's rows
    "attn": _BLOCK + r"attn/(q_norm|k_norm)/scale$|" + _BLOCK +
    r"attn/wo/lora_a$",
    # replicated kv (their width not divided): each rank computes the kv
    # heads its q heads read
    "kv_whole": _BLOCK + r"attn/(wk|wv)/(w|b|lora_b)$",
    "mlp": _BLOCK + r"mlp/w_down/lora_a$",
    # the conv over the rank's x channels and every B, C channel; the
    # per-head vectors, the gated norm's scale and out_proj's rows on the
    # rank's heads (the rules' "proj/w$" pattern shards out_proj's d_model
    # columns over model, not its heads: it is gathered whole)
    "ssm": _BLOCK + r"ssm/(conv_w|conv_b|A_log|D|dt_bias|out_norm/scale|"
    r"out_proj/w)$",
}


@dataclasses.dataclass(frozen=True, eq=False)
class TPContext:
    """One rank's view of its ``model`` group: the mesh (None for a
    layout that runs nothing), the group's size, this rank's coordinate
    on it, the plan, and the head, vocabulary, expert, SSM head and
    codebook counts."""
    mesh: Any
    size: int
    rank: int
    plan: TPPlan
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    n_experts: int = 0
    ssm_heads: int = 0
    n_codebooks: int = 1

    @property
    def group(self):
        """The ``model`` group's process group (made on first use)."""
        return self.mesh.group(MODEL)

    def _on(self, key: str) -> bool:
        if key == "kv_whole":
            return self.plan.attn and not self.plan.kv and \
                not self.plan.kv_cols
        return getattr(self.plan, key)

    def local(self, path: str) -> bool:
        """Whether the leaf at ``path`` stays this rank's ``model`` tile."""
        return any(self._on(k) and re.search(p, path)
                   for k, p in _LOCAL.items())

    def partial(self, path: str) -> bool:
        """Whether the leaf at ``path`` is whole on every rank while the
        ranks compute different parts of its gradient, which then sums
        over ``model`` (:func:`copy_to_model` on the leaf)."""
        return any(self._on(k) and re.search(p, path)
                   for k, p in _PARTIAL.items())

    # -- the local heads and vocabulary ---------------------------------

    @property
    def heads(self) -> int:
        """The q heads of this rank."""
        return self.n_heads // self.size

    @property
    def kv_range(self):
        """``(lo, n)``: the kv heads this rank's q heads read (one, when
        the kv projections stay whole)."""
        if self.plan.kv:
            n = self.n_kv_heads // self.size
            return self.rank * n, n
        return self.rank // (self.size // self.n_kv_heads), 1

    @property
    def vocab_range(self):
        """``(lo, n)``: this rank's columns of the flattened ``(codebook,
        vocab)`` dim (the vocabulary's rows for one codebook)."""
        n = self.vocab_size * self.n_codebooks // self.size
        return self.rank * n, n

    @property
    def ssm_range(self):
        """``(lo, n)``: the SSM heads of this rank."""
        n = self.ssm_heads // self.size
        return self.rank * n, n

    @property
    def expert_range(self):
        """``(lo, n)``: the experts of this rank."""
        n = self.n_experts // self.size
        return self.rank * n, n

    def sum_partial_grads(self, tree: Pytree, prefix: str = "") -> Pytree:
        """``tree`` with every :meth:`partial` leaf passed through
        :func:`copy_to_model`: each such gradient sums over the group
        once a step."""
        paths = tm.tree_paths(tree)
        leaves, treedef = tm.tree_flatten(tree)
        return tm.tree_unflatten(treedef, [
            copy_to_model(x, self) if self.partial(prefix + p) else x
            for p, x in zip(paths, leaves)])


def context(cfg, mesh) -> Optional[TPContext]:
    """The tensor-parallel context of ``cfg`` on ``mesh`` (a
    ``launch.mesh.Mesh``), or None when :func:`plan` gives none."""
    size = mesh.axis_size(MODEL)
    p = plan(cfg, size)
    if p is None:
        return None
    return TPContext(mesh=mesh, size=size,
                     rank=mesh.coords.get(MODEL, 0), plan=p,
                     n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                     vocab_size=cfg.vocab_size, n_experts=cfg.n_experts,
                     ssm_heads=cfg.ssm_cfg().n_heads if cfg.has_ssm else 0,
                     n_codebooks=cfg.n_codebooks)


class TPParams(dict):
    """A parameter tree (a dict) with its :class:`TPContext` (None: the
    whole leaves) and the batch group of a step whose batch is split
    (``sharding.batch_group.BatchGroup``; None: the rank's batch is the
    whole batch)."""

    def __init__(self, tree: dict, tp: Optional[TPContext], batch=None):
        super().__init__(tree)
        self.tp = tp
        self.batch = batch


def context_of(params) -> Optional[TPContext]:
    """The context a :class:`TPParams` carries (None for a plain tree)."""
    return getattr(params, "tp", None)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, tp: TPContext,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (or ``op``) over the group in place, counted "tp"."""
    from repro_torch.fl.pod import _count
    dist.all_reduce(t, op=op, group=tp.group)
    _count("tp", t.numel() * t.element_size())
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x.contiguous().clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Identity forward; the gradient summed over the group."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group; identity backward."""
    return _ReduceFromModel.apply(x, tp)


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_reduce(x.contiguous().clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.tp), None


def sum_over_model(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, which every rank
    then reads: the gradient of each rank's part is the sum of every
    rank's gradient of the total (all-reduce forward and backward)."""
    return _SumOverModel.apply(x, tp)


def rmsnorm_over_model(p, x: torch.Tensor, tp: TPContext,
                       eps: float = 1e-6) -> torch.Tensor:
    """``models.layers.rmsnorm`` over a dim split evenly over the group:
    ``x`` and ``p["scale"]`` are this rank's columns, the mean of squares
    is the whole dim's (Σx² in f32 through :func:`sum_over_model`)."""
    xf = x.float()
    ss = sum_over_model(torch.sum(torch.square(xf), dim=-1, keepdim=True),
                        tp)
    y = xf * torch.rsqrt(ss / (x.shape[-1] * tp.size) + eps)
    return (y * p["scale"].float()).to(x.dtype)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        from repro_torch.fl.pod import _count
        from repro_torch.launch.mesh import all_gather_into
        full = torch.empty((tp.size,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device)
        all_gather_into(full.reshape(-1), x.contiguous().reshape(-1),
                        tp.group)
        _count("tp", full.numel() * full.element_size())
        return full.movedim(0, -2).reshape(x.shape[:-1] + (-1,))

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.tp.size
        return g.narrow(-1, ctx.tp.rank * n, n).contiguous(), None


def gather_from_model(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Every rank's columns ``x`` ``(..., n)`` whole along the last dim, in
    rank order (one all-gather, counted "tp"); the backward takes this
    rank's columns of the gradient, which the consumers have summed
    (a :func:`copy_to_model` after it)."""
    return _GatherFromModel.apply(x, tp)


class _VocabEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens, tp):
        lo, n = tp.vocab_range
        ids = tokens.long() - lo
        inside = (ids >= 0) & (ids < n)
        ids = torch.where(inside, ids, torch.zeros_like(ids))
        ctx.save_for_backward(ids, inside)
        ctx.rows = table.shape[0]
        out = table[ids] * inside[..., None].to(table.dtype)
        return _all_reduce(out, tp)

    @staticmethod
    def backward(ctx, g):
        ids, inside = ctx.saved_tensors
        g = torch.where(inside[..., None], g, torch.zeros_like(g))
        gt = g.new_zeros((ctx.rows, g.shape[-1]))
        gt.index_add_(0, ids.reshape(-1), g.reshape(-1, g.shape[-1]))
        return gt, None, None


def vocab_embedding(table: torch.Tensor, tokens: torch.Tensor,
                    tp: TPContext) -> torch.Tensor:
    """``embed[tokens]`` from this rank's rows ``table`` of the
    vocabulary: a token outside them gives zero, then one all-reduce."""
    return _VocabEmbedding.apply(table, tokens, tp)


def _segments(tp: TPContext):
    """This rank's columns of the flattened ``(codebook, vocab)`` dim as
    ``(k, w, codebooks, offsets)``: ``k`` runs of ``w`` columns, run ``j``
    in codebook ``codebooks[j]`` from word ``offsets[j]`` (one run inside
    one codebook, or ``k`` whole codebooks: the plan's condition)."""
    lo, n = tp.vocab_range
    k = max(1, n // tp.vocab_size)
    w = n // k
    starts = [lo + j * w for j in range(k)]
    return k, w, [s // tp.vocab_size for s in starts], \
        [s % tp.vocab_size for s in starts]


class _VocabCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, tp, ignore):
        k, w, cbs, offs = _segments(tp)
        ncb = tp.n_codebooks
        lead = logits.shape[:-1]
        seg = logits.float().reshape(lead + (k, w))
        if ncb == 1:
            labels = labels[..., None]
        cb = torch.tensor(cbs, device=logits.device)

        def per_codebook(x, fill):
            """(..., k) per run -> (..., ncb), ``fill`` elsewhere."""
            if k == ncb:
                return x
            out = x.new_full(lead + (ncb,), fill)
            return out.index_copy_(-1, cb, x)
        m = _all_reduce(per_codebook(torch.amax(seg, dim=-1), -math.inf),
                        tp, dist.ReduceOp.MAX)
        mk = m if k == ncb else m.index_select(-1, cb)
        e = torch.exp(seg - mk[..., None])
        s = _all_reduce(per_codebook(torch.sum(e, dim=-1), 0.0), tp)
        lab = labels if k == ncb else labels.index_select(-1, cb)
        ids = lab.long() - torch.tensor(offs, device=logits.device)
        inside = (ids >= 0) & (ids < w) & (lab != ignore)
        ids = torch.where(inside, ids, torch.zeros_like(ids))
        gold = torch.gather(seg, -1, ids[..., None])[..., 0]
        gold = _all_reduce(per_codebook(torch.where(
            inside, gold, torch.zeros_like(gold)), 0.0), tp)
        sk = s if k == ncb else s.index_select(-1, cb)
        ctx.save_for_backward(e, sk, ids, inside, cb)
        ctx.shape = (ncb, k, logits.shape)
        nll = torch.log(s) + m - gold
        return nll[..., 0] if ncb == 1 else nll

    @staticmethod
    def backward(ctx, g):
        e, sk, ids, inside, cb = ctx.saved_tensors
        ncb, k, shape = ctx.shape
        if ncb == 1:
            g = g[..., None]
        elif k != ncb:
            g = g.index_select(-1, cb)
        grad = e / sk[..., None]
        grad.scatter_add_(-1, ids[..., None],
                          -inside[..., None].to(grad.dtype))
        return (grad * g[..., None]).reshape(shape), None, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        tp: TPContext, ignore: int = -1):
    """``models.transformer._xent`` over this rank's columns ``logits``
    ``(..., n)`` of the flattened ``(codebook, vocab)`` dim, labels
    ``(...)`` (one codebook) or ``(..., n_codebooks)``: ``(mean nll over
    the kept labels, mask)``, each codebook's log-sum-exp in f32 across
    the group (a codebook none of whose columns a rank holds adds −inf,
    0 and 0 there)."""
    nll = _VocabCrossEntropy.apply(logits, labels, tp, ignore)
    mask = (labels != ignore).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0), \
        mask


def gather_vocab(logits: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """The whole vocabulary's logits from every rank's columns: one
    all-gather over the group, counted "tp" (the serve steps' output)."""
    from repro_torch.fl.pod import _count
    from repro_torch.launch.mesh import all_gather_into
    full = torch.empty((tp.size,) + tuple(logits.shape), dtype=logits.dtype,
                       device=logits.device)
    all_gather_into(full.reshape(-1), logits.contiguous().reshape(-1),
                    tp.group)
    _count("tp", full.numel() * full.element_size())
    return full.movedim(0, -2).reshape(logits.shape[:-1] + (-1,))


# ---------------------------------------------------------------------------
# the linears
# ---------------------------------------------------------------------------

def column_linear(p: Pytree, x: torch.Tensor, xc: torch.Tensor,
                  tp: TPContext, cols: Optional[slice] = None,
                  dtype=None) -> torch.Tensor:
    """A column-parallel linear on this rank's output columns:
    ``xc·w + (α/r)·copy(x·A)·B + b`` in ``models.layers.linear``'s order,
    with ``xc`` the input after :func:`copy_to_model` (its gradient sums
    the ranks' columns) and ``x`` the same input before it: ``x·A`` is
    computed alike on every rank and passes :func:`copy_to_model`, so
    ``dA`` and the adapter's ``dx`` sum the output columns once.  ``cols``
    takes those columns of whole ``w``, ``b`` and ``B`` (the replicated
    kv projections)."""
    from repro_torch.models.layers import lora_scale

    def take(t):
        return t if cols is None else t[..., cols]
    dtype = dtype or x.dtype
    y = torch.matmul(xc, take(p["w"]).to(dtype))
    if "lora_a" in p:
        a, b = p["lora_a"].to(dtype), take(p["lora_b"]).to(dtype)
        z = copy_to_model(torch.matmul(x, a), tp)
        y = y + lora_scale(a.shape[-1]) * torch.matmul(z, b)
    if "b" in p:
        y = y + take(p["b"]).to(dtype)
    return y


def row_linear(p: Pytree, x: torch.Tensor, tp: TPContext,
               dtype=None, extra: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """A row-parallel linear from this rank's input columns ``x``:
    ``reduce(x·w) + (α/r)·reduce(x·A[rows])·B + b`` — the rank's rows of
    the whole ``A``, the whole ``B`` and the bias added once, after the
    reduce.  ``extra``, another partial output of this rank (the hybrid
    block's SSM branch), is added before the reduce: one all-reduce for
    both."""
    from repro_torch.models.layers import lora_scale
    dtype = dtype or x.dtype
    y = torch.matmul(x, p["w"].to(dtype))
    y = reduce_from_model(y if extra is None else y + extra, tp)
    if "lora_a" in p:
        n = x.shape[-1]
        a = p["lora_a"][tp.rank * n:(tp.rank + 1) * n].to(dtype)
        z = reduce_from_model(torch.matmul(x, a), tp)
        y = y + lora_scale(a.shape[-1]) * torch.matmul(z, p["lora_b"].to(
            dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


# ---------------------------------------------------------------------------
# FedProx's proximal distance
# ---------------------------------------------------------------------------

def squared_distance(params: Pytree, anchor: Dict[str, torch.Tensor],
                     tp: Optional[TPContext]) -> torch.Tensor:
    """‖params − anchor‖² over the model, ``anchor`` a leaf by path (a
    leaf it leaves out, frozen, adds exactly 0): without ``tp``
    ``tree_math.squared_norm`` of the difference, in its order, one leaf
    at a time; with it, over model-local leaves, the local leaves' sums
    over the group (:func:`reduce_from_model`: each tile's gradient is
    its own ``2(w − w_g)``) plus the whole leaves' once (each rank's own
    gradient, never summed over the group: a ``partial`` leaf's raw
    value, not the model's summed view)."""
    pairs = [(path, w, anchor[path]) for path, w in
             zip(tm.tree_paths(params), tm.tree_leaves(params))
             if path in anchor]
    if tp is None:
        return sum(torch.dot(d, d) for d in
                   ((w - g).reshape(-1) for _, w, g in pairs))
    local, whole = [], []
    for path, w, g in pairs:
        d = (w - g).reshape(-1)
        (local if tp.local(path) else whole).append(torch.dot(d, d))
    total = sum(whole)
    if local:
        total = total + reduce_from_model(sum(local), tp)
    return total
