"""Decoder-LM assembly (the counterpart of ``repro/models/transformer.py``)
for every family of the JAX package's zoo: dense (GQA), MoE with MLA
(deepseek), SSM (Mamba2), hybrid (parallel attention + SSM heads,
Hymba), and the VLM and audio backbones, whose front ends are stubs fed
precomputed patch or frame embeddings.

One ``TransformerConfig`` with every field of the JAX package's, so a
JAX config maps over one to one.  The blocks' params are stacked along a
leading layer axis, as the JAX package stacks them for ``lax.scan``, and
a dense-FFN prefix (``n_dense_layers``) is a list of blocks before them;
the port walks both in a Python loop, so a JAX ``init_lm`` tree carries
across as a copy (``repro_torch.bridge``) and each layer is a view.

Entry points:
    init_lm(cfg, seed, device)                 -> params
    lm_forward(params, cfg, batch)             -> (logits, aux, hidden)
    lm_loss(params, cfg, batch)                -> (loss, metrics)
    init_decode_cache(cfg, batch, max_len)     -> cache
    prefill(params, cfg, batch, max_len)       -> (logits_last, cache, S)
    decode_step(params, cfg, token, cache, cache_len) -> (logits, cache)

``cache_len`` is a host int: the decode loop knows it, and the attention
kernel takes it (and each layer's window) as a launch argument, so no
step waits on the device.  The cache is updated in place.  LoRA
adapters (``lora_rank``) ride on every attention and MLP linear of the
GQA blocks; MLA, the experts and the shared experts take none, as in
the JAX package.  Training runs the plain attention
(``attn_impl="xla"``): the attention kernel has no backward, as in the
JAX package.  ``remat`` is ignored: it trades memory for recompute and
changes no number.

Tensor parallelism: each entry point takes an optional ``tp`` (a
``sharding.tensor_parallel.TPContext``; None on one rank).  With it the
params are a rank's model-local tree and the blocks (deepseek's
dense-FFN prefix and MTP block too) compute its share of the heads (GQA
or MLA), the MLP, the experts and the SSM heads, Megatron style (a
hybrid block reduces its split branches' partial outputs at once and
adds a whole branch after the reduce); the vocabulary's embedding (the
VLM's text tokens too) and cross-entropy (per codebook for audio) run
vocabulary-parallel, and ``prefill`` / ``decode_step`` gather the
logits whole.  ``lm_forward`` and ``lm_loss`` also take
an optional ``group`` (a ``sharding.batch_group.BatchGroup``: the pod's
ranks over which the batch is split), over which each MoE layer takes
its capacity, its slots and its aux loss (``layers.moe``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.layers import (
    FULL_WINDOW, AttnConfig, MLAConfig, MoEConfig, attention, gen_device,
    init_attention, init_linear, init_mla, init_mlp, init_moe, init_rmsnorm,
    linear, mla_attention, mlp, moe, normal_init, rmsnorm)
from repro_torch.models.ssm import (
    SSMConfig, init_ssm, init_ssm_state, ssm_decode_step, ssm_forward)
from repro_torch.sharding import tensor_parallel as tpl
from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import Device, resolve_device, seeded_generator

Pytree = Any


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # attention variant
    attention: str = "gqa"               # gqa | mla | none
    window: Optional[int] = None         # sliding-window size (SWA layers)
    global_attn_layers: Tuple[int, ...] = ()
    # MLA
    kv_lora_rank: int = 0
    q_lora_rank: Optional[int] = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    n_dense_layers: int = 0
    router_scoring: str = "softmax"
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_n_groups: int = 1
    ssm_chunk: int = 128
    # multi-token prediction
    mtp: bool = False
    mtp_loss_weight: float = 0.3
    # PEFT
    lora_rank: int = 0
    # input handling
    input_mode: str = "tokens"           # tokens | vlm | embeddings
    n_prefix_tokens: int = 0
    n_codebooks: int = 1
    # numerics / impl (the JAX package's sharding and scan knobs are kept
    # so configs map over; the port ignores them)
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    attn_impl: str = "xla"
    ssd_impl: str = "xla"
    scan_unroll: Any = 1
    shard_activations: bool = False
    batch_axes: Tuple[str, ...] = ("data",)
    remat: bool = False
    norm_eps: float = 1e-6
    logit_dtype: Any = torch.float32

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, window=self.window,
            attn_impl=self.attn_impl, lora_rank=self.lora_rank)

    def mla_cfg(self) -> MLAConfig:
        return MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            kv_lora_rank=self.kv_lora_rank, q_lora_rank=self.q_lora_rank,
            qk_nope_dim=self.qk_nope_dim, qk_rope_dim=self.qk_rope_dim,
            v_head_dim=self.v_head_dim, rope_theta=self.rope_theta)

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model, n_experts=self.n_experts, top_k=self.top_k,
            d_ff_expert=self.d_ff_expert, n_shared=self.n_shared_experts,
            d_ff_shared=self.d_ff_shared,
            capacity_factor=self.capacity_factor,
            router_scoring=self.router_scoring,
            aux_loss_coef=self.aux_loss_coef)

    def ssm_cfg(self) -> SSMConfig:
        return SSMConfig(
            d_model=self.d_model, d_state=self.ssm_state,
            head_dim=self.ssm_head_dim, expand=self.ssm_expand,
            n_groups=self.ssm_n_groups, chunk=self.ssm_chunk,
            ssd_impl=self.ssd_impl)

    @property
    def has_attn(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_ffn(self) -> bool:
        return self.d_ff > 0 or self.is_moe

    def validate(self) -> None:
        if self.arch_type not in ("dense", "moe", "ssm", "hybrid", "vlm",
                                  "audio"):
            raise ValueError(f"unknown arch_type {self.arch_type!r}")
        if self.has_attn and self.attention == "gqa" and \
                self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("GQA head mismatch")
        if self.is_moe and not 0 < self.top_k <= self.n_experts:
            raise ValueError("top_k must lie in (0, n_experts]")
        if self.arch_type == "ssm" and self.ssm_state <= 0:
            raise ValueError("an ssm arch needs ssm_state > 0")


# ---------------------------------------------------------------------------
# block init / apply
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: TransformerConfig, moe_layer: bool) -> Pytree:
    pd, dev = cfg.param_dtype, gen_device(gen)
    p: Dict[str, Pytree] = {}
    if cfg.has_attn:
        p["attn_norm"] = init_rmsnorm(cfg.d_model, pd, dev)
        if cfg.attention == "mla":
            p["attn"] = init_mla(gen, cfg.mla_cfg(), pd)
        else:
            p["attn"] = init_attention(gen, cfg.attn_cfg(), pd)
    if cfg.has_ssm:
        if cfg.arch_type == "ssm":
            p["ssm_norm"] = init_rmsnorm(cfg.d_model, pd, dev)
        p["ssm"] = init_ssm(gen, cfg.ssm_cfg(), pd)
    if cfg.has_ffn:
        p["ffn_norm"] = init_rmsnorm(cfg.d_model, pd, dev)
        if moe_layer:
            p["moe"] = init_moe(gen, cfg.moe_cfg(), pd)
        elif cfg.d_ff > 0:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, pd,
                                lora_rank=cfg.lora_rank)
    return p


def _block_apply(p: Pytree, x: torch.Tensor, cfg: TransformerConfig,
                 positions: torch.Tensor, moe_layer: bool,
                 is_global: Optional[bool] = None,
                 cache: Optional[Pytree] = None,
                 cache_len: Optional[int] = None, tp=None, group=None):
    """One decoder block.  Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, Pytree] = {}

    if cfg.arch_type == "hybrid":
        # Hymba: attention heads and mamba heads consume the same normed
        # input in parallel; outputs are averaged (arXiv:2411.13676 eq. 3).
        # Under tp each split branch gives its rank's partial output: when
        # both split, the SSM's rides into the attention's one reduce;
        # a whole branch is added once, after the reduce
        xn = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        both = tp is not None and tp.plan.ssm and tp.plan.attn
        ssm_out, ssm_cache = _run_ssm(p["ssm"], xn, cache, cfg, tp,
                                      reduce=not both)
        attn_out, kv = _run_attention(p, xn, cfg, positions, is_global,
                                      cache["kv"] if cache else None,
                                      cache_len, tp,
                                      row_extra=ssm_out if both else None)
        if cache is not None:
            new_cache["ssm"] = ssm_cache
        new_cache["kv"] = kv
        x = x + 0.5 * (attn_out if both else attn_out + ssm_out)
    elif cfg.arch_type == "ssm":
        xn = rmsnorm(p["ssm_norm"], x, cfg.norm_eps)
        out, ssm_cache = _run_ssm(p["ssm"], xn, cache, cfg, tp)
        if cache is not None:
            new_cache["ssm"] = ssm_cache
        x = x + out
    else:
        xn = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        attn_out, new_cache["kv"] = _run_attention(
            p, xn, cfg, positions, is_global,
            cache["kv"] if cache else None, cache_len, tp)
        x = x + attn_out

    if cfg.has_ffn:
        xn = rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
        if moe_layer:
            out, aux = moe(p["moe"], xn, cfg.moe_cfg(), tp, group)
        else:
            out = mlp(p["mlp"], xn, tp)
        x = x + out
    return x, new_cache, aux


def _run_ssm(ssm_params, xn, cache, cfg: TransformerConfig, tp=None,
             reduce: bool = True):
    """The SSM branch: ``(out, new state or None)``, uncached or cached
    (a single token updates the recurrent state; a multi-token call,
    prefill, runs the chunked scan and emits the final state for the
    decode steps that follow); under ``tp`` the rank's heads, ``reduce``
    False leaving its partial output."""
    scfg = cfg.ssm_cfg()
    if cache is None:
        return ssm_forward(ssm_params, xn, scfg, tp=tp, reduce=reduce), None
    state = cache["ssm"]
    if xn.shape[1] == 1:
        return ssm_decode_step(ssm_params, xn, state, scfg, tp=tp,
                               reduce=reduce)
    out, (final, conv_tail) = ssm_forward(ssm_params, xn, scfg,
                                          return_final_state=True, tp=tp,
                                          reduce=reduce)
    return out, (final, conv_tail.to(state[1].dtype))


def _run_attention(p, xn, cfg: TransformerConfig, positions, is_global,
                   kv_cache, cache_len, tp=None, row_extra=None):
    if cfg.attention == "mla":
        return mla_attention(p["attn"], xn, cfg.mla_cfg(), positions,
                             kv_cache=kv_cache, cache_len=cache_len, tp=tp)
    acfg = cfg.attn_cfg()
    if cfg.window is not None and is_global is not None:
        # the layer's SWA/global choice: a "window" longer than any
        # sequence is full causal attention
        acfg = dataclasses.replace(
            acfg, window=FULL_WINDOW if is_global else cfg.window)
    return attention(p["attn"], xn, acfg, positions, kv_cache=kv_cache,
                     cache_len=cache_len, tp=tp, row_extra=row_extra)


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------

def init_lm(cfg: TransformerConfig, seed: int = 0,
            device: Device = None, *,
            gen: Optional[torch.Generator] = None) -> Pytree:
    """Params drawn on ``device`` (CUDA unless the caller asks for the
    CPU; ``"meta"`` draws nothing, for counting) from a generator on that
    device seeded with ``seed`` — or from ``gen``, on its device — with
    the JAX package's distributions: normal(0.02) embedding,
    normal(d_in^-0.5) linears, LoRA ``A``, router, experts (``w_down``:
    d_ff_expert^-0.5) and lm_head, zero LoRA ``B``, normal(d_conv^-0.5)
    conv, ``A_log = log(linspace(1, 16))``, the inverse-softplus
    ``dt_bias``.  Each stacked layer is drawn, then copied into its slot
    of the stack, so the device holds the stack and one layer at most."""
    cfg.validate()
    if gen is None:
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else seeded_generator(seed, dev)
    dev = gen_device(gen)
    pd = cfg.param_dtype
    params: Dict[str, Pytree] = {}
    if cfg.input_mode in ("tokens", "vlm"):
        params["embed"] = normal_init(gen, (cfg.vocab_size, cfg.d_model),
                                      std=0.02, dtype=pd)
    params["blocks"] = _init_stack(gen, cfg, cfg.n_layers - cfg.n_dense_layers)
    # the dense-FFN prefix (deepseek v2/v3's first layers)
    if cfg.n_dense_layers:
        params["dense_blocks"] = [_init_block(gen, cfg, moe_layer=False)
                                  for _ in range(cfg.n_dense_layers)]
    params["final_norm"] = init_rmsnorm(cfg.d_model, pd, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(
            gen, (cfg.d_model, cfg.vocab_size * cfg.n_codebooks),
            std=cfg.d_model ** -0.5, dtype=pd)
    if cfg.mtp:
        params["mtp"] = {
            "block": _init_block(gen, cfg, moe_layer=cfg.is_moe),
            "proj": init_linear(gen, 2 * cfg.d_model, cfg.d_model, dtype=pd),
            "norm_prev": init_rmsnorm(cfg.d_model, pd, dev),
            "norm_emb": init_rmsnorm(cfg.d_model, pd, dev),
        }
    return params


def _init_stack(gen, cfg: TransformerConfig, n: int) -> Pytree:
    """``n`` blocks stacked along a leading axis, drawn one at a time in
    layer order into a preallocated stack."""
    stack = None
    for i in range(n):
        block = _init_block(gen, cfg, moe_layer=cfg.is_moe)
        if stack is None:
            stack = tm.tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                                block)
        for dst, src in zip(tm.tree_leaves(stack), tm.tree_leaves(block)):
            dst[i].copy_(src)
    return stack


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed(params, cfg: TransformerConfig, tokens: torch.Tensor, tp=None):
    if tp is not None and tp.plan.vocab:
        return tpl.vocab_embedding(params["embed"], tokens, tp).to(cfg.dtype)
    return params["embed"][tokens].to(cfg.dtype)


def _embed_inputs(params, cfg: TransformerConfig,
                  batch: Dict[str, torch.Tensor], tp=None):
    """Returns (x, positions, text_offset)."""
    if cfg.input_mode == "tokens":
        x = _embed(params, cfg, batch["tokens"], tp)
        offset = 0
    elif cfg.input_mode == "vlm":
        # stub front end: precomputed patch embeddings, then the tokens'
        pe = batch["patch_embeds"].to(cfg.dtype)             # (B, P, d)
        x = torch.cat([pe, _embed(params, cfg, batch["tokens"], tp)], dim=1)
        offset = pe.shape[1]
    elif cfg.input_mode == "embeddings":
        # audio stub: precomputed EnCodec frame embeddings
        x = batch["frame_embeds"].to(cfg.dtype)
        offset = 0
    else:
        raise ValueError(f"unknown input_mode {cfg.input_mode!r}")
    return x, torch.arange(x.shape[1], device=x.device), offset


def _global_flags(cfg: TransformerConfig) -> Optional[List[bool]]:
    """Per stacked layer: whether it is a global-attention layer (layer
    ids count the dense prefix)."""
    if cfg.window is None:
        return None
    return [i + cfg.n_dense_layers in cfg.global_attn_layers
            for i in range(cfg.n_layers - cfg.n_dense_layers)]


def _layer(tree: Pytree, i: int) -> Pytree:
    return tm.tree_map(lambda t: t[i], tree)


def _store(dst: Pytree, src: Pytree) -> None:
    """Write a layer's new cache into its views of the stacked cache
    (attention already wrote its k/v there in place)."""
    for d, s in zip(tm.tree_leaves(dst), tm.tree_leaves(src)):
        if not _same_storage(d, s):
            d.copy_(s)


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are one view of one storage (then the copy
    is a no-op).  Fake and meta tensors have no data pointer: their
    storages compare by identity."""
    if a.shape != b.shape or a.stride() != b.stride() or \
            a.storage_offset() != b.storage_offset():
        return False
    return a.untyped_storage()._cdata == b.untyped_storage()._cdata


def _run_blocks(params, cfg: TransformerConfig, x, positions,
                caches=None, cache_len=None, tp=None, group=None):
    """The dense prefix, then the stacked blocks, in order.  ``caches`` is
    None for a full-sequence pass, else ``{"dense": [one per prefix
    layer], "scan": stacked}``, updated in place.  Under ``tp`` the
    stacked leaves whose model ranks compute different parts
    (``TPContext.partial``) sum their gradient over ``model`` once.
    Returns (x, caches, total_aux)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["blocks"] if tp is None else \
        tp.sum_partial_grads(params["blocks"], "blocks/")
    for i in range(cfg.n_dense_layers):
        cache_l = caches["dense"][i] if caches is not None else None
        block = params["dense_blocks"][i] if tp is None else \
            tp.sum_partial_grads(params["dense_blocks"][i],
                                 f"dense_blocks/{i}/")
        x, new_cache, aux = _block_apply(
            block, x, cfg, positions, moe_layer=False,
            cache=cache_l, cache_len=cache_len, tp=tp)
        if caches is not None:
            _store(cache_l, new_cache)
        aux_total = aux_total + aux
    flags = _global_flags(cfg)
    for i in range(cfg.n_layers - cfg.n_dense_layers):
        cache_l = _layer(caches["scan"], i) if caches is not None else None
        x, new_cache, aux = _block_apply(
            _layer(blocks, i), x, cfg, positions,
            moe_layer=cfg.is_moe,
            is_global=None if flags is None else flags[i], cache=cache_l,
            cache_len=cache_len, tp=tp, group=group)
        if caches is not None:
            _store(cache_l, new_cache)
        aux_total = aux_total + aux
    return x, caches, aux_total


def _logits(params, cfg: TransformerConfig, x: torch.Tensor,
            tp=None) -> torch.Tensor:
    """The logits; under a ``tp`` that splits the vocabulary, this rank's
    columns of them (of the flattened ``(codebook, vocab)`` dim for
    several codebooks, not reshaped)."""
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    split = tp is not None and tp.plan.vocab
    if split:
        x = tpl.copy_to_model(x, tp)
    logits = torch.matmul(x, head.to(cfg.dtype))
    if cfg.n_codebooks > 1 and not split:
        logits = _codebooks(cfg, logits)
    return logits.to(cfg.logit_dtype)


def _codebooks(cfg: TransformerConfig, logits: torch.Tensor) -> torch.Tensor:
    B, S, _ = logits.shape
    return logits.reshape(B, S, cfg.n_codebooks, cfg.vocab_size)


def lm_forward(params, cfg: TransformerConfig,
               batch: Dict[str, torch.Tensor], tp=None, group=None):
    """Full-sequence forward -> (logits, aux_loss, hidden); under ``tp``
    the logits are this rank's vocabulary columns."""
    x, positions, _ = _embed_inputs(params, cfg, batch, tp)
    x, _, aux = _run_blocks(params, cfg, x, positions, tp=tp, group=group)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x, tp), aux, x


def _xent(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -1):
    """Cross-entropy with ignore-label masking over logits ``(..., V)``,
    the log-sum-exp in f32: ``(mean nll over the kept labels, mask)``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels.long(), min=0)[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0), mask


def lm_loss(params, cfg: TransformerConfig,
            batch: Dict[str, torch.Tensor], tp=None, group=None):
    """Next-token loss.  ``batch["labels"]``, label −1 ignored: (B, S) —
    (B, S, n_codebooks) for audio; in vlm mode (B, S_text), the image
    prefix's positions left out.  The MoE aux loss is added, and under
    ``mtp`` the multi-token loss times ``mtp_loss_weight``.  Returns
    ``(loss, metrics)``; under ``tp`` the cross-entropy is
    vocabulary-parallel."""
    logits, aux, hidden = lm_forward(params, cfg, batch, tp, group)
    if cfg.input_mode == "vlm":
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    loss = _cross_entropy(logits, batch["labels"], tp)
    metrics = {"xent": loss, "aux": aux}
    total = loss + aux
    if cfg.mtp:
        metrics["mtp"] = _mtp_loss(params, cfg, batch, hidden, tp, group)
        total = total + cfg.mtp_loss_weight * metrics["mtp"]
    metrics["loss"] = total
    return total, metrics


def _cross_entropy(logits, labels, tp=None):
    """``_xent``, vocabulary-parallel under a ``tp`` that splits the
    vocabulary."""
    if tp is not None and tp.plan.vocab:
        return tpl.vocab_cross_entropy(logits, labels, tp)[0]
    return _xent(logits, labels)[0]


def _mtp_loss(params, cfg: TransformerConfig, batch, hidden, tp=None,
              group=None):
    """DeepSeek-V3 multi-token prediction (depth 1): the trunk's hidden
    state at position i and the embedding of token i+1 go through one
    extra block to predict token i+2.  Under ``tp`` the block splits as
    the trunk's do, and ``proj`` column-parallel, gathered whole."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    mp = params["mtp"]
    h_prev = rmsnorm(mp["norm_prev"], hidden[:, :S - 1])
    emb_next = rmsnorm(mp["norm_emb"], _embed(params, cfg, tokens[:, 1:], tp))
    h = torch.cat([h_prev, emb_next], dim=-1)
    if tp is not None and tp.plan.mtp:      # column-parallel, gathered
        h = tpl.gather_from_model(
            linear(mp["proj"], tpl.copy_to_model(h, tp)), tp)
    else:
        h = linear(mp["proj"], h)
    positions = torch.arange(S - 1, device=h.device)
    block = mp["block"] if tp is None else \
        tp.sum_partial_grads(mp["block"], "mtp/block/")
    h, _, _ = _block_apply(block, h, cfg, positions, moe_layer=cfg.is_moe,
                           tp=tp, group=group)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _cross_entropy(_logits(params, cfg, h, tp), batch["labels"][:, 1:],
                          tp)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def _layer_cache_struct(cfg: TransformerConfig, batch: int, max_len: int,
                        device, n: Optional[int] = None, tp=None):
    """The cache of one block, or of ``n`` stacked blocks (a leading
    layer axis): k/v rows (under a ``tp`` that splits the heads, the kv
    heads this rank reads), MLA's latent rows and rope keys, SSM state
    (under a ``tp`` that splits the SSM heads, the rank's heads and conv
    channels)."""
    lead = () if n is None else (n,)

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)
    c: Dict[str, Any] = {}
    if cfg.has_attn:
        if cfg.attention == "mla":
            c["kv"] = (zeros(batch, max_len, cfg.kv_lora_rank),
                       zeros(batch, max_len, cfg.qk_rope_dim))
        else:
            hd, KH = cfg.resolved_head_dim, cfg.n_kv_heads
            if tp is not None and tp.plan.attn:
                KH = tp.kv_range[1]
            c["kv"] = tuple(zeros(batch, max_len, KH, hd) for _ in range(2))
    if cfg.has_ssm:
        one = init_ssm_state(cfg.ssm_cfg(), batch, cfg.dtype, device, tp)
        c["ssm"] = tuple(zeros(*t.shape, dtype=t.dtype) for t in one)
    return c


def init_decode_cache(cfg: TransformerConfig, batch: int, max_len: int,
                      device: Device = None, tp=None):
    dev = resolve_device(device)
    return {"dense": [_layer_cache_struct(cfg, batch, max_len, dev)
                      for _ in range(cfg.n_dense_layers)],
            "scan": _layer_cache_struct(cfg, batch, max_len, dev,
                                        cfg.n_layers - cfg.n_dense_layers,
                                        tp)}


def _whole_logits(params, cfg: TransformerConfig, x, tp=None):
    logits = _logits(params, cfg, x, tp)
    if tp is not None and tp.plan.vocab:
        logits = tpl.gather_vocab(logits, tp)
        if cfg.n_codebooks > 1:
            logits = _codebooks(cfg, logits)
    return logits


def prefill(params, cfg: TransformerConfig, batch: Dict[str, torch.Tensor],
            max_len: int, tp=None):
    """Process the prompt and build the decode cache.  Returns
    (last-position logits (B, 1, V), cache, prompt_len)."""
    x, positions, _ = _embed_inputs(params, cfg, batch, tp)
    S = x.shape[1]
    caches = init_decode_cache(cfg, x.shape[0], max_len, device=x.device,
                               tp=tp)
    # a full-sequence pass that writes k/v into the preallocated cache
    x, caches, _ = _run_blocks(params, cfg, x, positions, caches=caches,
                               cache_len=0, tp=tp)
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _whole_logits(params, cfg, x, tp), caches, S


def decode_step(params, cfg: TransformerConfig, token: torch.Tensor,
                caches, cache_len: int, tp=None):
    """One decode step.  token: (B, 1) int64, or (B, 1, d) frame
    embeddings for the audio stub; cache_len: the host count of valid
    cache positions.  Returns (logits (B, 1, V[, n_codebooks]), caches),
    the cache updated in place."""
    if cfg.input_mode == "embeddings":
        x = token.to(cfg.dtype)
    else:
        x = _embed(params, cfg, token, tp)
    positions = torch.arange(cache_len, cache_len + 1, device=x.device)
    x, caches, _ = _run_blocks(params, cfg, x, positions, caches=caches,
                               cache_len=cache_len, tp=tp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _whole_logits(params, cfg, x, tp), caches
