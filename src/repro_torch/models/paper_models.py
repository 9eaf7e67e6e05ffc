"""The paper's evaluation models, in PyTorch.

The counterpart of ``repro/models/paper_models.py`` for LeNet-5,
ResNet-8, CNN-FEMNIST, CNN-Fashion, CharLSTM-256 and the two-layer
MLP.  The
parameter layout is the JAX package's, so weights carry across by copy
(``repro_torch.bridge``): the same dict keys, HWIO conv weights,
``(d_in, d_out)`` fc weights and NHWC activations at every public
function.  Inside ``conv2d`` the
activations are permuted to NCHW and the weights to OIHW for
``F.conv2d``; a "SAME" convolution pads as XLA does (a 5×5 at stride 1
by 2 each side; at stride 2 the odd pad goes after).  The flatten
before a classifier happens in NHWC order, as in the JAX package —
``f1["w"]``'s rows are in (H, W, C) order.

ResNet-8 is forward only, as in the JAX package: its param tree holds
an int ``stride`` leaf per block and the string ``norm_kind``, so the
engines, which train tensor leaves, refuse it with a ``TypeError``.

Each model is an (init, apply) pair over dict params:
``init(gen, n_classes, in_ch) -> params`` on ``gen``'s device (CharLSTM:
``init(gen, vocab, d_embed, d_hidden)``) and ``apply(params, x,
train=False, rng=None) -> logits``.  Only CNN-Fashion reads ``rng``
(its dropout): None draws nothing, a ``torch.Generator`` on ``x``'s
device draws the keep-mask, a tensor IS the keep-mask.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import he_normal, normal_init
from repro_torch.utils.registry import Registry

Pytree = Any
PAPER_MODELS: Registry = Registry("paper_model")


# ---------------------------------------------------------------------------
# conv/pool/fc primitives (NHWC at the boundary)
# ---------------------------------------------------------------------------

def init_conv(gen, k: int, c_in: int, c_out: int, dtype=torch.float32) -> Pytree:
    w = he_normal(gen, (k, k, c_in, c_out), fan_in=k * k * c_in, dtype=dtype)
    return {"w": w, "b": torch.zeros((c_out,), dtype=dtype, device=gen.device)}


def conv2d(p: Pytree, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC × HWIO → NHWC, "SAME" padding (odd square kernels)."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)          # HWIO → OIHW
    xc, k = x.permute(0, 3, 1, 2), w.shape[-1]
    if stride == 1:
        y = F.conv2d(xc, w, p["b"].to(x.dtype), padding=k // 2)
    else:
        # XLA's SAME: the total pad (out-1)·s + k - in, the odd one after
        pads = []
        for n in (xc.shape[3], xc.shape[2]):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads += [total // 2, total - total // 2]
        y = F.conv2d(F.pad(xc, pads), w, p["b"].to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)


def maxpool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k×k max pool, stride k, "VALID" (NHWC)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


def init_bn(gen, c: int, dtype=torch.float32) -> Pytree:
    return {"scale": torch.ones((c,), dtype=dtype, device=gen.device),
            "bias": torch.zeros((c,), dtype=dtype, device=gen.device)}


def batchnorm(p: Pytree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BN (batch statistics), in training and evaluation
    alike, as in the JAX package (running statistics are unreliable
    under non-IID clients)."""
    mu = torch.mean(x, dim=(0, 1, 2), keepdim=True)
    var = torch.var(x, dim=(0, 1, 2), keepdim=True, correction=0)
    xhat = (x - mu) * torch.rsqrt(var + eps)
    return xhat * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def groupnorm(p: Pytree, x: torch.Tensor, groups: int = 8,
              eps: float = 1e-5) -> torch.Tensor:
    N, H, W, C = x.shape
    g = math.gcd(groups, C)
    xg = x.reshape(N, H, W, g, C // g)
    mu = torch.mean(xg, dim=(1, 2, 4), keepdim=True)
    var = torch.var(xg, dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(N, H, W, C) * p["scale"].to(x.dtype) + \
        p["bias"].to(x.dtype)


def init_fc(gen, d_in: int, d_out: int, dtype=torch.float32) -> Pytree:
    return {"w": he_normal(gen, (d_in, d_out), fan_in=d_in, dtype=dtype),
            "b": torch.zeros((d_out,), dtype=dtype, device=gen.device)}


def fc(p: Pytree, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# LeNet-5 (CIFAR-10)
# ---------------------------------------------------------------------------

def lenet5_init(gen, n_classes: int = 10, in_ch: int = 3) -> Pytree:
    return {
        "c1": init_conv(gen, 5, in_ch, 6),
        "c2": init_conv(gen, 5, 6, 16),
        "f1": init_fc(gen, 16 * 8 * 8, 120),
        "f2": init_fc(gen, 120, 84),
        "f3": init_fc(gen, 84, n_classes),
    }


def lenet5_apply(p: Pytree, x: torch.Tensor, train: bool = False,
                 rng=None) -> torch.Tensor:
    x = maxpool(F.relu(conv2d(p["c1"], x)))
    x = maxpool(F.relu(conv2d(p["c2"], x)))
    x = _flatten_nhwc(x)
    x = F.relu(fc(p["f1"], x))
    x = F.relu(fc(p["f2"], x))
    return fc(p["f3"], x)


# ---------------------------------------------------------------------------
# ResNet-8 (CIFAR-100): conv stem + 3 basic blocks + linear
# ---------------------------------------------------------------------------

def _init_basic_block(gen, c_in: int, c_out: int, stride: int) -> Pytree:
    p = {"conv1": init_conv(gen, 3, c_in, c_out), "n1": init_bn(gen, c_out),
         "conv2": init_conv(gen, 3, c_out, c_out), "n2": init_bn(gen, c_out),
         "stride": stride}
    if stride != 1 or c_in != c_out:
        p["proj"] = init_conv(gen, 1, c_in, c_out)
    return p


def _basic_block(p: Pytree, x: torch.Tensor, norm_fn) -> torch.Tensor:
    s = p["stride"]
    h = F.relu(norm_fn(p["n1"], conv2d(p["conv1"], x, stride=s)))
    h = norm_fn(p["n2"], conv2d(p["conv2"], h))
    sc = conv2d(p["proj"], x, stride=s) if "proj" in p else x
    return F.relu(h + sc)


def resnet8_init(gen, n_classes: int = 100, in_ch: int = 3,
                 norm: str = "batch") -> Pytree:
    """The JAX package's tree: its int ``stride`` leaves and the string
    ``norm_kind`` ("batch" or "group") included."""
    return {
        "stem": init_conv(gen, 3, in_ch, 16),
        "stem_n": init_bn(gen, 16),
        "b1": _init_basic_block(gen, 16, 16, 1),
        "b2": _init_basic_block(gen, 16, 32, 2),
        "b3": _init_basic_block(gen, 32, 64, 2),
        "head": init_fc(gen, 64, n_classes),
        "norm_kind": norm,
    }


def resnet8_apply(p: Pytree, x: torch.Tensor, train: bool = False,
                  rng=None) -> torch.Tensor:
    norm_fn = batchnorm if p.get("norm_kind", "batch") == "batch" \
        else groupnorm
    x = F.relu(norm_fn(p["stem_n"], conv2d(p["stem"], x)))
    x = _basic_block(p["b1"], x, norm_fn)
    x = _basic_block(p["b2"], x, norm_fn)
    x = _basic_block(p["b3"], x, norm_fn)
    return fc(p["head"], avgpool_global(x))


# ---------------------------------------------------------------------------
# CNN-FEMNIST: 2 conv + 1 FC
# ---------------------------------------------------------------------------

def cnn_femnist_init(gen, n_classes: int = 62, in_ch: int = 1) -> Pytree:
    return {
        "c1": init_conv(gen, 5, in_ch, 32),
        "c2": init_conv(gen, 5, 32, 64),
        "f1": init_fc(gen, 64 * 7 * 7, n_classes),
    }


def cnn_femnist_apply(p: Pytree, x: torch.Tensor, train: bool = False,
                      rng=None) -> torch.Tensor:
    x = maxpool(F.relu(conv2d(p["c1"], x)))
    x = maxpool(F.relu(conv2d(p["c2"], x)))
    return fc(p["f1"], _flatten_nhwc(x))


# ---------------------------------------------------------------------------
# MLP — not a paper model; the matmul-only workload
# ---------------------------------------------------------------------------

def mlp_init(gen, n_classes: int = 10, in_ch: int = 1, d_hidden: int = 64,
             img: int = 28) -> Pytree:
    return {
        "f1": init_fc(gen, img * img * in_ch, d_hidden),
        "f2": init_fc(gen, d_hidden, n_classes),
    }


def mlp_apply(p: Pytree, x: torch.Tensor, train: bool = False,
              rng=None) -> torch.Tensor:
    return fc(p["f2"], F.relu(fc(p["f1"], _flatten_nhwc(x))))


# ---------------------------------------------------------------------------
# CNN-Fashion (Fashion-MNIST): 2 conv + dropout + 2 FC
# ---------------------------------------------------------------------------

def cnn_fashion_init(gen, n_classes: int = 10, in_ch: int = 1) -> Pytree:
    return {
        "c1": init_conv(gen, 5, in_ch, 16),
        "c2": init_conv(gen, 5, 16, 32),
        "f1": init_fc(gen, 32 * 7 * 7, 128),
        "f2": init_fc(gen, 128, n_classes),
    }


def _dropout_keep(rng, shape, keep_prob: float,
                 device: torch.device) -> torch.Tensor:
    """The keep-mask of one dropout: ``rng`` itself when it is a tensor
    (an injected mask), else ``uniform < keep_prob`` drawn from the
    generator ``rng`` on ``device`` (as ``jax.random.bernoulli`` draws)."""
    if isinstance(rng, torch.Tensor):
        if tuple(rng.shape) != tuple(shape):
            raise ValueError(f"keep-mask of shape {tuple(rng.shape)}, "
                             f"expected {tuple(shape)}")
        return rng
    return torch.rand(tuple(shape), generator=rng, device=device) < keep_prob


def cnn_fashion_apply(p: Pytree, x: torch.Tensor, train: bool = False,
                      rng=None, drop: float = 0.5) -> torch.Tensor:
    x = maxpool(F.relu(conv2d(p["c1"], x)))
    x = maxpool(F.relu(conv2d(p["c2"], x)))
    x = _flatten_nhwc(x)
    if train and rng is not None:
        keep = _dropout_keep(rng, x.shape, 1 - drop, x.device).to(x.dtype)
        x = x * keep / (1 - drop)
    x = F.relu(fc(p["f1"], x))
    return fc(p["f2"], x)


# ---------------------------------------------------------------------------
# CharLSTM-256 (Shakespeare): embed(8) + 2x LSTM(256) + FC
# ---------------------------------------------------------------------------

def _init_lstm_cell(gen, d_in: int, d_hidden: int) -> Pytree:
    scale = (d_in + d_hidden) ** -0.5
    return {
        "wx": normal_init(gen, (d_in, 4 * d_hidden), std=scale),
        "wh": normal_init(gen, (d_hidden, 4 * d_hidden), std=scale),
        "b": torch.zeros((4 * d_hidden,), device=gen.device),
    }


def charlstm_init(gen, vocab: int = 64, d_embed: int = 8,
                  d_hidden: int = 256) -> Pytree:
    return {
        "embed": normal_init(gen, (vocab, d_embed), std=0.1),
        "lstm1": _init_lstm_cell(gen, d_embed, d_hidden),
        "lstm2": _init_lstm_cell(gen, d_hidden, d_hidden),
        "head": init_fc(gen, d_hidden, vocab),
    }


def _lstm_layer(cell: Pytree, seq: torch.Tensor) -> torch.Tensor:
    """One LSTM layer over a time-major ``(S, B, d_in)`` sequence →
    ``(S, B, h)``.  The time-independent ``x @ wx + b`` is one matmul for
    the whole sequence; each step is one ``addmm`` of ``h @ wh`` onto it
    and the gate arithmetic (gates i, f, g, o; the forget gate biased
    by +1).  The steps read the product through one ``unbind``, whose
    backward is one stack (indexing it per step would build a
    full-size gradient per step and sum them)."""
    S, B, _ = seq.shape
    wh = cell["wh"]
    hidden = wh.shape[0]
    xw = torch.addmm(cell["b"], seq.reshape(S * B, -1),
                     cell["wx"]).reshape(S, B, 4 * hidden).unbind(0)
    h = seq.new_zeros((B, hidden))
    c = seq.new_zeros((B, hidden))
    hs = []
    for t in range(S):
        i, f, g, o = torch.addmm(xw[t], h, wh).chunk(4, dim=1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def charlstm_apply(p: Pytree, tokens: torch.Tensor, train: bool = False,
                   rng=None) -> torch.Tensor:
    """tokens: (B, S) int → logits (B, S, vocab) for next-char
    prediction.  Runs time-major inside; the tokens index ``embed`` as
    they are (int32 or int64)."""
    x = F.embedding(tokens.t(), p["embed"])                 # (S, B, e)
    h = _lstm_layer(p["lstm2"], _lstm_layer(p["lstm1"], x))
    return fc(p["head"], h).transpose(0, 1)


# ---------------------------------------------------------------------------
# registry: name -> (init_fn(gen, n_classes, in_ch), apply_fn, kind)
# ---------------------------------------------------------------------------

PAPER_MODELS.register("lenet5")((lenet5_init, lenet5_apply, "vision"))
PAPER_MODELS.register("resnet8")((resnet8_init, resnet8_apply, "vision"))
PAPER_MODELS.register("cnn_femnist")((cnn_femnist_init, cnn_femnist_apply,
                                      "vision"))
PAPER_MODELS.register("cnn_fashion")((cnn_fashion_init, cnn_fashion_apply,
                                      "vision"))
PAPER_MODELS.register("mlp")((mlp_init, mlp_apply, "vision"))
PAPER_MODELS.register("charlstm")((charlstm_init, charlstm_apply, "charlm"))
