"""The paper's evaluation models, in PyTorch.

The counterpart of ``repro/models/paper_models.py`` for LeNet-5,
CNN-FEMNIST and the two-layer MLP.  The parameter layout is the JAX
package's, so weights carry across by copy (``repro_torch.bridge``):
the same dict keys, HWIO conv weights, ``(d_in, d_out)`` fc weights and
NHWC activations at every public function.  Inside ``conv2d`` the
activations are permuted to NCHW and the weights to OIHW for
``F.conv2d``; a 5×5 "SAME" convolution at stride 1 pads by 2.  The
flatten before a classifier happens in NHWC order, as in the JAX
package — ``f1["w"]``'s rows are in (H, W, C) order.

ResNet-8 (BatchNorm/GroupNorm), CNN-Fashion (dropout) and CharLSTM are
not ported yet (ROADMAP.md items M2b, M2c and M2d).

Each model is an (init, apply) pair over dict params:
``init(gen, n_classes, in_ch) -> params`` on ``gen``'s device and
``apply(params, x, train=False, rng=None) -> logits``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import he_normal
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
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["b"].to(x.dtype),
                 stride=stride, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def maxpool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k×k max pool, stride k, "VALID" (NHWC)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


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
# registry: name -> (init_fn(gen, n_classes, in_ch), apply_fn, kind)
# ---------------------------------------------------------------------------

PAPER_MODELS.register("lenet5")((lenet5_init, lenet5_apply, "vision"))
PAPER_MODELS.register("cnn_femnist")((cnn_femnist_init, cnn_femnist_apply,
                                      "vision"))
PAPER_MODELS.register("mlp")((mlp_init, mlp_apply, "vision"))
