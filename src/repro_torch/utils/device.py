"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA request without a CUDA device
    raises — the port never quietly runs on the CPU; callers that want
    the CPU (the tests) ask for it with ``device="cpu"``.

    Also switches TF32 off for convolutions and matmuls: the paper
    models are f32 and the port is held against an f32 reference."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless device='cpu' is passed, "
            "and no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def seeded_generator(seed: int, device: Device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer over one 64-bit word."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, *data: int) -> int:
    """A 63-bit generator seed from ``key`` with each integer of
    ``data`` folded in, in order — the port's counterpart of
    ``jax.random.fold_in`` for seeding ``torch.Generator``s.  Stable
    across processes and machines (plain integer arithmetic)."""
    x = int(key) & _MASK64
    for v in data:
        x = _mix64(x ^ _mix64(int(v) & _MASK64))
    return x >> 1
