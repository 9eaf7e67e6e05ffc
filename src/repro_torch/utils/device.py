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
