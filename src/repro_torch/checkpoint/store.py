"""Flat-npz pytree checkpointing with a structure manifest (the
counterpart of ``repro/checkpoint/store.py``, in its file format).

One ``.npz`` holds every leaf under ``leaf/<path>`` (the "/"-joined dict
keys and sequence indices, in ``tree_leaves`` order) and a
``__manifest__`` uint8 JSON with the tree's ``structure``, the leaf
``keys`` and the caller's ``metadata``; it is written to a temporary file
beside the target and moved into place.  A file written here reads in
the JAX package and the other way round.

Dtypes: numpy has no bfloat16, so a bf16 leaf is written as its raw two
bytes (numpy dtype ``|V2``), as the JAX package writes one, and a ``V2``
leaf is read back as ``torch.bfloat16`` (the JAX package reads it back
as ``V2`` bytes).  Every other dtype round-trips as its numpy dtype.  A
CUDA tensor is copied to the host once per leaf; a load returns CPU
tensors, or tensors on ``device``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import Device

Pytree = Any
_SEP = "/"
_BF16_BYTES = np.dtype("V2")

__all__ = ["save_pytree", "load_pytree", "load_metadata",
           "CheckpointManager"]


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BYTES)
    return t.numpy()


def _to_tensor(a: np.ndarray, device: Device) -> torch.Tensor:
    if a.dtype == _BF16_BYTES:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def save_pytree(path: str, tree: Pytree,
                metadata: Optional[Dict] = None) -> None:
    keys = tm.tree_paths(tree)
    arrays = {f"leaf{_SEP}{k}": _to_numpy(v)
              for k, v in zip(keys, tm.tree_leaves(tree))}
    manifest = {
        "structure": _encode_structure(tree),
        "keys": keys,
        "metadata": metadata or {},
    }
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        np.savez(tmp, __manifest__=np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8), **arrays)
        shutil.move(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                    path)
    finally:
        for cand in (tmp, tmp + ".npz"):
            if os.path.exists(cand):
                os.remove(cand)


def _encode_structure(tree: Pytree):
    """The JAX package's encoding: dicts in sorted key order (as its
    ``tree_map`` rebuilds them), lists and tuples, and leaves."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _encode_structure(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"__kind__": kind,
                "items": [_encode_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def _decode_structure(enc, leaves_iter):
    kind = enc["__kind__"]
    if kind == "dict":
        return {k: _decode_structure(v, leaves_iter)
                for k, v in enc["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_decode_structure(v, leaves_iter) for v in enc["items"]]
        return seq if kind == "list" else tuple(seq)
    return next(leaves_iter)


def load_pytree(path: str, device: Device = None) -> Pytree:
    """The tree saved at ``path``: CPU tensors, or on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        leaves = [_to_tensor(z[f"leaf{_SEP}{k}"], device)
                  for k in manifest["keys"]]
    return _decode_structure(manifest["structure"], iter(leaves))


def load_metadata(path: str) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(bytes(z["__manifest__"]).decode())["metadata"]


class CheckpointManager:
    """Rolling round-numbered checkpoints: ``<dir>/ckpt_<round>.npz``,
    the newest ``keep`` kept.

    Under a ``torch.distributed`` process group of more than one rank
    every rank calls :meth:`save` with the same whole tree (the pod hands
    out gathered leaves whatever its layout, so a sharded run writes the
    files of a replicated one): rank 0 writes, and every rank waits at a
    barrier until the file is in place, so a :meth:`restore` that follows
    reads it on every rank."""

    PATTERN = re.compile(r"ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, round_: int, tree: Pytree,
             metadata: Optional[Dict] = None) -> str:
        path = os.path.join(self.directory, f"ckpt_{round_}.npz")
        meta = dict(metadata or {})
        meta["round"] = round_
        many = dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1
        if not many or dist.get_rank() == 0:
            save_pytree(path, tree, meta)
            self._gc()
        if many:
            dist.barrier()
        return path

    def latest(self) -> Optional[str]:
        rounds = self._rounds()
        if not rounds:
            return None
        return os.path.join(self.directory, f"ckpt_{rounds[-1]}.npz")

    def restore(self, device: Device = None) -> Optional[Pytree]:
        path = self.latest()
        return None if path is None else load_pytree(path, device)

    def _rounds(self) -> List[int]:
        out = []
        for f in os.listdir(self.directory):
            m = self.PATTERN.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _gc(self) -> None:
        rounds = self._rounds()
        for r in rounds[:-self.keep]:
            os.remove(os.path.join(self.directory, f"ckpt_{r}.npz"))
