"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for sm_90a into ONE
shared library under ``build/repro_torch/`` at the repository root, at
first use, and loaded with ctypes; nothing is compiled at import.  The
library's name carries a hash over all sources and the flags, so an
edit to any kernel rebuilds it and a stale library is never loaded.

Each source exports plain C launchers that enqueue on the stream they
are given and return ``cudaGetLastError()``; ``check_launch`` turns a
non-zero code into an exception.  Pointers and the stream cross as
``c_void_p``, never as 32-bit ints.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_FLAGS = ARCH_FLAGS + ("-shared", "-Xcompiler", "-fPIC")

P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (every launcher returns an int error
# code; RESTYPES names the entry points that return something else)
SIGNATURES = {
    "fu_local_step": [P, P, P, P, P, L, I, I, I, F, F, P],
    "fu_weighted_delta": [P, P, P, P, P, L, I, I, I, I, P],
    # p, d or avg, m1, m2, scalars, n, dtype, opt, from_avg, beta, b1, b2,
    # 1 - b1, 1 - b2, eps, stream
    "fu_server_update": [P, P, P, P, P, L, I, I, I, F, F, F, F, F, F, P],
    # d, w, p, coeff, n, dtype, stream
    "fu_delta_accum": [P, P, P, P, L, I, P],
    # out, q, k, v, B, S, T, H, KH, hd, q_offset, window, kv_len, dtype,
    # workspace, tickets, stream
    "fa_forward": [P, P, P, P, I, I, I, I, I, I, I, I, I, I, P, P, P],
    # B, S, T, H, KH, hd -> bytes of the decode's partials
    "fa_workspace_bytes": [I, I, I, I, I, I],
    # y, final, x, dt, A, Bm, Cm, b, s, h, p, g, n, chunk, dtype,
    # workspace, stream
    "ssd_forward": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P, P],
    # b, s, h, p, g, n, chunk -> bytes of the call's workspace
    "ssd_workspace_bytes": [I, I, I, I, I, I, I],
    # d, tau, c, r, n, bits, topk, stream
    "up_compress_delta": [P, P, P, P, L, I, I, P],
    # d, n, k, tau, workspace, stream
    "up_topk_threshold": [P, L, L, P, P, P],
    "up_topk_workspace_words": [],
    # d, n, k, tau, stream
    "up_topk_cluster": [P, L, L, P, P],
    # d, n, k, bits, tau, c, r, stream
    "up_topk_compress": [P, L, L, I, P, P, P, P],
    # n -> dynamic shared memory per CTA of up_topk_cluster /
    # up_topk_compress, in bytes; clusters of one up_topk_compress launch
    "up_topk_cluster_smem_bytes": [L],
    "up_topk_compress_smem_bytes": [L],
    "up_topk_compress_clusters": [L],
    # out, d, z, scalars, n, stream
    "up_dp_clip_noise": [P, P, P, P, L, P],
    # out, w, p, z, clip_scales, noise_scale, n, K, dtype, stream
    "up_dp_clip_noise_rows": [P, P, P, P, P, P, L, I, I, P],
}
RESTYPES = {"ssd_workspace_bytes": L}


def sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC.glob("*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use on the card")
    return path


def build_library() -> Tuple[Path, float]:
    """Compile every ``csrc/*.cu`` into one library in ``BUILD_DIR``
    (skipped when a library built from the same sources and flags
    exists).  Each source is compiled to an object by its own ``nvcc``,
    all at once, then linked.  Returns the library path and the seconds
    spent compiling and linking (0.0 when reused)."""
    srcs = sources()
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]

        def compile_one(pair):
            src, obj = pair
            return subprocess.run(
                [nvcc, *ARCH_FLAGS, "-Xcompiler", "-fPIC", "-c", "-o",
                 str(obj), str(src)], capture_output=True, text=True)

        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            procs = list(pool.map(compile_one, zip(srcs, objs)))
        for src, proc in zip(srcs, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{proc.stderr}")
        out = Path(tmp) / "lib.so"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(out),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(out, lib)
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    cdll = ctypes.CDLL(str(build_library()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return cdll


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# (device, stream, owner, name) -> a zero-filled buffer a kernel keeps
# between its calls on that stream
_WORKSPACES: dict = {}


def workspace(owner: str, device: torch.device, stream_key: int,
              **need: Tuple[int, torch.dtype]) -> Tuple[torch.Tensor, ...]:
    """Buffers that ``owner``'s kernel keeps from one call to the next,
    one set per (device, stream): ``need`` maps a buffer's name to (at
    least this many elements, dtype), and the buffers come back in that
    order.  Each is zero-filled when it is made and grows by being made
    anew (zero-filled, larger), never in place, so a kernel that leaves
    its buffer as it found it (K7's tickets) needs no memset.  Two calls
    in flight on two streams get different buffers; calls on one stream
    run in order, so they may share.  ``stream_key`` is the stream's
    handle (``stream(t)``); any int names a stream on the CPU.  A buffer
    is made on the current stream, which is the keyed one when the
    kernel's wrapper calls this."""
    out = []
    for name, (numel, dtype) in need.items():
        key = (torch.device(device), stream_key, owner, name)
        buf = _WORKSPACES.get(key)
        if buf is None or buf.numel() < numel:
            buf = torch.zeros(numel, dtype=dtype, device=device)
            _WORKSPACES[key] = buf
        out.append(buf)
    return tuple(out)


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
