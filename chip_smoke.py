#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the fused-update kernels from ``src/repro_torch/kernels/csrc``
into ``build/`` (nvcc, sm_90a), then prints one JSON line per phase:

  1. env       — the card (nvidia-smi name, power limit), torch/CUDA
                 versions, the kernel build time;
  2. kernel    — each CUDA kernel against its plain PyTorch version on
                 the card, over its variants at N = 137,216 (LeNet-5,
                 padded) and N = 16,777,216: max abs error, kernel and
                 plain ms (median of CUDA-event timings), one PyTorch
                 library call's ms where one computes the same function,
                 and the bound (bytes ÷ the card's data-sheet bandwidth);
  3. main_path — the paper pipeline at full width: LeNet-5 on
                 cifar10-like (100 clients, β = 0.5, 20,000 samples), P1
                 cyclic relay (4 rounds) → P2 FedAvgM (4 rounds) through
                 ``run_cyclic_then_federated``, launch counts asserted;
  4. e2e       — 1 P1 + 1 P2 round with update_impl "fused" and
                 "fused_interpret" from the same init and index stream,
                 final params compared;
then the ``kernels`` summary, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
the last line; without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_SMALL = 137_216          # LeNet-5's 136,886 params padded to 1024
N_LARGE = 16_777_216
KERNEL_TOL = 0.0    # bitwise: kernels round where the plain versions do
SEED = 0

# data-sheet peaks (NVIDIA H100 SXM data sheet): bytes/s, f32 FLOP/s.
# Other cards raise in card_peaks until a run on one adds its row.
_PEAKS = (("H100 HBM3", 3.35e12, 67e12),)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    up = name.upper()
    for key, bw, flops in _PEAKS:
        if all(part in up for part in key.split()):
            return bw, flops
    raise SystemExit(f"chip_smoke: no data-sheet peaks for {name!r}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, trials: int = 5, reps: int = 20) -> float:
    """Median over ``trials`` of the mean device time per call of
    ``reps`` back-to-back calls.  A sleep kernel queued first keeps the
    device busy while the host enqueues the calls, so the events time
    the device work, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


class KernelBench:
    """Kernel-vs-plain checks on the card (phase 2)."""

    def __init__(self, torch, fu, peaks):
        self.torch, self.fu = torch, fu
        self.bw, self.flops = peaks
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(SEED)

    def rand(self, *shape, dtype=None):
        t = self.torch.randn(*shape, generator=self.gen, device="cuda")
        return t.to(dtype or self.torch.float32)

    def bound_ms(self, n_bytes: float, n_ops: float):
        t_bytes, t_ops = n_bytes / self.bw, n_ops / self.flops
        return max(t_bytes, t_ops) * 1e3, \
            "bytes" if t_bytes >= t_ops else "operations"

    @staticmethod
    def max_err(pairs) -> float:
        return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)

    def local_step(self, n, dtype, has_m, has_c, wd=1e-3, clip=0.7):
        torch, fu = self.torch, self.fu
        p, g = self.rand(n, dtype=dtype), self.rand(n, dtype=dtype)
        m = self.rand(n, dtype=dtype) if has_m else None
        c = self.rand(n, dtype=dtype) if has_c else None
        sc = torch.tensor([clip, 0.05], dtype=torch.float32, device="cuda")
        beta = 0.9 if has_m else 0.0
        kw = dict(weight_decay=wd, momentum=beta)

        def clones():
            return p.clone(), (m.clone() if has_m else None)
        pk, mk = clones()
        fu.local_step(pk, g, mk, c, sc, **kw)
        pp, mp = clones()
        fu.local_step_plain(pp, g, mp, c, sc, **kw)
        err = self.max_err([(pk, pp)] + ([(mk, mp)] if has_m else []))
        pk, mk = clones()
        ms = time_ms(torch, lambda: fu.local_step(pk, g, mk, c, sc, **kw))
        pp, mp = clones()
        plain = time_ms(torch, lambda: fu.local_step_plain(pp, g, mp, c, sc,
                                                           **kw))
        e = p.element_size()
        n_bytes = n * e * (3 + 2 * has_m + has_c) + 8
        n_ops = n * (1 + has_c + 2 * bool(wd) + 2 * has_m + 2)
        library, why = None, "no single PyTorch call applies clip scale, " \
            "weight decay and momentum in this order"
        if not has_m and not has_c and not wd and clip == 1.0:
            pl = p.clone()
            library = time_ms(torch, lambda: pl.add_(g, alpha=-0.05))
            why = "Tensor.add_(g, alpha=-step): the same function at " \
                "clip 1, no decay, no momentum"
        bound, by = self.bound_ms(n_bytes, n_ops)
        return dict(kernel="local_step", n=n, dtype=str(dtype)[6:],
                    momentum=has_m, c=has_c, weight_decay=wd,
                    clip_scale=clip, max_abs_err=err, ms=ms, plain_ms=plain,
                    library_ms=library, library_note=why, bound_ms=bound,
                    bound_by=by)

    def weighted_delta(self, n, K, has_extra, deltas, dtype=None):
        torch, fu = self.torch, self.fu
        dtype = dtype or torch.float32
        stacked, p = self.rand(K, n, dtype=dtype), self.rand(n, dtype=dtype)
        w = torch.rand(K, generator=self.gen, device="cuda")
        w = (w / w.sum()).float()
        extra = self.rand(n) if has_extra else None
        kw = dict(extra=extra, deltas=deltas)
        out = fu.weighted_delta(stacked, p, w, **kw)
        ref = fu.weighted_delta_plain(stacked, p, w, **kw)
        err = self.max_err([(out, ref)])
        ms = time_ms(torch, lambda: fu.weighted_delta(stacked, p, w, **kw))
        plain = time_ms(torch, lambda: fu.weighted_delta_plain(stacked, p, w,
                                                               **kw))
        e = p.element_size()
        n_bytes = n * e * (K + 2) + n * 4 * has_extra + 4 * K
        n_ops = n * ((2 if deltas else 3) * K + 1 + has_extra)
        library, why = None, "no single PyTorch call adds the extra term"
        if dtype != torch.float32:
            why = "torch.addmv takes one dtype; the stack is bf16, the " \
                "weights f32"
        elif not has_extra:
            st = stacked.t()
            if deltas:
                library = time_ms(torch, lambda: torch.addmv(p, st, w))
                why = "torch.addmv(p, stacked.T, w)"
            else:
                beta = 1.0 - float(w.sum())
                library = time_ms(torch, lambda: torch.addmv(p, st, w,
                                                             beta=beta))
                why = "torch.addmv(p, stacked.T, w, beta=1-sum(w)): the " \
                    "same function in exact arithmetic"
        bound, by = self.bound_ms(n_bytes, n_ops)
        return dict(kernel="weighted_delta", n=n, dtype=str(dtype)[6:], K=K,
                    extra=has_extra, deltas=deltas, max_abs_err=err, ms=ms,
                    plain_ms=plain, library_ms=library, library_note=why,
                    bound_ms=bound, bound_by=by)

    def server_update(self, n, opt, dtype=None):
        torch, fu = self.torch, self.fu
        dtype = dtype or torch.float32
        p, d = self.rand(n, dtype=dtype), self.rand(n) * 1e-2
        n_m = {"none": 0, "momentum": 1, "adam": 2}[opt]
        moments = [self.rand(n, dtype=dtype).abs() for _ in range(n_m)]
        sc = torch.tensor([0.5, 0.19, 0.0199][:3 if opt == "adam" else 1],
                          dtype=torch.float32, device="cuda")
        kw = dict(opt=opt, beta=0.9, b1=0.9, b2=0.99)

        def clones():
            return p.clone(), tuple(m.clone() for m in moments)
        pk, mk = clones()
        fu.server_update(pk, d, mk, sc, **kw)
        pp, mp = clones()
        fu.server_update_plain(pp, d, mp, sc, **kw)
        err = self.max_err([(pk, pp)] + list(zip(mk, mp)))
        pk, mk = clones()
        ms = time_ms(torch, lambda: fu.server_update(pk, d, mk, sc, **kw))
        pp, mp = clones()
        plain = time_ms(torch, lambda: fu.server_update_plain(pp, d, mp, sc,
                                                              **kw))
        e = p.element_size()
        n_bytes = n * (2 * e + 4 + 2 * e * n_m) + 4 * sc.numel()
        n_ops = n * {"none": 1, "momentum": 4, "adam": 13}[opt]
        pl, ml = clones()
        neg_d = (-d).to(dtype)
        if opt == "none":
            library = time_ms(torch, lambda: pl.add_(d))
            why = "Tensor.add_(d)"
        elif opt == "momentum":
            lib = torch._fused_sgd_
            library = time_ms(torch, lambda: lib(
                [pl], [neg_d], [ml[0]], weight_decay=0.0, momentum=0.9,
                lr=0.5, dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False))
            why = "torch._fused_sgd_ on the pseudo-gradient -d"
        else:
            lib = torch._fused_adam_
            steps = [torch.ones((), device="cuda")]
            library = time_ms(torch, lambda: lib(
                [pl], [neg_d], [ml[0]], [ml[1]], [], steps, lr=0.5,
                beta1=0.9, beta2=0.99, weight_decay=0.0, eps=1e-8,
                amsgrad=False, maximize=False))
            why = "torch._fused_adam_ on the pseudo-gradient -d"
        bound, by = self.bound_ms(n_bytes, n_ops)
        return dict(kernel="server_update", n=n, dtype=str(dtype)[6:],
                    opt=opt, max_abs_err=err, ms=ms, plain_ms=plain,
                    library_ms=library, library_note=why, bound_ms=bound,
                    bound_by=by)


def check_kernels(torch, fu, bench) -> dict:
    """Phase 2: every variant, then the main path's shapes (returned)."""
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for n in (N_SMALL, N_LARGE):
        for dtype in (f32, bf16):
            for has_m in (False, True):
                for has_c in (False, True):
                    rows.append(bench.local_step(n, dtype, has_m, has_c))
        for K in (1, 10, 25):
            for has_extra in (False, True):
                for deltas in (False, True):
                    rows.append(bench.weighted_delta(n, K, has_extra, deltas))
        rows.append(bench.weighted_delta(n, 10, False, False, dtype=bf16))
        for opt in ("none", "momentum", "adam"):
            rows.append(bench.server_update(n, opt))
    for r in rows:
        emit(dict(phase="kernel", **r))
    bad = [r for r in rows if not r["max_abs_err"] <= KERNEL_TOL]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} kernel variants disagree "
                         f"with their plain versions")
    # the shapes and settings the main path gives each kernel
    return {
        "local_step": bench.local_step(N_SMALL, f32, False, False, wd=0.0,
                                       clip=1.0),
        "weighted_delta": bench.weighted_delta(N_SMALL, 10, False, False),
        "server_update": bench.server_update(N_SMALL, "momentum"),
    }


def main_path(torch, fu):
    """Phase 3: the paper pipeline at full width through the user entry
    point, launch counts asserted."""
    from repro_torch.core import comm_accounting
    from repro_torch.core.cyclic import CyclicConfig, cyclic_pretrain
    from repro_torch.core.pipeline import run_cyclic_then_federated
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.fl.task import vision_task
    from repro_torch.utils.tree_math import size_bytes

    t0 = time.perf_counter()
    data = DATASETS.get("cifar10-like")(n_clients=100, beta=0.5, seed=SEED,
                                        n_train=20000)
    data_s = time.perf_counter() - t0
    task = vision_task("lenet5", n_classes=10, in_ch=3)
    cyc = CyclicConfig(rounds=4, participation=0.25, local_steps=20,
                       batch_size=32, update_impl="fused", sampling="host")
    fed = FLConfig(algorithm="fedavg", rounds=4, participation=0.1,
                   local_steps=25, server_opt="momentum", update_impl="fused",
                   sampling="host")

    fu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_cyclic_then_federated(task, data, cyc, fed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fu.KERNELS}

    k1, k2 = cyc.n_selected(100), fed.n_selected(100)
    want = {"local_step": cyc.rounds * k1 * cyc.local_steps +
            fed.rounds * k2 * fed.local_steps,
            "weighted_delta": fed.rounds, "server_update": fed.rounds}
    hist = res.history
    x_bytes = size_bytes(res.federated.params)
    closed = comm_accounting.overhead_with_cyclic(
        "fedavg", k1, cyc.rounds, k2, fed.rounds, x_bytes)
    final_acc = hist[-1]["acc"]

    # a second, warm run of each phase alone for per-phase wall times
    phase_s = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1 = cyclic_pretrain(task, data, cyc)
    torch.cuda.synchronize()
    phase_s["P1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_federated(task, data, fed, init_params=p1.params)
    torch.cuda.synchronize()
    phase_s["P2"] = time.perf_counter() - t0

    emit(dict(phase="main_path", model="lenet5", dataset="cifar10-like",
              n_clients=100, beta=0.5, n_train=20000, data_gen_s=data_s,
              history=hist, wall_s=wall,
              rounds_per_s=len(hist) / wall,
              warm_phase_wall_s=phase_s,
              warm_rounds_per_s={"P1": cyc.rounds / phase_s["P1"],
                                 "P2": fed.rounds / phase_s["P2"]},
              ledger=res.ledger.summary(), ledger_closed_form=closed,
              launches=launches, expected_launches=want,
              final_acc=final_acc))
    if launches != want:
        raise SystemExit(f"chip_smoke: launch counts {launches} != {want}")
    if not all(math.isfinite(h["local_loss"]) for h in hist):
        raise SystemExit("chip_smoke: non-finite loss on the main path")
    if not final_acc > 0.1:
        raise SystemExit(f"chip_smoke: final accuracy {final_acc} is not "
                         "above chance")
    if res.ledger.total_bytes != closed:
        raise SystemExit("chip_smoke: ledger bytes differ from the closed "
                         "form")
    profile_rounds(torch, task, data, cyc, fed, p1.params)
    return launches


def profile_rounds(torch, task, data, cyc, fed, init) -> None:
    """Where the time goes: one warm P1 round and one warm P2 round
    under torch.profiler, CUDA activity only (no host-op tracing, so the
    host pays little for it).  Reports the device's busy share of the
    round's wall time and the kernels by device time."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.cyclic import cyclic_pretrain
    from repro_torch.fl.simulation import run_federated

    runs = {"P1": (cyclic_pretrain, dataclasses.replace(cyc, rounds=1),
                   cyc.n_selected(100) * cyc.local_steps),
            "P2": (run_federated, dataclasses.replace(fed, rounds=1),
                   fed.n_selected(100) * fed.local_steps)}
    for name, (run, cfg, steps) in runs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(task, data, cfg, init_params=init)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.end - e.time_range.start,
                               cnt + 1)
        busy, end = 0.0, -math.inf
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        emit(dict(phase="profile", round=name, sgd_steps=steps,
                  wall_ms=wall_us / 1e3, ms_per_step=wall_us / 1e3 / steps,
                  device_busy_ms=busy / 1e3,
                  device_busy_share=busy / wall_us if spans else None,
                  device_ops=len(spans),
                  device_ops_per_step=len(spans) / steps,
                  top_device_ops=[dict(name=k[:90], total_ms=v[0] / 1e3,
                                       count=v[1]) for k, v in top]))


def fused_vs_plain(torch):
    """Phase 4: the kernels against the plain path, end to end."""
    from repro_torch.core.cyclic import cyclic_pretrain, CyclicConfig
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.fl.task import vision_task
    from repro_torch.utils.tree_math import tree_leaves

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    data = DATASETS.get("cifar10-like")(n_clients=100, beta=0.5, seed=SEED,
                                        n_train=20000)
    task = vision_task("lenet5", n_classes=10, in_ch=3)
    init = task.init(torch.Generator().manual_seed(SEED))

    def indices(rnd, slot, step):
        g = torch.Generator().manual_seed(1_000_003 * rnd + 1009 * slot + step)
        return torch.randint(0, data.n_per_client, (32,), generator=g)

    finals = {}
    for impl in ("fused", "fused_interpret"):
        cyc = CyclicConfig(rounds=1, participation=0.25, local_steps=20,
                           batch_size=32, update_impl=impl, sampling="host",
                           batch_indices=indices)
        fed = FLConfig(rounds=1, participation=0.1, local_steps=25,
                       server_opt="momentum", update_impl=impl,
                       sampling="host", batch_indices=indices)
        p1 = cyclic_pretrain(task, data, cyc, init_params=init)
        p2 = run_federated(task, data, fed, init_params=p1.params)
        finals[impl] = [t.detach().clone() for t in tree_leaves(p2.params)]
    diffs = [float((a - b).abs().max())
             for a, b in zip(finals["fused"], finals["fused_interpret"])]
    close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                for a, b in zip(finals["fused"], finals["fused_interpret"]))
    emit(dict(phase="e2e", rounds={"P1": 1, "P2": 1}, rtol=1e-5, atol=1e-6,
              max_abs_diff=max(diffs), allclose=close))
    if not close:
        raise SystemExit("chip_smoke: fused and plain paths disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused_update as fu

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    _, build_s = fu.build_library()
    emit(dict(phase="env", nvidia_smi=smi, device=name,
              torch=torch.__version__, cuda=torch.version.cuda,
              kernel_build_s=build_s))
    bench = KernelBench(torch, fu, card_peaks(name))
    main_shapes = check_kernels(torch, fu, bench)
    launches = main_path(torch, fu)
    fused_vs_plain(torch)

    source = "src/repro_torch/kernels/csrc/fused_update.cu"
    replaces = {"local_step": "src/repro/kernels/fused_update.py:131",
                "weighted_delta": "src/repro/kernels/fused_update.py:199",
                "server_update": "src/repro/kernels/fused_update.py:475"}
    kernels = []
    for kname, r in main_shapes.items():
        if r["max_abs_err"] > KERNEL_TOL:
            raise SystemExit(f"chip_smoke: {kname} disagrees: {r}")
        kernels.append(dict(name=kname, route="cuda", source=source,
                            replaces=replaces[kname],
                            launches=launches[kname],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
