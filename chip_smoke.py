#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` into
``build/`` (one nvcc per source, all at once; sm_90a), then prints one
JSON line per phase:

  1. env           — the card (nvidia-smi name, power limit), torch/CUDA
                     versions, the kernel build time; env_sass: whether
                     K7's kernels in the built library issue HGMMA (wgmma),
                     UTMALDG (TMA) and LDGSTS (cp.async), K8's bf16
                     kernels HMMA (mma.sync), every instance of the
                     cluster kernel (the threshold alone and the fused
                     top-k compressed upload) a cluster barrier and
                     st.async stores into distributed shared memory on
                     mbarriers, and every instance of K1, K3, K4, K5 (per
                     client and rows form) and K6 griddepcontrol.wait
                     (ACQBULK), from cuobjdump;
  2. kernel        — each CUDA kernel against its plain PyTorch version
                     on the card, over its variants: max abs error under
                     the stated tolerance, kernel and plain ms (median of
                     CUDA-event timings), one PyTorch library call's ms
                     where one computes the same function, and the bound
                     (the larger of bytes ÷ bandwidth and unmasked
                     operations ÷ the data-sheet peak for their type).
                     K1–K3 and K6 (delta_accum, with p and accum-only,
                     f32 and bf16) at N = 137,216 (LeNet-5, padded) and
                     16,777,216, bitwise, K3 also in its aggregate form
                     (avg − p formed in the kernel; against its plain
                     version and the subtraction + delta form, timed in
                     turns); the upload kernels K4
                     (compress_delta, launched with programmatic
                     dependent launch; bits 8/16/32 × top-k × residual),
                     the top-k threshold (a radix select: one launch on a
                     thread-block cluster up to its cut, four above it;
                     also at the cut and one past it) and K5 (dp_clip_noise,
                     PDL) at the same N, bitwise, and K5's rows form (the
                     K uploads of a round in one launch) at K 1/10/25,
                     bitwise against its plain version and the per-client
                     chain, timed in turns; the fused top-k compressed upload
                     (topk_compress: one launch of as many threshold
                     clusters as the card runs at once, K4 as their
                     epilogue) at bits 8/16/32 × residual at N 137,216,
                     at the cut and at 1,000, bitwise against its plain
                     version and the two-launch chain (timed in turns
                     with it), and one past the cut (4 + 1 launches); K7
                     (flash_attention) and K8 (ssd_scan) at hymba-1.5b's
                     shapes and beside them; K1 (launched with
                     programmatic dependent launch) and Tensor.add_ timed
                     in turns, five times each (local_step_vs_add_);
                     K1–K3, the threshold (its four radix launches) and
                     K4 with top-k and the residual at CharLSTM-256's
                     bucket, N 814,080, bitwise (path "charlm"), each
                     timed from a cold L2; the bf16 instances of K1, K2,
                     K3 (aggregate form and "none") and K6 at llm_lora's
                     adapter bucket (N 6,307,840), and K1 over its whole
                     model (N 1,106,356,224), bitwise (path "llm_lora");
                     K1 at pod_sharded's per-shard rows (N
                     274,989,056 in P1, 1,576,960 in P2), K6 and K3's
                     apply at 1,576,960, bitwise (path "pod_sharded");
                     K1, K6 and K3's apply at each trainable row of
                     pod_sharded_moe's cut in P2 under fsdp_tp (f32
                     routers 262,144, bf16 adapters 60,160 and 95,744)
                     and K1 at its P1 row (417,464,320), bitwise (path
                     "pod_sharded_moe");
                     K1, K6 and K3 at moe_train's two buckets, K2 and
                     K3's aggregate form at its cut's, K1 over the cut's
                     whole bf16 model (path "moe_train"); K7 at
                     qwen2-1.5b's shapes (hd 128, G 6);
                     the variant sweeps timed with one trial each (the
                     mean of 20 calls), the paths' shapes with five;
  3. main_path     — the paper pipeline at full width: LeNet-5 on
                     cifar10-like (100 clients, β = 0.5, 20,000 samples),
                     P1 cyclic relay (4 rounds) → P2 FedAvgM (4 rounds)
                     through ``run_cyclic_then_federated``, launch counts
                     asserted, then one profiled round of each phase
                     (P1's cut to 5 clients);
     p2_algorithms — the paper's Table I baselines from the main path's
                     P1 params: P2 2 rounds × 10 clients × 10 steps of
                     fedavg, fedprox, scaffold and moon (mu 0.01,
                     temperature 0.5, no server optimizer); K1 200
                     launches each, K1 with SCAFFOLD's correction c
                     200 under scaffold and 0 otherwise, K2 2, K3 0,
                     accuracy above chance, ledger == closed form;
                     rounds/s, ms per SGD step and a profiled round's
                     device ops per step; scaffold's first round bitwise
                     equal to fedavg's;
  4. e2e           — 1 P1 + 1 P2 round with update_impl "fused" and
                     "fused_interpret" from the same init and index
                     stream, final params compared; and 1 P2 round of
                     scaffold (params and control variates) and of moon
                     the same way;
     p2_compressed — the main path (P1 cut to 1 round, P2 to 2 rounds in
                     the three upload phases) with int8 + top-k 25% + error
                     feedback uploads in P2: 20 launches of the fused
                     topk_compress and none of the standalone K4 or
                     threshold asserted, ledger
                     == closed form (173,250 upload bytes per client),
                     accuracy above chance, a profiled P2 round, then
                     "fused" against "fused_interpret" (params and EF
                     residual rows);
     p2_private    — the same with DP-FedAvg (C = 1, σ = 0.1) and secure
                     aggregation: K2 carries the clip and the noise/mask
                     total, mask bytes == 2 × secure_agg_mask_bytes(10);
     p2_int8       — the same with int8 dense uploads (quantized, not
                     sparsified): 20 standalone K4 launches;
     dp_upload     — the 10 client uploads of one private engine round
                     (seen through RoundSchedule.on_aggregate), built by
                     one rows-form K5 launch from the round's draws and
                     summed by K2, against the engine's folded aggregate
                     (one K5 launch per bucket asserted) and bitwise
                     against the per-client form it replaced;
     p2_rounds     — warm P2 rounds/s of the uncompressed, compressed and
                     private configurations (and private under device
                     sampling), in turns from the same P1 params, 1
                     round a turn;
     charlm_path   — the paper's CharLSTM-256 (813,632 params, one bucket
                     of 814,080, above the threshold's cluster cut) on
                     shakespeare-like (66 clients) through
                     run_cyclic_then_federated: P1 1 × 7 × 10, P2
                     FedAvgM 1 × 7 × 5, lr 0.8; K1 70, K2 1, K3 1,
                     ledger == closed form, held-out loss below the
                     init's, accuracy above 1/64, fused == plain
                     bitwise (1 + 1 rounds of 2 clients); ms per step
                     and a profiled step's device ops and busy share;
     charlm_compressed — its P2 from its P1 params with int8 + top-k 25%
                     + EF uploads: the threshold's radix route 28 (4 ×
                     7 uploads), K4 alone 7, topk_compress 0, ledger
                     == closed form, fused == plain bitwise (params and
                     EF rows);
     fashion_path  — CNN-Fashion (dropout 0.5) on fashion-like: P1 2 × 25
                     × 10, P2 2 × 10 × 10; K1 700, K2 2, K3 0, every
                     step's keep-mask from a generator on the card,
                     accuracy above chance, fused == plain bitwise under
                     deterministic cuDNN; ms and device ops per step;
     pod_path      — the main path on the pod backend (fl/pod.py) over a
                     one-rank NCCL mesh (make_host_mesh): P1 and P2
                     through run_phase_schedule with PodCyclicConfig /
                     PodFLConfig, 2 rounds a phase; launches K1 1500,
                     K6 20 (with p, one per
                     client; K6 is launched with programmatic dependent
                     launch), K2 0, K3 4 (apply + FedAvgM per round), one
                     gradient all-reduce per SGD step, ledger == closed
                     form, accuracy above chance;
     pod_hierarchical — one pod P2 round with aggregation="hierarchical",
                     n_pods=2 against the sequential one (rtol 1e-5), 10
                     K6 launches;
     pod_compressed — the pod P2 with int8 + top-k 25% + EF uploads:
                     accum-only K6 40, topk_compress 40 (K4 and the
                     threshold 0), ledger == closed form;
     pod_vs_host   — 1 P1 + 1 P2 round on the pod and the host engine at
                     the JAX package's tolerances, and the pod's kernels
                     against its plain path, bitwise; one CharLSTM-256
                     P2 FedAvgM round (charlm_path's shapes, 2 clients)
                     on the pod against the host engine;
     pod_algorithms — SCAFFOLD on the pod through run_phase_schedule, the
                     p2_algorithms P2 shape: K1 1,000 (all with c), K6 40,
                     K2 0, ledger == closed form, accuracy above chance,
                     params and control variates against the host's
                     SCAFFOLD (atol = rtol = 1e-4);
     pod_rounds    — warm P2 rounds/s of the pod and the host, in turns, 2
                     rounds a turn;
     client_store  — the sparse client store and the overlapped pipeline
                     (M10): from the main path's P1 params, P2 6 × 10 ×
                     1 (× 2 before pod_sharded_zoo joined the script),
                     chunk 2, of SCAFFOLD with p2_compressed's uploads
                     and of MOON, each dense-sync, sparse-sync
                     and sparse-overlap (capacity 20), and SCAFFOLD under
                     device sampling dense against sparse-overlap: all
                     bitwise (cuDNN deterministic), rows spilled and
                     refaulted, K1 60 (with c under SCAFFOLD),
                     topk_compress 60, K2 6 per run, the engine's timing
                     split; cnn_femnist on femnist-like at LEAF FEMNIST's
                     3,550 writers (227,200 samples), SCAFFOLD 2 × 10 ×
                     25 dense-sync against sparse-overlap at capacity 64,
                     bitwise, store bytes and rounds/s in turns; and
                     pod_algorithms' SCAFFOLD with store="sparse" bitwise
                     against its dense run;
     landscape     — the Fig. 7 diagnostics (M7) with
                     benchmarks/fig7_landscape.py's settings on LeNet-5
                     at random init, the main path's P1 and P2 params and
                     a P2 from random init: sharpness, top Hessian
                     eigenvalue, 9-point slices, on the card and on the
                     CPU from the same draws, held within stated
                     tolerances;
     llm_lora      — tinyllama-1.1b + lora:8 at full width and depth
                     (1,106,356,224 bf16 params, random from the seed) on
                     make_synthetic_tokenlm (16 clients × 32 sequences of
                     128, vocab 32,000) through run_pod_training: P1 1 ×
                     4 × 1 over the whole model, P2 2 × 4 × 1 over the
                     adapters (× 2 steps before pod_sharded_zoo); P1 K1
                     4, P2 K1 8, K6 8, K3 2, K2 0 asserted, the frozen leaves bitwise, the adapters
                     moved, upload bytes = the slice's, the eval loss
                     below the init's, fused == plain bitwise, the host
                     engine's FedAvgM round against the pod's; ms per
                     step, device ops and busy share, peak memory;
  5. serve         — hymba-1.5b at full width (1,640,872,320 params,
                     bf16, random weights from a seed) through
                     ``Engine.generate`` with attn_impl = ssd_impl =
                     "pallas": batch 8, prompt 2048, 64 greedy tokens;
                     K7 launched 32 + 32 × 64 = 2080 times and K8 32
                     times, asserted; the launches of one prefill and of
                     one decode step, each counted alone; prefill ms,
                     decode ms per step, tok/s, peak memory;
  6. serve_e2e     — the same weights and prompt through the plain
                     versions ("pallas_interpret") and through the plain
                     versions in f32: prefill logits and the first 8
                     teacher-forced decode steps' logits compared,
                     greedy-token agreement;
  7. serve_profile — one prefill and one decode step under torch.profiler:
                     device-busy share, device ops, K7's and K8's device
                     time and device kernels (K8 is three per call), top
                     device ops;
  8. moe_serve     — deepseek-v2-lite-16b at full width and depth
                     (15,706,484,224 bf16 params: MoE with capacity
                     dispatch, MLA) through ``Engine.generate``: batch 8,
                     prompt 2048, 8 greedy tokens; K7 launched 0 times
                     (MLA is not K7's), a repeat run's tokens identical,
                     the routed pairs each MoE layer drops at prefill and
                     at a decode step; init seconds and peak, prefill ms,
                     decode ms per step, tok/s, peak memory; then one
                     profiled prefill and decode step
                     (moe_serve_profile);
     moe_cut       — the same config cut to 3 layers at full width:
                     teacher-forced bf16 against f32 on the card (the gap
                     and the routing pairs that differ, reported), and
                     the card's f32 against the CPU's at batch 2 x
                     prompt 128, 4 steps: logits within MOE_CPU_TOL and
                     identical top-k routing;
  9. zoo_serve     — internvl2-1b (256 patch embeddings + 1792 tokens)
                     and musicgen-medium (2048 frames, 4 codebooks) at
                     full width, bf16, batch 8, 8 new tokens: K7 24 x 9
                     and 48 x 9 launches, split into prefill and decode;
                     zoo_serve_e2e holds each against the plain path as
                     serve_e2e does;
 10. qwen_serve    — qwen2-1.5b, the serve CLI's default arch, the same
                     way (1,543,714,304 params, the JAX package's count;
                     K7 at head_dim 128, G 6: 28 x 9 launches; tokens
                     repeat-identical; qwen_serve_e2e);
 11. moe_train     — deepseek-v2-lite-16b + lora:8 at full width and
                     depth through run_pod_training on the one-rank NCCL
                     mesh, P2 only, 2 rounds x 4 clients x 2 steps of
                     batch 8, the slice the verbatim regex
                     /(lora_a|lora_b)$|/router/w$ (f32 routers 3,407,872,
                     bf16 adapters 311,808): K1 32, K6 16, K3 4, K2 0,
                     frozen leaves bitwise, every trainable leaf and each
                     of the 26 routers moved, upload = the slice's bytes,
                     eval loss below the init's; a profiled warm P2
                     round; moe_cut_train: the 3-layer cut, P1 relaying
                     the whole model then P2, and under deterministic
                     algorithms fused == fused_interpret, a repeat run
                     and the host engine's FedAvgM round against the
                     pod's;
 12. zoo_train     — launch.steps.make_train_step at full width (bf16
                     params, f32 momentum, batch 4) on internvl2-1b,
                     musicgen-medium and deepseek's 3-layer cut: 4 steps
                     lower the batch's loss, n_micro 2 against 1 (in f32,
                     the reference test's dtype; bf16 reported), and a
                     CheckpointManager round trip of internvl2-1b's
                     params and momentum, bitwise;
 13. pod_sharded   — sharded FSDP/TP groups: tinyllama-1.1b + lora:8 at
                     full width through run_pod_training on a (2, 2)
                     data x model mesh of four gloo ranks, four processes
                     on the one card (NCCL refuses two ranks on one
                     device; gloo takes the CUDA tensors), P1 1 x 2 x 1
                     then P2 1 x 2 x 1 (x 2 before pod_sharded_zoo) of
                     batch 8,
                     under fsdp_tp
                     (tensor-parallel compute over model on every rank:
                     tp_compute, "tp" all-reduces), replicated, and
                     fsdp_only (gather-then-compute; P1 alone): fsdp_only's
                     P1 params bitwise the replicated run's, fsdp_tp's
                     losses within SHARDED_LOSS_RTOL and params within
                     SHARDED_TP_TOL of the replicated run's, each rank's
                     frozen rows the fsdp_tp view's per-shard sizes
                     (550,162,432 bytes against 2,200,096,768), K1, K6
                     and K3 once per bucket row, gathers only when
                     sharded, fsdp_tp's bytes gathered a step below the
                     gather-then-compute 2,765,660,160, P2's frozen
                     leaves kept; ms a step, bytes gathered and
                     all-reduced over model a step, collectives and peak
                     memory per rank, the card's name and power limit;
     pod_sharded_moe — the MoE zoo on the same four gloo ranks:
                     (a) deepseek-v2-lite-16b + lora:8 cut to 3 layers at
                     full width on (2, 2), P1 1 x 2 x 1 then P2 1 x 2 x 1
                     (x 2 before pod_sharded_zoo) on the
                     /(lora_a|lora_b)$|/router/w$ slice, batch 8 x
                     128, under fsdp_tp (experts, shared experts and MLA
                     heads over model; every MoE layer's capacity global
                     over data: tp_compute, "tp" and "moe" collectives)
                     and replicated ("moe" only): losses and params within
                     MOE_SHARDED_LOSS_RTOL and MOE_SHARDED_TP_TOL (bf16;
                     routing flips), P1's changes from the init within
                     MOE_SHARDED_DELTA_TOL, which a control (fsdp_tp's
                     P1 with the router's gradient summed over model;
                     with --pod-sharded-moe-control, the phase alone)
                     exceeds, frozen rows the
                     fsdp_tp view's per-shard sizes, K1, K6 and K3 once
                     a bucket row, pairs dropped (per layer, reported);
                     (b) the whole model on (1, 4) under fsdp_tp, P2 1 x
                     2 x 1: each rank draws the init in turn behind a
                     barrier and keeps only its rows (engine.FlatRows),
                     so the card holds one whole model at most; finite
                     losses, every router's layer row moved, every
                     frozen row bitwise; ms a step, peak GB a rank,
                     bytes gathered and all-reduced ("tp", "moe") a step;
     pod_sharded_zoo — the SSM, hybrid, VLM and audio zoo tensor-
                     parallel on the same four gloo ranks: (a)
                     hymba-1.5b + lora:8 at full width and depth on
                     (2, 2) (25 SSM heads a rank, the MLP's columns
                     halved, the attention whole), P1 1 x 2 x 2 then P2
                     1 x 2 x 2 at batch 8 x 128 and a FedProx P2 round
                     (mu 0.01), under fsdp_tp and replicated, each run
                     from and to its rows: tp_compute and "tp" on every
                     fsdp_tp phase (FedProx's too), losses and params
                     within ZOO_LOSS_RTOL and ZOO_TP_TOL of replicated's
                     and P1's changes within ZOO_DELTA_TOL (bf16: drift
                     and unchanged-leaf bounds), frozen rows the fsdp_tp
                     view's per-shard sizes, K1, K6 and K3 once a bucket
                     row, frozen leaves kept; the same runs of the f32
                     cut to 2 layers at full width within the tighter
                     ZOO_CUT_* gates, and its control (fsdp_tp's P1 with
                     the gated norm's sum of squares through
                     reduce_from_model), whose P1 changes must miss
                     ZOO_CUT_DELTA_TOL; (b) mamba2-1.3b at full width and
                     depth on (1, 4) served in f32 from each rank's
                     model-local tree (16 SSM heads, a quarter of the
                     vocabulary), batch 2 x prompt 1024 + 8 greedy
                     tokens after a warm-up: K8 48 launches a prefill
                     on the rank's heads, the tokens the whole tree's
                     (one process), logits and SSM state within
                     ZOO_SERVE_TOL; the weights in bf16 (model-local and
                     whole) read against the whole f32 tree; (c)
                     internvl2-1b (256 patches + 128 tokens),
                     musicgen-medium (128 frames) and hymba-1.5b (128
                     tokens) cut to 2 layers at full width in f32:
                     make_train_step model-local against whole, 2 steps
                     at batch 4 (losses, the first gradient, the params
                     within ZOO_STEP_TOL), a prefill through K7 on the
                     split heads within ZOO_PREFILL_TOL, and the control
                     on hymba, whose first gradient must miss by more
                     than 100 x ZOO_STEP_TOL; ms a step, peak GB a rank, bytes
                     gathered and all-reduced a step, prefill ms and ms
                     a decode step;
 14. dryrun        — the compile analysis (repro_torch.launch.dryrun) in
                     subprocesses on fake tensors over fake process
                     groups, five at a time, started before llm_lora so
                     that they run on the host's cores beside the
                     whole-step phases, never beside the kernel phase
                     (read after pod_sharded): every assigned arch at
                     train_4k, qwen2-1.5b at prefill_32k,
                     deepseek-v2-lite-16b at decode_32k and hymba-1.5b at
                     long_500k on 16x16, tinyllama-1.1b and
                     deepseek-v3-671b at train_4k on 2x16x16; one row a
                     pair (per-rank FLOPs, bytes, collective bytes by
                     kind, the roofline terms against the H100's peaks,
                     useful_flops_ratio, tp_compute: every arch whose
                     plan splits a part computes tensor-parallel over
                     model), every pair ok;
 15. dryrun_check  — (a) tinyllama-1.1b's train step at batch 8 x 512
                     captured on fake tensors and run on the card under
                     the same counter: FLOPs and bytes equal exactly; the
                     warm step's ms (CUDA events, median of 5) beside its
                     t_compute_s, t_memory_s and model FLOPs / (ms x
                     989e12); (b) lower_pod_round on a fake (2, 2) mesh
                     for pod_sharded's configuration, pod_sharded_moe's
                     cut and pod_sharded_zoo's hymba-1.5b (a
                     subprocess), cyclic + fl (the zoo's FedProx: fl):
                     its collectives and bytes by kind equal each
                     pod_sharded, pod_sharded_moe and pod_sharded_zoo
                     rank's under fsdp_tp;
 16. pod_aot       — tinyllama-1.1b at full width (f32) through
                     make_pod_cyclic_round and make_pod_fl_round, K 2, 2
                     local steps, batch 8 x 128: P1 bitwise the chain of
                     _local_sgd (deterministic algorithms), P2 within
                     3e-5 of the clients' weighted mean; ms a round, peak
                     GB;
 17. resnet8       — ResNet-8's forward at cifar100c-hard's shape (batch
                     64, 32 x 32 x 3, 20 classes), batch and group norm,
                     TF32 off, against the same forward in f32 on the
                     CPU within RESNET8_TOL; its ms;
then the ``kernels`` summary (K1, K2, K3 and K6 with a ``bf16_form``
at llm_lora's buckets and its launches there; K1, K3 and K6 with a
``sharded_form`` at pod_sharded's per-shard rows and a
``sharded_moe_form`` at pod_sharded_moe's; K1–K3 with their N
814,080 rows and
launches on charlm_path and fashion_path; the threshold's row its
radix route on charlm_compressed, its cluster form beside it; K4 with
its top-k and residual form's launches there; K1 with its c form's
times and launches;
K7 with each serve shape's times and its launches on zoo_serve and
moe_serve (0); K8 with
its device kernels per call, since one ``ssd_scan`` call is three, and
a ``tp_form`` at a rank's 16 heads of mamba2-1.3b with its launches on
pod_sharded_zoo), the
nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
the last line; without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS's deterministic workspace (its size on an H100 is the default's),
# set before any cuBLAS call: moe_cut_train's gates run under
# torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

N_SMALL = 137_216          # LeNet-5's 136,886 params padded to 1024
N_LARGE = 16_777_216
TOPK_CUT = 16 * 40 * 1024  # fused_update.topk_cut(): the cluster's reach
KERNEL_TOL = 0.0    # bitwise: K1-K3 round where the plain versions do
SEED = 0
# time_ms trials of each row of the kernel phase's variant sweeps (the
# rows a path reports take five): each trial is the mean of 20 calls
SWEEP_TRIALS = 1

# hymba-1.5b serving shapes: batch 8, prompt 2048, 64 new tokens
SERVE_B, SERVE_S, SERVE_NEW = 8, 2048, 64
SERVE_T = SERVE_S + SERVE_NEW
# serve_e2e compares the prefill and the first E2E_STEPS decode steps
# (fewer than the 64 generated: it holds the script's time)
E2E_STEPS = 8
HYMBA_PARAMS = 1_640_872_320
# deepseek-v2-lite-16b (moe_serve) and the VLM and audio backbones
# (zoo_serve): batch 8, 2048 prompt positions, 8 new tokens (32 cost the
# script ~25 s more, past its time budget on a slow host)
ZOO_NEW = 8
ZOO_T = SERVE_S + ZOO_NEW
ZOO_PARAMS = {"deepseek-v2-lite-16b": 15_706_484_224,
              "internvl2-1b": 493_780_992,
              "musicgen-medium": 1_824_671_232,
              # qwen_serve: the serve CLI's default arch (28 layers, d
              # 1536, 12 heads on 2, head_dim 128, no window)
              "qwen2-1.5b": 1_543_714_304}
# moe_serve's depth cut: 8 teacher-forced decode steps; the card-vs-CPU
# f32 check at batch 2 x prompt 128, 4 steps, within MOE_CPU_TOL
MOE_CUT_NEW, MOE_CPU_B, MOE_CPU_S, MOE_CPU_NEW = 8, 2, 128, 4
MOE_CPU_TOL = 2e-4      # |card - cpu| <= tol + tol*|cpu|, f32 logits
# moe_train: deepseek-v2-lite-16b + lora:8 (15,706,796,032 params), its
# trainable slice by a verbatim regex: the 26 MoE routers of 2048 x 64
# (one stacked leaf, f32 as in the JAX package) and the dense layer's MLP
# adapters (bf16), two buckets; P2 2 rounds x 4 clients x 2 steps of
# batch 8 at full width and depth, then the 3-layer cut (the dense layer
# and two MoE layers) whose slice holds two routers
MOE_PEFT, MOE_FILTER, MOE_K = "lora:8", r"/(lora_a|lora_b)$|/router/w$", 4
MOE_LORA_PARAMS = 15_706_796_032
MOE_SLICE = {"float32": 3_407_872, "bfloat16": 311_808}
MOE_CUT_SLICE = {"float32": 262_144, "bfloat16": 311_808}
MOE_CUT_LAYERS = 3
# zoo_train: make_train_step at full width, bf16 params, f32 momentum,
# batch 4: (arch, depth cut or None, prompt positions); 4 steps on one
# batch at ZOO_TRAIN_LR, n_micro 2 against 1 within ZOO_MICRO_TOL
ZOO_TRAIN = (("internvl2-1b", None, 256), ("musicgen-medium", None, 512),
             ("deepseek-v2-lite-16b", MOE_CUT_LAYERS, 256))
ZOO_TRAIN_B, ZOO_TRAIN_STEPS, ZOO_TRAIN_LR = 4, 4, 1e-2
ZOO_MICRO_TOL = {"moe": 5e-2, "other": 2e-2}   # max|diff| / max|p|, a leaf


def _kernel_cases() -> dict:
    B, S, T, H, KH, hd, W = SERVE_B, SERVE_S, SERVE_T, 25, 5, 64, 1024
    att = dict(H=H, KH=KH, hd=hd)
    return {
        "flash_attention": {
            "prefill_global": dict(B=B, S=S, T=T, window=None, q_offset=0,
                                   **att),
            "prefill_swa": dict(B=B, S=S, T=T, window=W, q_offset=0, **att),
            f"decode_{S}_swa": dict(B=B, S=1, T=T, window=W, q_offset=S,
                                    **att),
            f"decode_{S}_global": dict(B=B, S=1, T=T, window=None,
                                       q_offset=S, **att),
            f"decode_{T - 1}_swa": dict(B=B, S=1, T=T, window=W,
                                        q_offset=T - 1, **att),
            f"decode_{T - 1}_global": dict(B=B, S=1, T=T, window=None,
                                           q_offset=T - 1, **att),
            "ragged_777": dict(B=2, S=777, T=777, window=None, q_offset=0,
                               **att),
            # zoo_serve's shapes: internvl2-1b (14 heads on 2, G 7) and
            # musicgen-medium (24 on 24, G 1), hd 64, and qwen_serve's:
            # qwen2-1.5b (12 on 2, G 6), hd 128; 2048 prompt positions +
            # ZOO_NEW tokens: prefill and the last decode step
            **{f"{name}_{kind}": dict(
                B=B, S=S if kind == "prefill" else 1, T=ZOO_T,
                window=None, q_offset=0 if kind == "prefill" else ZOO_T - 1,
                H=h, KH=kh, hd=d)
               for name, h, kh, d in (("internvl2", 14, 2, 64),
                                      ("musicgen", 24, 24, 64),
                                      ("qwen2", 12, 2, 128))
               for kind in ("prefill", f"decode_{ZOO_T - 1}")},
        },
        "ssd_scan": {
            "hymba": dict(b=B, s=S, h=50, p=64, n=16, g=1, chunk=128),
            "grouped": dict(b=2, s=S, h=48, p=64, n=16, g=4, chunk=128),
            "mamba2_n128": dict(b=2, s=S, h=64, p=64, n=128, g=1, chunk=128),
            # pod_sharded_zoo (b): a rank's 16 of mamba2-1.3b's 64 heads on
            # (1, 4), batch 2 x prompt ZOO_SERVE_S
            "mamba2_tp4": dict(b=2, s=1024, h=16, p=64, n=128, g=1,
                               chunk=128),
            "ragged_2000": dict(b=2, s=2000, h=50, p=64, n=16, g=1,
                                chunk=128),
        },
        # K1 at the main path's setting (p -= lr*g), then with momentum,
        # decay and clip; back to back, so PDL overlaps launch and tail
        "local_step": {
            "main": dict(n=N_SMALL, has_m=False, has_c=False, wd=0.0,
                         clip=1.0),
            "momentum": dict(n=N_SMALL, has_m=True, has_c=False),
            "large": dict(n=N_LARGE, has_m=False, has_c=False, wd=0.0,
                          clip=1.0),
        },
        # the threshold at density 0.25: the main path's bucket (the
        # cluster kernel) and N_LARGE (four radix passes)
        "topk_threshold": {"main": dict(n=N_SMALL),
                           "large": dict(n=N_LARGE)},
        # K4 alone back to back at the main path's bucket: the int8 dense
        # upload (p2_int8), and top-k + residual (the chain's second launch)
        "compress_delta": {"int8": dict(n=N_SMALL, bits=8, topk=False,
                                        res=False),
                           "topk_res": dict(n=N_SMALL, bits=8, topk=True,
                                            res=True)},
        # the top-k compressed upload (int8 + residual, density 0.25) at the
        # main path's bucket and at the cut: one fused launch, the
        # two-launch chain timed in turns beside it
        "topk_compress": {"main": dict(n=N_SMALL, bits=8, res=True),
                          "cut": dict(n=TOPK_CUT, bits=8, res=True)},
        # K6 (f32 w/p) back to back: the sequential pod aggregate, the
        # compressed uploads' accum-only form, and N_LARGE
        "delta_accum": {"with_p": dict(n=N_SMALL, with_p=True),
                        "accum_only": dict(n=N_SMALL, with_p=False),
                        "large": dict(n=N_LARGE, with_p=True)},
        # one warm P1 round of the main path under the profiler: device
        # ms per SGD step, and the idle gap before each K1
        "sgd_step": {"p1_round": dict(clients=25, steps=20)},
        # one warm P2 round under the profiler, the main path's uploads
        # and the compressed ones: device ops, K3's and the threshold's
        # device kernels
        "p2_round": {"main": dict(steps=25, upload=None),
                     "compressed": dict(steps=25)},
        # K3 back to back at the main path's bucket: FedAvgM and FedAdam in
        # the aggregate form (the chain it replaces timed in turns), the
        # delta form under momentum and the pod's apply ("none")
        "server_update": {"momentum": dict(n=N_SMALL, opt="momentum",
                                           form="avg"),
                          "momentum_delta": dict(n=N_SMALL, opt="momentum"),
                          "none": dict(n=N_SMALL, opt="none"),
                          "adam": dict(n=N_SMALL, opt="adam", form="avg")},
        # K5 back to back: one client's upload with and without noise, and
        # the rows form for the 10 clients of a round (the per-client chain
        # timed in turns)
        "dp_clip_noise": {"per_client": dict(n=N_SMALL, has_z=True),
                          "per_client_no_noise": dict(n=N_SMALL,
                                                      has_z=False),
                          "rows": dict(n=N_SMALL, has_z=True, K=10)},
        # the materialized DP uploads of one private engine round under the
        # profiler (draws made beforehand, no masks)
        "dp_upload": {"private": dict()},
        # one warm pod P2 round on a one-rank NCCL mesh under the
        # profiler: device ops and the idle gap before each K6
        "pod_round": {"compressed": dict(compressed=True),
                      "sequential": dict(compressed=False)},
    }


# kernel -> label -> keyword arguments (all but dtype and label) of the
# KernelBench method of that name: the K7/K8 cases of the kernel phase,
# hymba-1.5b's serve shapes first, then, for tools/kernel_trees.py only
# (which times any of these cases on two source trees), K1's, the
# threshold's, K4's, the top-k compressed upload's, K6's, K3's, K5's,
# three profiled rounds' and the profiled materialized DP uploads'.
KERNEL_CASES = _kernel_cases()

# data-sheet peaks (NVIDIA H100 SXM data sheet): bytes/s, f32 FLOP/s
# (CUDA cores), bf16 FLOP/s (dense tensor cores).  Other cards raise in
# card_peaks until a run on one adds its row.
_PEAKS = (("H100 HBM3", 3.35e12, 67e12, 989e12),)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - _T0, 3))
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    up = name.upper()
    for key, bw, f32, bf16 in _PEAKS:
        if all(part in up for part in key.split()):
            return bw, f32, bf16
    raise SystemExit(f"chip_smoke: no data-sheet peaks for {name!r}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, trials: int = 5, reps: int = 20,
            warmup: int = 3, flush=None) -> float:
    """Median over ``trials`` of the mean device time per call of
    ``reps`` back-to-back calls.  A sleep kernel queued first keeps the
    device busy while the host enqueues the calls, so the events time
    the device work, not the host's launch rate.  With ``flush`` (a
    tensor larger than the L2) each call runs from a cold L2: a read of
    ``flush`` comes before it, outside its own pair of events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 if flush is None else 2 * reps)]
        torch.cuda._sleep(50_000_000)
        if flush is None:
            ev[0].record()
            for _ in range(reps):
                fn()
            ev[1].record()
        else:
            for i in range(reps):
                flush.sum()
                ev[2 * i].record()
                fn()
                ev[2 * i + 1].record()
        ev[-1].synchronize()
        out.append(sum(a.elapsed_time(b) for a, b in zip(ev[::2], ev[1::2]))
                   / reps)
    return statistics.median(out)


class KernelBench:
    """Kernel-vs-plain checks on the card (phase 2)."""

    def __init__(self, torch, fu, peaks):
        from repro_torch.kernels import work
        self.torch, self.fu = torch, fu
        # each kernel's operations and bytes (its bound's numerator), as
        # the compile analysis counts them
        self.work = work
        self.bw, self.flops, self.flops_bf16 = peaks
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(SEED)
        # set: every call is timed from a cold L2 (see time_ms)
        self.flush = None
        # time_ms's trials and reps per timing; the variant sweeps take
        # fewer trials (SWEEP_TRIALS) than the path shapes
        self.trials, self.reps = 5, 20

    def time(self, fn, **kw) -> float:
        kw = dict(dict(trials=self.trials, reps=self.reps), **kw)
        return time_ms(self.torch, fn, flush=self.flush, **kw)

    def rand(self, *shape, dtype=None):
        t = self.torch.randn(*shape, generator=self.gen, device=self.gen.device)
        return t.to(dtype or self.torch.float32)

    def bound_ms(self, n_bytes: float, n_ops: float, peak=None):
        t_bytes, t_ops = n_bytes / self.bw, n_ops / (peak or self.flops)
        return max(t_bytes, t_ops) * 1e3, \
            "bytes" if t_bytes >= t_ops else "operations"

    @staticmethod
    def max_err(pairs) -> float:
        return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)

    def local_step(self, n, dtype, has_m, has_c, wd=1e-3, clip=0.7,
                   label="", c_rows=0):
        """K1; with ``c_rows`` the correction is a row view of a
        ``(c_rows, n)`` stack, as SCAFFOLD's round hands it to K1."""
        torch, fu = self.torch, self.fu
        p, g = self.rand(n, dtype=dtype), self.rand(n, dtype=dtype)
        m = self.rand(n, dtype=dtype) if has_m else None
        c = None
        if has_c:
            c = (self.rand(c_rows, n, dtype=dtype)[c_rows // 2] if c_rows
                 else self.rand(n, dtype=dtype))
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
        ms = self.time(lambda: fu.local_step(pk, g, mk, c, sc, **kw))
        pp, mp = clones()
        plain = self.time(lambda: fu.local_step_plain(pp, g, mp, c, sc,
                                                           **kw))
        n_ops, n_bytes = self.work.local_step(p, g, m, c, sc, **kw)
        library, why = None, "no single PyTorch call applies clip scale, " \
            "weight decay and momentum in this order"
        if not has_m and not has_c and not wd and clip == 1.0:
            pl = p.clone()
            library = self.time(lambda: pl.add_(g, alpha=-0.05))
            why = "Tensor.add_(g, alpha=-step): the same function at " \
                "clip 1, no decay, no momentum"
        elif not has_m and not wd and clip == 1.0:
            why = "none: p -= step*(g + c) is two PyTorch calls " \
                "(an add, then add_)"
        bound, by = self.bound_ms(n_bytes, n_ops)
        return dict(kernel="local_step", n=n, dtype=str(dtype)[6:],
                    momentum=has_m, c=has_c, c_row_of=c_rows or None,
                    weight_decay=wd,
                    clip_scale=clip, max_abs_err=err, ms=ms, plain_ms=plain,
                    library_ms=library, library_note=why, bound_ms=bound,
                    bound_by=by, within_tol=err <= KERNEL_TOL)

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
        ms = self.time(lambda: fu.weighted_delta(stacked, p, w, **kw))
        plain = self.time(lambda: fu.weighted_delta_plain(stacked, p, w,
                                                               **kw))
        n_ops, n_bytes = self.work.weighted_delta(stacked, p, w, **kw)
        library, why = None, "no single PyTorch call adds the extra term"
        if dtype != torch.float32:
            why = "torch.addmv takes one dtype; the stack is bf16, the " \
                "weights f32"
        elif not has_extra:
            st = stacked.t()
            if deltas:
                library = self.time(lambda: torch.addmv(p, st, w))
                why = "torch.addmv(p, stacked.T, w)"
            else:
                beta = 1.0 - float(w.sum())
                library = self.time(lambda: torch.addmv(p, st, w,
                                                             beta=beta))
                why = "torch.addmv(p, stacked.T, w, beta=1-sum(w)): the " \
                    "same function in exact arithmetic"
        bound, by = self.bound_ms(n_bytes, n_ops)
        return dict(kernel="weighted_delta", n=n, dtype=str(dtype)[6:], K=K,
                    extra=has_extra, deltas=deltas, max_abs_err=err, ms=ms,
                    plain_ms=plain, library_ms=library, library_note=why,
                    bound_ms=bound, bound_by=by)

    def server_update(self, n, opt, dtype=None, label="", form="delta",
                      turns=3):
        """K3 back to back, in place on p and its moments.  ``form``
        "delta" takes the f32 delta; "avg" the round's aggregate (p's
        dtype), bitwise against its plain version and against the chain
        it replaces (the torch subtraction, then the delta form), which is
        timed in turns with it.  On a tree without the aggregate form the
        chain is the kernel timed."""
        import inspect
        torch, fu = self.torch, self.fu
        dtype = dtype or torch.float32
        p, d = self.rand(n, dtype=dtype), self.rand(n) * 1e-2
        avg = (p.float() + d).to(dtype)
        n_m = {"none": 0, "momentum": 1, "adam": 2}[opt]
        moments = [self.rand(n, dtype=dtype).abs() for _ in range(n_m)]
        sc = torch.tensor([0.5, 0.19, 0.0199][:3 if opt == "adam" else 1],
                          dtype=torch.float32, device="cuda")
        kw = dict(opt=opt, beta=0.9, b1=0.9, b2=0.99)
        has_avg = "avg" in inspect.signature(fu.server_update).parameters

        def chain(pp, mm):
            fu.server_update(pp, avg.float() - pp.float(), mm, sc, **kw)

        if form == "delta":
            def run(pp, mm):
                fu.server_update(pp, d, mm, sc, **kw)

            def plain(pp, mm):
                fu.server_update_plain(pp, d, mm, sc, **kw)
        else:
            run = (lambda pp, mm: fu.server_update(pp, None, mm, sc, avg=avg,
                                                   **kw)) if has_avg else chain

            def plain(pp, mm):
                fu.server_update_plain(pp, avg.float() - pp.float(), mm, sc,
                                       **kw)

        def clones():
            return p.clone(), tuple(m.clone() for m in moments)
        outs = []
        for fn in (run, plain) + ((chain,) if form == "avg" else ()):
            pk, mk = clones()
            fn(pk, mk)
            outs.append((pk,) + mk)
        err = self.max_err(list(zip(outs[0], outs[1])))
        bitwise = all(bool(torch.equal(a, b)) for o in outs[1:]
                      for a, b in zip(outs[0], o))
        pk, mk = clones()
        ms, chain_ms = [], []
        for _ in range(turns if form == "avg" else 1):
            ms.append(self.time(lambda: run(pk, mk)))
            if form == "avg":
                chain_ms.append(self.time(lambda: chain(pk, mk)))
        pp, mp = clones()
        plain_ms = self.time(lambda: plain(pp, mp))
        # p, the delta (f32) or avg (p's dtype) and the moments read once;
        # p and the moments written once
        n_ops, n_bytes = self.work.server_update(
            p, d if form == "delta" else None, moments, sc,
            avg=avg if form == "avg" else None, opt=opt)
        pl, ml = clones()
        neg_d = (-d).to(dtype)
        library, why = None, "no single PyTorch call forms avg - p and " \
            "applies the server optimizer"
        if form == "delta" and opt == "none":
            library = self.time(lambda: pl.add_(d))
            why = "Tensor.add_(d)"
        elif form == "delta" and opt == "momentum":
            lib = torch._fused_sgd_
            library = self.time(lambda: lib(
                [pl], [neg_d], [ml[0]], weight_decay=0.0, momentum=0.9,
                lr=0.5, dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False))
            why = "torch._fused_sgd_ on the pseudo-gradient -d"
        elif form == "delta":
            lib = torch._fused_adam_
            steps = [torch.ones((), device="cuda")]
            library = self.time(lambda: lib(
                [pl], [neg_d], [ml[0]], [ml[1]], [], steps, lr=0.5,
                beta1=0.9, beta2=0.99, weight_decay=0.0, eps=1e-8,
                amsgrad=False, maximize=False))
            why = "torch._fused_adam_ on the pseudo-gradient -d"
        bound, by = self.bound_ms(n_bytes, n_ops)
        extra = dict(chain_ms=statistics.median(chain_ms),
                     chain_ms_turns=chain_ms, ms_turns=ms,
                     aggregate_form=has_avg) if form == "avg" else {}
        return dict(kernel="server_update", case=label, n=n,
                    dtype=str(dtype)[6:], opt=opt, form=form,
                    max_abs_err=err, bitwise=bitwise,
                    within_tol=bitwise and err <= KERNEL_TOL,
                    ms=statistics.median(ms), plain_ms=plain_ms,
                    library_ms=library, library_note=why, bound_ms=bound,
                    bound_by=by, **extra)

    # --- client-upload kernels (K4, the top-k threshold, K5) ---------------

    def delta(self, n):
        """A client delta at the scale of a local run's: N(0, 1e-2²), one
        all-zero 128-lane row (the guarded division)."""
        d = self.rand(n) * 1e-2
        d[128:256] = 0.0
        return d

    def compress_delta(self, n, bits, topk, res, dtype=None, label=""):
        torch, fu = self.torch, self.fu
        d = self.delta(n)
        k = -(-n // 4)                      # density 0.25
        tau = fu.topk_threshold(d, k)
        kw = dict(bits=bits, topk=topk, with_residual=res)
        got = fu.compress_delta(d, tau, **kw)
        want = fu.compress_delta_plain(d, tau, **kw)
        pairs = list(zip(got, want)) if res else [(got, want)]
        err = self.max_err(pairs)
        bitwise = all(bool(torch.equal(a, b)) for a, b in pairs)
        ms = self.time(lambda: fu.compress_delta(d, tau, **kw))
        plain = self.time(lambda: fu.compress_delta_plain(d, tau, **kw))
        n_ops, n_bytes = self.work.compress_delta(d, tau, **kw)
        bound, by = self.bound_ms(n_bytes, n_ops)
        return dict(kernel="compress_delta", n=n, bits=bits, topk=topk,
                    residual=res, max_abs_err=err, bitwise=bitwise,
                    within_tol=bitwise, ms=ms,
                    plain_ms=plain, library_ms=None,
                    library_note="no PyTorch call quantizes blockwise with "
                    "bf16 scales", bound_ms=bound, bound_by=by)

    def topk_threshold(self, n, dtype=None, label=""):
        """The threshold at density 0.25 through the wrapper's own choice
        of kernel; the launches per call counted."""
        torch, fu = self.torch, self.fu
        d = self.delta(n)
        k = -(-n // 4)                      # density 0.25
        before = fu.topk_threshold.launches
        got = fu.topk_threshold(d, k)
        per_call = fu.topk_threshold.launches - before
        want = fu.topk_threshold_plain(d, k)
        a = d.abs()
        lib = torch.kthvalue(a, n - k + 1).values
        bitwise = bool(got.view(torch.int32) == want.view(torch.int32))
        ms = self.time(lambda: fu.topk_threshold(d, k))
        plain = self.time(lambda: fu.topk_threshold_plain(d, k),
                        trials=3, reps=5, warmup=1)
        library = self.time(lambda: torch.kthvalue(a, n - k + 1),
                          trials=3, reps=5, warmup=1)
        # the selection reads |d| once; the ops: abs + compare per element
        n_ops, n_bytes = self.work.topk_threshold(d, k)
        bound, by = self.bound_ms(n_bytes, n_ops)
        shape = {}
        if per_call == 1:                   # the cluster kernel
            # as the library sizes the launch (csrc/upload.cu)
            shape = dict(n_ctas=fu.TOPK_CLUSTER, slice=fu.topk_slice(n),
                         dynamic_smem_per_cta=int(
                             fu._lib().up_topk_cluster_smem_bytes(n)))
        agrees = bool(lib == want)
        return dict(kernel="topk_threshold", n=n, k=k,
                    kernel_path="cluster" if per_call == 1 else "radix",
                    launches_per_call=per_call, **shape,
                    max_abs_err=float((got - want).abs()), bitwise=bitwise,
                    tau=float(got), kthvalue_agrees=agrees,
                    within_tol=bitwise and agrees,
                    ms=ms, plain_ms=plain, library_ms=library,
                    library_note="torch.kthvalue(|d|, n-k+1) on a "
                    "precomputed |d|", bound_ms=bound, bound_by=by)

    def topk_compress(self, n, bits=8, res=True, dtype=None, label="",
                      turns=3):
        """The top-k compressed upload at density 0.25 through the
        wrapper's own size dispatch (one fused launch up to the cut),
        bitwise (c, r and τ) against ``topk_compress_plain`` and against
        the two-launch chain ``compress_delta(topk_threshold(d))``, which
        is timed in turns with it (no one PyTorch call computes the same
        function); the threshold alone is timed beside them.  On a tree
        without ``topk_compress`` the chain is the kernel timed."""
        torch, fu = self.torch, self.fu
        d = self.delta(n)
        k = -(-n // 4)                      # density 0.25
        kw = dict(bits=bits, with_residual=res)

        def chain():
            tau = fu.topk_threshold(d, k)
            out = fu.compress_delta(d, tau, bits=bits, topk=True,
                                    with_residual=res)
            return (*(out if res else (out, None)), tau)

        def plain_chain():
            tau = fu.topk_threshold_plain(d, k)
            out = fu.compress_delta_plain(d, tau, bits=bits, topk=True,
                                          with_residual=res)
            return (*(out if res else (out, None)), tau)
        fused = getattr(fu, "topk_compress", None)
        run = (lambda: fused(d, k, **kw)) if fused else chain
        plain = (lambda: fu.topk_compress_plain(d, k, **kw)) if fused \
            else plain_chain
        before = sum(f.launches for f in fu.UPLOAD_KERNELS)
        got = run()
        per_call = sum(f.launches for f in fu.UPLOAD_KERNELS) - before
        want, ch = plain(), chain()

        def same(a, b):
            return all(bool(torch.equal(x.view(torch.int32),
                                        y.view(torch.int32)))
                       for x, y in zip(a, b) if x is not None)
        bitwise, chain_bitwise = same(got, want), same(got, ch)
        err = self.max_err([(x, y) for x, y in zip(got, want)
                            if x is not None])
        ms, chain_ms = [], []
        for _ in range(turns):
            ms.append(self.time(run))
            chain_ms.append(self.time(chain))
        threshold_ms = self.time(lambda: fu.topk_threshold(d, k))
        plain_ms = self.time(plain, trials=3, reps=5, warmup=1)
        # d read once, c (and r) written once, τ written; the threshold's
        # abs + compare and the compression's operations per element
        n_ops, n_bytes = self.work.topk_compress(d, k, **kw)
        bound, by = self.bound_ms(n_bytes, n_ops)
        lib, shape = fu._lib(), {}
        if n <= fu.topk_cut() and fused:    # as the library sizes the launch
            shape = dict(n_ctas=fu.TOPK_CLUSTER * int(
                             lib.up_topk_compress_clusters(n)),
                         dynamic_smem_per_cta=int(
                             lib.up_topk_compress_smem_bytes(n)))
        return dict(kernel="topk_compress", case=label, n=n, k=k, bits=bits,
                    residual=res, fused=fused is not None,
                    launches_per_call=per_call,
                    kernel_path="cluster" if n <= fu.topk_cut() else "radix",
                    **shape,
                    max_abs_err=err, bitwise=bitwise,
                    chain_bitwise=chain_bitwise,
                    within_tol=bitwise and chain_bitwise,
                    ms=statistics.median(ms), ms_turns=ms,
                    chain_ms=statistics.median(chain_ms),
                    chain_ms_turns=chain_ms, threshold_ms=threshold_ms,
                    plain_ms=plain_ms, library_ms=None,
                    library_note="no one PyTorch call selects the k-th "
                    "largest |d| and quantizes blockwise with bf16 scales; "
                    "the chain topk_threshold + compress_delta is the "
                    "comparator (chain_ms)", bound_ms=bound, bound_by=by)

    def sgd_step(self, dtype=None, label="", clients=25, steps=20):
        """One warm P1 round of the main path (LeNet-5, ``clients`` ×
        ``steps`` SGD steps, one K1 each) under torch.profiler: the
        device's busy ms per step, and the idle gap before each K1 (its
        start less the latest end of the device ops before it; below 0
        when K1's blocks start before that op has drained)."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.cyclic import CyclicConfig, cyclic_pretrain
        torch = self.torch
        task, data = lenet_setup()
        cyc = CyclicConfig(rounds=1, participation=clients / 100,
                           local_steps=steps, batch_size=32,
                           update_impl="fused", sampling="host")
        init = task.init(torch.Generator().manual_seed(SEED))
        cyclic_pretrain(task, data, cyc, init_params=init)       # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = cyclic_pretrain(task, data, cyc, init_params=init)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy, n_ops, _ = device_activity(prof)
        gaps, k1_us = gaps_before(prof, "local_step_kernel")
        n_steps = clients * steps
        ok = len(gaps) == n_steps and all(
            math.isfinite(h["local_loss"]) for h in res.history)
        return dict(kernel="sgd_step", steps=n_steps,
                    ms=busy / 1e3 / n_steps,
                    wall_ms_per_step=wall_ms / n_steps,
                    device_ops_per_step=n_ops / n_steps,
                    k1_launches=len(gaps),
                    k1_gap_us_median=statistics.median(gaps) if gaps else None,
                    k1_gap_us_mean=statistics.fmean(gaps) if gaps else None,
                    k1_us_median=statistics.median(k1_us) if k1_us else None,
                    library_ms=None, bound_ms=None, within_tol=ok)

    def p2_round(self, dtype=None, label="", steps=25,
                 upload="p2_compressed"):
        """One warm P2 round of the main path (FedAvgM, 10 clients ×
        ``steps`` SGD steps) with the uploads of ``upload_configs()[upload]``
        (None: the main path's uncompressed uploads) under
        torch.profiler: the device's busy ms and operations, the
        threshold's device kernels and ms, and K3's device kernels."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.fl.simulation import FLConfig, run_federated
        torch = self.torch
        task, data = lenet_setup()
        fed = FLConfig(algorithm="fedavg", rounds=1, participation=0.1,
                       local_steps=steps, server_opt="momentum",
                       update_impl="fused", sampling="host",
                       **(upload_configs()[upload] if upload else {}))
        init = task.init(torch.Generator().manual_seed(SEED))
        run_federated(task, data, fed, init_params=init)         # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run_federated(task, data, fed, init_params=init)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy, n_ops, _ = device_activity(prof)
        topk_us, topk_kernels = kernel_time(prof, ("topk_",))
        k3_us, k3_kernels = kernel_time(prof, ("server_update",))
        return dict(kernel="p2_round", upload=upload, ms=busy / 1e3,
                    wall_ms=wall_ms, device_ops=n_ops,
                    topk_kernels=topk_kernels, topk_device_ms=topk_us / 1e3,
                    k3_kernels=k3_kernels, k3_device_ms=k3_us / 1e3,
                    library_ms=None,
                    bound_ms=None, within_tol=math.isfinite(res.history[-1]["local_loss"]))

    def pod_round(self, dtype=None, label="", compressed=True):
        """One warm pod P2 round of the main path on a one-rank NCCL mesh
        (FedAvgM, 10 clients × 25 SGD steps, sequential K6; with
        pod_compressed's uploads when ``compressed``) under
        torch.profiler: the device's busy ms and operations, the top-k
        kernels, and the idle gap before each K6 (its start less the
        latest end of the device ops before it; below 0 when K6's blocks
        start before that op has drained), and the top device ops by
        time."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.fl.compression import CompressionSpec
        from repro_torch.fl.pod import run_pod_rounds
        from repro_torch.launch.mesh import destroy, make_host_mesh
        torch = self.torch
        task, data = lenet_setup()
        spec_kw = {"compression": CompressionSpec(
            bits=8, density=0.25, error_feedback=True)} if compressed else {}
        init = task.init(torch.Generator().manual_seed(SEED))
        mesh = make_host_mesh()
        try:
            _, fed = pod_configs(mesh, rounds=1, spec_kw=spec_kw)
            run_pod_rounds(task, data, fed, init_params=init)    # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = run_pod_rounds(task, data, fed, init_params=init)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            destroy()
        busy, n_ops, top = device_activity(prof)
        gaps, k6_us = gaps_before(prof, "delta_accum_kernel")
        topk_us, topk_kernels = kernel_time(prof, ("topk_",))
        ok = len(gaps) == fed.clients_per_round and \
            math.isfinite(res.history[-1]["local_loss"])
        return dict(kernel="pod_round", compressed=compressed,
                    ms=busy / 1e3, wall_ms=wall_ms, device_ops=n_ops,
                    k6_launches=len(gaps), k6_gaps_us=gaps,
                    k6_gap_us_median=statistics.median(gaps) if gaps else None,
                    k6_gap_us_max=max(gaps) if gaps else None,
                    k6_us_median=statistics.median(k6_us) if k6_us else None,
                    topk_kernels=topk_kernels, topk_device_ms=topk_us / 1e3,
                    top_device_ops=top, library_ms=None, bound_ms=None,
                    within_tol=ok)

    def dp_clip_noise(self, n, has_z, dtype=None, label="", K=None,
                      turns=3):
        """K5 back to back.  ``K`` None: one client's upload from an f32
        delta.  ``K`` given: the rows form, the K uploads of a round from
        the stacked end states (``dtype``) over p in one launch, bitwise
        against its plain version and against the chain it replaces (per
        client a subtraction and a K5 launch, then the stack), which is
        timed in turns with it.  On a tree without the rows form the
        chain is the kernel timed."""
        torch, fu = self.torch, self.fu
        if K is None:
            d, z = self.delta(n), (self.rand(n) if has_z else None)
            sc = torch.tensor([0.37, 0.11], dtype=torch.float32,
                              device="cuda")
            got = fu.dp_clip_noise(d, z, sc)
            want = fu.dp_clip_noise_plain(d, z, sc)
            err = self.max_err([(got, want)])
            bitwise = bool(torch.equal(got, want))
            ms = self.time(lambda: fu.dp_clip_noise(d, z, sc))
            plain = self.time(lambda: fu.dp_clip_noise_plain(d, z, sc))
            library, why = None, "no single PyTorch call takes both " \
                "scales from device memory"
            if not has_z:
                library = self.time(lambda: torch.mul(d, sc[0]))
                why = "torch.mul(d, clip_scale)"
            n_ops, n_bytes = self.work.dp_clip_noise(d, z, sc)
            bound, by = self.bound_ms(n_bytes, n_ops)
            return dict(kernel="dp_clip_noise", case=label, form="per_client",
                        n=n, noise=has_z, max_abs_err=err, bitwise=bitwise,
                        within_tol=bitwise, ms=ms, plain_ms=plain,
                        library_ms=library, library_note=why,
                        bound_ms=bound, bound_by=by)
        dtype = dtype or torch.float32
        p = self.rand(n, dtype=dtype)
        w = (p.float()[None] + self.rand(K, n) * 1e-2).to(dtype)
        z = self.rand(K, n) if has_z else None
        scales = torch.rand(K, generator=self.gen, device="cuda") * 0.8 + 0.2
        ns = torch.tensor([0.11], device="cuda")

        def chain(one=fu.dp_clip_noise):
            return torch.stack([
                one(w[k].float() - p.float(), None if z is None else z[k],
                    torch.stack([scales[k], ns[0]])) for k in range(K)])
        rows = getattr(fu, "dp_clip_noise_rows", None)
        run = (lambda: rows(w, p, z, scales, ns)) if rows else chain
        plain = (lambda: fu.dp_clip_noise_rows_plain(w, p, z, scales, ns)) \
            if rows else (lambda: chain(fu.dp_clip_noise_plain))
        before = fu.dp_clip_noise.launches
        got = run()
        per_call = fu.dp_clip_noise.launches - before
        want, ch = plain(), chain()
        err = self.max_err([(got, want)])
        bitwise = bool(torch.equal(got, want))
        chain_bitwise = bool(torch.equal(got, ch))
        ms, chain_ms = [], []
        for _ in range(turns):
            ms.append(self.time(run))
            chain_ms.append(self.time(chain))
        plain_ms = self.time(plain, trials=3, reps=5, warmup=1)
        # w (and z) read once, the uploads written once, p read once, the
        # scales; a subtraction and a multiply (and a multiply-add) each
        n_ops, n_bytes = self.work.dp_clip_noise_rows(w, p, z, scales, ns)
        bound, by = self.bound_ms(n_bytes, n_ops)
        return dict(kernel="dp_clip_noise", case=label, form="rows",
                    rows_form=rows is not None, n=n, K=K,
                    dtype=str(dtype)[6:], noise=has_z,
                    launches_per_call=per_call, max_abs_err=err,
                    bitwise=bitwise, chain_bitwise=chain_bitwise,
                    within_tol=bitwise and chain_bitwise,
                    ms=statistics.median(ms), ms_turns=ms,
                    chain_ms=statistics.median(chain_ms),
                    chain_ms_turns=chain_ms, plain_ms=plain_ms,
                    library_ms=None, library_note="no single PyTorch call "
                    "forms w - p and takes both scales from device memory; "
                    "the per-client chain is the comparator (chain_ms)",
                    bound_ms=bound, bound_by=by)

    def dp_upload(self, dtype=None, label="", secure_agg=False):
        """The materialized DP uploads of one private engine round
        (LeNet-5, 10 clients × 25 SGD steps, DP C = 1, σ = 0.1; the masks
        only when ``secure_agg``): the round seen through on_aggregate
        (``private_round``), its draws made once beforehand, then
        ``privacy.materialized_dp_aggregate`` (the uploads, then K2) under
        torch.profiler: device ms and ops, K5's kernels and device ms; and
        the call's device time by CUDA events, median of back-to-back
        calls.  The same inputs in either tree."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.fl import privacy
        from repro_torch.fl.privacy import DPSpec
        torch = self.torch
        fed_kw = dict(dp=DPSpec(clip=1.0, sigma=0.1), secure_agg=secure_agg)
        task, _ = lenet_setup()
        init = task.init(torch.Generator().manual_seed(SEED))
        rnd = private_round(torch, init, fed_kw)
        memo = {}

        def normal_fn(kind, a, b=None):
            if (kind, a, b) not in memo:
                memo[(kind, a, b)] = rnd["normal_fn"](kind, a, b)
            return memo[(kind, a, b)]

        def call():
            return privacy.materialized_dp_aggregate(
                rnd["dp"], secure_agg, rnd["fops"], rnd["ids"], rnd["p"],
                rnd["stacked"], rnd["weights"], normal_fn)
        out = call()                                   # draws, then warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        busy, n_ops, top = device_activity(prof)
        k5_us, k5_kernels = kernel_time(prof, ("dp_clip_noise",))
        k2_us, k2_kernels = kernel_time(prof, ("weighted_delta",))
        ms = self.time(call, trials=5, reps=10, warmup=2)
        ok = all(bool(torch.isfinite(t).all()) for t in out.values())
        return dict(kernel="dp_upload", clients=len(rnd["ids"]),
                    secure_agg=secure_agg, ms=ms, device_busy_ms=busy / 1e3,
                    device_ops=n_ops, k5_kernels=k5_kernels,
                    k5_device_ms=k5_us / 1e3, k2_kernels=k2_kernels,
                    k2_device_ms=k2_us / 1e3, top_device_ops=top,
                    library_ms=None, bound_ms=None, within_tol=ok)

    # --- K6 delta_accum (the pod backend's aggregation) -------------------

    def delta_accum(self, n, dtype, with_p, label=""):
        torch, fu = self.torch, self.fu
        d = self.rand(n) * 1e-2
        w = self.rand(n, dtype=dtype)
        p = self.rand(n, dtype=dtype) if with_p else None
        c = torch.tensor([0.1], dtype=torch.float32, device="cuda")
        a, b = d.clone(), d.clone()
        fu.delta_accum(a, w, p, c)
        fu.delta_accum_plain(b, w, p, c)
        err = self.max_err([(a, b)])
        bitwise = bool(torch.equal(a, b))
        ms = self.time(lambda: fu.delta_accum(a, w, p, c))
        plain = self.time(lambda: fu.delta_accum_plain(b, w, p, c))
        library, why = None, "no single PyTorch call computes d + c*(w - p)"
        if not with_p:
            if dtype == torch.float32:
                dl = d.clone()
                library = self.time(lambda: dl.addcmul_(c, w))
                why = "Tensor.addcmul_(c, w): d + c*w in place"
            else:
                why = "Tensor.addcmul_ takes one dtype; w is bf16, d f32"
        n_ops, n_bytes = self.work.delta_accum(d, w, p, c)
        bound, by = self.bound_ms(n_bytes, n_ops)
        return dict(kernel="delta_accum", n=n, dtype=str(dtype)[6:],
                    with_p=with_p, max_abs_err=err, bitwise=bitwise,
                    within_tol=bitwise, ms=ms, plain_ms=plain,
                    library_ms=library, library_note=why, bound_ms=bound,
                    bound_by=by)

    # --- K7 flash_attention ------------------------------------------------

    def flash_attention(self, B, S, T, H, KH, hd, dtype, window, q_offset,
                        kv_len=None, label=""):
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa
        q = self.rand(B, S, H, hd, dtype=dtype)
        k = self.rand(B, T, KH, hd, dtype=dtype)
        v = self.rand(B, T, KH, hd, dtype=dtype)
        kw = dict(window=window, q_offset=q_offset, kv_len=kv_len)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, **kw)
        err, ok, tol = close(torch, out, ref, 2e-5)
        del out, ref
        t = dict(trials=3, reps=3, warmup=1) if S * T > 1 << 20 else {}
        ms = self.time(lambda: fa.flash_attention(q, k, v, **kw), **t)
        plain = self.time(lambda: fa.flash_attention_plain(q, k, v, **kw),
                        **t)
        win = fa.FULL_WINDOW if window is None else window
        kvl = T if kv_len is None else kv_len
        qpos = q_offset + torch.arange(S, device="cuda")[:, None]
        kpos = torch.arange(T, device="cuda")[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - win) & (kpos < kvl)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library = self.time(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True), **t)
        # the unmasked work: (query, key) pairs and the key rows they read
        pairs, _ = self.work.attention_pairs(S, T, window, q_offset, kv_len)
        n_ops, n_bytes = self.work.flash_attention(q, k, v, **kw)
        peak = self.flops_bf16 if dtype == torch.bfloat16 else self.flops
        bound, by = self.bound_ms(n_bytes, n_ops, peak)
        return dict(kernel="flash_attention", case=label, B=B, S=S, T=T, H=H,
                    KH=KH, hd=hd, dtype=str(dtype)[6:], window=window,
                    q_offset=q_offset, kv_len=kv_len, max_abs_err=err,
                    tol=tol, within_tol=ok, ms=ms, plain_ms=plain,
                    library_ms=library,
                    library_note="F.scaled_dot_product_attention(enable_gqa="
                    "True) with an explicit boolean mask",
                    bound_ms=bound, bound_by=by, unmasked_pairs=pairs * B * H)

    # --- K8 ssd_scan ---------------------------------------------------------

    def ssd_scan(self, b, s, h, p, n, g, chunk, dtype, label=""):
        torch = self.torch
        from repro_torch.kernels import ssd_scan as ssd
        x = self.rand(b, s, h, p, dtype=dtype)
        Bm = self.rand(b, s, g, n, dtype=dtype)
        Cm = self.rand(b, s, g, n, dtype=dtype)
        dt = torch.nn.functional.softplus(self.rand(b, s, h) - 4.0)
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        y, final = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        y_p, f_p = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
        ey, oky, tol = close(torch, y, y_p, 1e-4)
        ef, okf, _ = close(torch, final, f_p, 1e-4)
        ms = self.time(lambda: ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk))
        plain = self.time(lambda: ssd.ssd_scan_plain(x, dt, A, Bm, Cm,
                                                          chunk=chunk),
                        trials=3, reps=3, warmup=1)
        n_ops, n_bytes = self.work.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        peak = self.flops_bf16 if dtype == torch.bfloat16 else self.flops
        bound, by = self.bound_ms(n_bytes, n_ops, peak)
        return dict(kernel="ssd_scan", case=label, b=b, s=s, h=h, p=p, n=n,
                    g=g, chunk=chunk, dtype=str(dtype)[6:],
                    max_abs_err=max(ey, ef), max_abs_err_y=ey,
                    max_abs_err_state=ef, tol=tol, within_tol=oky and okf,
                    ms=ms, plain_ms=plain, library_ms=None,
                    library_note="no single PyTorch call computes the SSD "
                    "chunked scan", bound_ms=bound, bound_by=by)


def close(torch, got, want, f32_tol):
    """Max abs error and whether every element is within tolerance: f32
    at f32_tol absolute + relative (the kernels sum in another order than
    the plain versions: online softmax, sequential cumsum); a bf16 output
    within one bf16 ulp (2^-7 relative) + f32_tol, since both sides round
    an f32 value once and may land on neighbouring bf16 values."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    if got.dtype == torch.float32:
        tol = f"{f32_tol} + {f32_tol}*|ref|"
        bad = diff > f32_tol + f32_tol * b.abs()
    else:
        tol = f"2^-7*|ref| + {f32_tol}"
        bad = diff > 2.0 ** -7 * b.abs() + f32_tol
    ok = bool(torch.isfinite(a).all()) and not bool(bad.any())
    return float(diff.max()), ok, tol


def check_attention_kernels(torch, bench) -> dict:
    """Phase 2, K7 and K8: every variant at hymba-1.5b's serving shapes
    (and mamba2's d_state for K8), then the main path's shapes
    (returned)."""
    bf16, f32 = torch.bfloat16, torch.float32
    rows, main = [], {}
    for dtype in (bf16, f32):
        tag = str(dtype)[6:]
        for kname in ("flash_attention", "ssd_scan"):
            for label, kw in KERNEL_CASES[kname].items():
                r = getattr(bench, kname)(dtype=dtype, label=f"{label}_{tag}",
                                          **kw)
                rows.append(r)
                if kname == "ssd_scan" and label == "mamba2_tp4" and \
                        dtype == f32:       # pod_sharded_zoo serves f32
                    main[label] = r
                if dtype != bf16:
                    continue
                if kname == "flash_attention" and label != "ragged_777":
                    main[label] = r
                elif kname == "ssd_scan" and label == "hymba":
                    main["ssd_scan"] = r
    for r in rows:
        emit(dict(phase="kernel", **r))
    bad = [r["case"] for r in rows if not r["within_tol"]]
    if bad:
        raise SystemExit(f"chip_smoke: K7/K8 variants disagree with their "
                         f"plain versions: {bad}")
    return main


def local_step_vs_add(torch, fu, bench, turns: int = 5) -> None:
    """K1 at the main path's setting (N 137,216 f32, clip 1, no decay, no
    momentum: p -= lr*g) and Tensor.add_(g, alpha=-lr), the same function,
    timed in turns so that both see the same card and host state."""
    p, g = bench.rand(N_SMALL), bench.rand(N_SMALL)
    sc = torch.tensor([1.0, 0.05], dtype=torch.float32, device="cuda")
    pk, pl = p.clone(), p.clone()
    k_ms, a_ms = [], []
    for _ in range(turns):
        k_ms.append(time_ms(torch, lambda: fu.local_step(pk, g, None, None,
                                                         sc)))
        a_ms.append(time_ms(torch, lambda: pl.add_(g, alpha=-0.05)))
    emit(dict(phase="kernel", kernel="local_step_vs_add_", n=N_SMALL,
              turns=turns, local_step_ms=k_ms, add_ms=a_ms,
              local_step_median_ms=statistics.median(k_ms),
              add_median_ms=statistics.median(a_ms)))


# kernel family -> what its name holds in the SASS (K8's bf16 kernels are
# the template instances on __nv_bfloat16)
SASS_FAMILIES = {
    "fa_wgmma_kernel": ("fa_wgmma_kernel",),
    "fa_split_kernel": ("fa_split_kernel",),
    "ssd_state_kernel_bf16": ("ssd_state_kernel", "bfloat16"),
    "ssd_scan_kernel_bf16": ("ssd_scan_kernel", "bfloat16"),
    "topk_cluster_kernel": ("topk_cluster_kernel",),
    "local_step_kernel": ("local_step_kernel",),
    "delta_accum_kernel": ("delta_accum_kernel",),
    "compress_delta_kernel": ("compress_delta_kernel",),
    "server_update_kernel": ("server_update_kernel",),
    "dp_clip_noise_kernel": ("dp_clip_noise_kernel",),
    "dp_clip_noise_rows_kernel": ("dp_clip_noise_rows_kernel",),
}
# the families whose every template instance is checked on its own: the
# cluster kernel's threshold-only and fused (compressing) instances, and
# the PDL-launched K1, K3, K4, K5 (per client and rows) and K6
SASS_PER_INSTANCE = ("topk_cluster_kernel", "local_step_kernel",
                     "delta_accum_kernel", "compress_delta_kernel",
                     "server_update_kernel", "dp_clip_noise_kernel",
                     "dp_clip_noise_rows_kernel")
# template instances of the PDL families checked by count: K3 over 2
# dtypes x 2 alignments x 3 optimizers x 2 forms, K5 per client over 2
# alignments x noise, its rows form over 2 dtypes x 2 alignments x noise
SASS_INSTANCES = {"server_update_kernel": 24, "dp_clip_noise_kernel": 4,
                  "dp_clip_noise_rows_kernel": 8}
# the SASS opcodes counted: wgmma (HGMMA), mma.sync (HMMA), a TMA load
# (UTMALDG), cp.async (LDGSTS); the cluster barrier's arrive and wait
# (UCGABAR_ARV, UCGABAR_WAIT: barrier.cluster); st.async into another CTA's
# shared memory (STAS) and the mbarrier operations it completes (SYNCS);
# griddepcontrol.wait (ACQBULK) and griddepcontrol.launch_dependents
# (PREEXIT)
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "UCGABAR_ARV",
            "UCGABAR_WAIT", "STAS", "SYNCS", "ACQBULK", "PREEXIT")


def sass_features(lib_path) -> dict:
    """Which instructions the kernels compile to, from cuobjdump -sass on
    the built library: per kernel family, the counts of SASS_OPS; for the
    SASS_PER_INSTANCE families also per template instance (the cluster
    kernel's instances with BITS 0, the threshold alone, and with BITS
    8/16/32, the fused top-k compressed upload, told apart by the
    mangled template argument).  None when cuobjdump is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return dict(phase="env_sass", cuobjdump=None)
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = SASS_OPS
    counts, inst, fn, name = {}, {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = next((k for k, parts in SASS_FAMILIES.items()
                       if all(part in name for part in parts)), None)
        elif fn is not None:
            c = counts.setdefault(fn, dict.fromkeys(ops, 0))
            ci = inst.setdefault(fn, {}).setdefault(name, dict.fromkeys(ops, 0)) \
                if fn in SASS_PER_INSTANCE else {}
            for op in ops:
                if op + "." in line or op + " " in line:
                    c[op] += 1
                    if ci:
                        ci[op] += 1

    def every(family, need, names=None):
        got = inst.get(family, {})
        names = list(got) if names is None else names
        return bool(names) and all(got[n].get(op, 0) > 0 for n in names
                                   for op in need)
    topk = inst.get("topk_cluster_kernel", {})
    # topk_cluster_kernel<VEC, BITS, RES>: BITS 0 mangles as "ELi0E"
    fused = [n for n in topk if not re.search(r"ELi0E|<(true|false), 0,", n)]
    cluster_ops = ("UCGABAR_ARV", "UCGABAR_WAIT", "STAS", "SYNCS")
    return dict(phase="env_sass", cuobjdump=tool, counts=counts,
                instances={fam: {n[:120]: c for n, c in got.items()}
                           for fam, got in inst.items()},
                topk_instances=len(topk), topk_fused_instances=len(fused),
                topk_fused_cluster=every("topk_cluster_kernel", cluster_ops,
                                         fused),
                delta_accum_pdl_wait=every("delta_accum_kernel", ("ACQBULK",)),
                compress_delta_pdl_wait=every("compress_delta_kernel",
                                              ("ACQBULK",)),
                server_update_pdl_wait=every("server_update_kernel",
                                             ("ACQBULK",)),
                dp_clip_noise_pdl_wait=every("dp_clip_noise_kernel",
                                             ("ACQBULK",))
                and every("dp_clip_noise_rows_kernel", ("ACQBULK",)),
                pdl_instances={fam: len(inst.get(fam, {}))
                               for fam in SASS_INSTANCES},
                prefill_hgmma=counts.get("fa_wgmma_kernel", {}).get("HGMMA", 0) > 0,
                prefill_tma=counts.get("fa_wgmma_kernel", {}).get("UTMALDG", 0) > 0,
                prefill_ldgsts=counts.get("fa_wgmma_kernel", {}).get("LDGSTS", 0) > 0,
                decode_ldgsts=counts.get("fa_split_kernel", {}).get("LDGSTS", 0) > 0,
                ssd_bf16_hmma=all(counts.get(k, {}).get("HMMA", 0) > 0 for k in
                                  ("ssd_state_kernel_bf16",
                                   "ssd_scan_kernel_bf16")),
                topk_cluster_barrier=every("topk_cluster_kernel",
                                           ("UCGABAR_ARV", "UCGABAR_WAIT")),
                topk_dsmem=every("topk_cluster_kernel", ("STAS", "SYNCS")),
                local_step_pdl_wait=every("local_step_kernel", ("ACQBULK",)))


def check_kernels(torch, fu, bench) -> dict:
    """Phase 2: every variant (timed with ``SWEEP_TRIALS`` trials), then
    the main path's shapes (returned, five trials)."""
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    bench.trials = SWEEP_TRIALS
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
            # the aggregate form, in both dtypes (bitwise against its
            # plain version and the subtraction + delta form)
            for dtype in (f32, bf16):
                rows.append(bench.server_update(n, opt, dtype=dtype,
                                                form="avg"))
    bench.trials = 5
    for r in rows:
        emit(dict(phase="kernel", **r))
    bad = [r for r in rows if not r["max_abs_err"] <= KERNEL_TOL
           or not r.get("bitwise", True)]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} kernel variants disagree "
                         f"with their plain versions")
    # the shapes and settings the main path gives each kernel: K3 in its
    # aggregate form under FedAvgM, the delta form beside it
    return {
        "local_step": bench.local_step(N_SMALL, f32, False, False, wd=0.0,
                                       clip=1.0),
        # SCAFFOLD's step: c is row 5 of the round's (10, N) c - c_i stack
        "local_step_c": bench.local_step(N_SMALL, f32, False, True, wd=0.0,
                                         clip=1.0, c_rows=10),
        "weighted_delta": bench.weighted_delta(N_SMALL, 10, False, False),
        "server_update": bench.server_update(N_SMALL, "momentum",
                                             form="avg"),
        "server_update_delta": bench.server_update(N_SMALL, "momentum"),
        "server_update_none": bench.server_update(N_SMALL, "none"),
        "server_update_adam": bench.server_update(N_SMALL, "adam",
                                                  form="avg"),
    }


def check_upload_kernels(torch, bench) -> dict:
    """Phase 2, the upload kernels: every variant at both N, bitwise; the
    fused top-k compressed upload at bits 8/16/32 × residual at N_SMALL,
    at the cut and at 1,000 (a partial last row), bitwise against its
    plain version and the two-launch chain, and one past the cut (its
    4 + 1 launches); then the shapes their paths give them (returned):
    K4 at bits 8 without top-k or residual (p2_int8), the threshold
    alone at density 0.25 of the main path's bucket (fused into the
    top-k upload there), K5 with noise, the fused upload at int8 +
    residual (p2_compressed); K5 also in its rows form at K 1/10/25 ×
    f32/bf16 end states × noise, bitwise against its plain version and
    the per-client chain, and returned at K 10 with noise (dp_upload),
    the per-client form beside it."""
    rows = []
    fu = bench.fu
    bench.trials = SWEEP_TRIALS
    for n in (N_SMALL, N_LARGE):
        for bits in (8, 16, 32):
            for topk in (False, True):
                for res in (False, True):
                    rows.append(bench.compress_delta(n, bits, topk, res))
        rows.append(bench.topk_threshold(n))
        for has_z in (False, True):
            rows.append(bench.dp_clip_noise(n, has_z))
    # K5's rows form: the uploads of a round's K clients in one launch,
    # bitwise against its plain version and the per-client chain
    for K in (1, 10, 25):
        for dtype in (torch.float32, torch.bfloat16):
            for has_z in (False, True):
                rows.append(bench.dp_clip_noise(N_SMALL, has_z, dtype=dtype,
                                                K=K))
    # both kernels on either side of the cut
    cut = fu.topk_cut()
    rows += [bench.topk_threshold(cut), bench.topk_threshold(cut + 1)]
    for n in (N_SMALL, cut, 1000):
        for bits in (8, 16, 32):
            for res in (False, True):
                rows.append(bench.topk_compress(n, bits, res))
    rows.append(bench.topk_compress(cut + 1, 8, True))
    bench.trials = 5
    for r in rows:
        emit(dict(phase="kernel", **r))
    bad = [r for r in rows if not (r["bitwise"] and
                                   r["max_abs_err"] <= KERNEL_TOL)]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} upload kernel variants "
                         f"disagree with their plain versions")
    if not all(r["chain_bitwise"] and r["launches_per_call"] == 1
               for r in rows if r.get("form") == "rows"):
        raise SystemExit("chip_smoke: K5's rows form disagrees with the "
                         "per-client chain or launches other than once")
    if not all(r["kthvalue_agrees"] for r in rows
               if r["kernel"] == "topk_threshold"):
        raise SystemExit("chip_smoke: the threshold disagrees with "
                         "torch.kthvalue")
    fused = [r for r in rows if r["kernel"] == "topk_compress"]
    if not all(r["chain_bitwise"] and r["launches_per_call"] ==
               (1 if r["n"] <= cut else fu.topk_launches(r["n"]) + 1)
               for r in fused):
        raise SystemExit("chip_smoke: the fused top-k compressed upload "
                         "disagrees with the two-launch chain or launches "
                         "other than 1 up to the cut and 4 + 1 above it")
    return {
        "compress_delta": bench.compress_delta(N_SMALL, 8, False, False),
        "topk_threshold": bench.topk_threshold(N_SMALL),
        "dp_clip_noise": bench.dp_clip_noise(N_SMALL, True, K=10),
        "dp_clip_noise_per_client": bench.dp_clip_noise(N_SMALL, True),
        "dp_clip_noise_no_noise": bench.dp_clip_noise(N_SMALL, False),
        "topk_compress": bench.topk_compress(N_SMALL, 8, True),
    }


def check_pod_kernels(torch, bench) -> dict:
    """Phase 2, K6: {with p, accum-only} × {f32, bf16 w/p} at both N,
    bitwise, then the pod path's shapes (returned): f32 with p (the
    sequential aggregate) and accum-only (compressed uploads, the
    hierarchical lanes)."""
    bench.trials = SWEEP_TRIALS
    rows = [bench.delta_accum(n, dtype, with_p)
            for n in (N_SMALL, N_LARGE)
            for dtype in (torch.float32, torch.bfloat16)
            for with_p in (True, False)]
    bench.trials = 5
    for r in rows:
        emit(dict(phase="kernel", **r))
    bad = [r for r in rows if not (r["bitwise"] and
                                   r["max_abs_err"] <= KERNEL_TOL)]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} delta_accum variants "
                         f"disagree with their plain versions")
    return {"delta_accum": bench.delta_accum(N_SMALL, torch.float32, True),
            "delta_accum_accum_only": bench.delta_accum(
                N_SMALL, torch.float32, False)}


def check_charlm_kernels(torch, bench) -> dict:
    """Phase 2 at CharLSTM-256's bucket (N 814,080 f32, above
    ``topk_cut()``): the shapes charlm_path and charlm_compressed give
    each kernel, bitwise against its plain version (returned): K1 at
    clip 1, no decay, no momentum; K2 over a round's 7 clients; K3's
    FedAvgM aggregate form; the threshold alone at density 0.25 (four
    radix launches, against ``torch.kthvalue``); K4 int8 with top-k and
    the residual.  Every call (kernel, plain and library) is timed from
    a cold L2, as a step of the path meets its buffers: back to back,
    inputs of 3–26 MB stay in the 50 MB L2 and run below the HBM
    bound.  ``cold_floor_ms`` is one 4-byte ``zero_`` timed the same
    way."""
    f32 = torch.float32
    bench.flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    out = {"local_step": bench.local_step(N_CHARLM, f32, False, False,
                                          wd=0.0, clip=1.0),
           "weighted_delta": bench.weighted_delta(N_CHARLM, 7, False, False),
           "server_update": bench.server_update(N_CHARLM, "momentum",
                                                form="avg"),
           "topk_threshold": bench.topk_threshold(N_CHARLM),
           "compress_delta": bench.compress_delta(N_CHARLM, 8, True, True)}
    # the method's floor: one launch that touches 4 bytes, timed the same way
    one = torch.zeros(1, device="cuda")
    floor_ms = bench.time(one.zero_)
    bench.flush = None
    for r in out.values():
        r.update(l2="cold", cold_floor_ms=floor_ms)
        emit(dict(phase="kernel", path="charlm", **r))
    bad = [k for k, r in out.items()
           if not (r["max_abs_err"] <= KERNEL_TOL and r.get("bitwise", True))]
    thr = out["topk_threshold"]
    if bad or not (thr["kthvalue_agrees"] and thr["kernel_path"] == "radix"
                   and thr["launches_per_call"] == 4):
        raise SystemExit(f"chip_smoke: kernels at N {N_CHARLM} disagree with "
                         f"their plain versions or the threshold does not "
                         f"take its radix route: {bad}")
    return out


def check_llm_kernels(torch, bench) -> dict:
    """Phase 2 at llm_lora's bf16 buckets (the shapes that phase gives
    each kernel, returned, bitwise against their plain versions): K1 at
    clip 1, no decay, no momentum on the LoRA bucket (N 6,307,840, P2)
    and on the whole model's (N 1,106,356,224, P1; three trials of three
    calls: the plain version moves ~26 GB a call); K2 over the host
    engine's 4 clients; K3's FedAvgM aggregate form (the host engine)
    and the pod's apply ("none", an f32 delta); K6 (bf16 w and p, the
    f32 round delta)."""
    bf16 = torch.bfloat16
    out = {"local_step": bench.local_step(N_LORA, bf16, False, False,
                                          wd=0.0, clip=1.0),
           "weighted_delta": bench.weighted_delta(N_LORA, LLM_K, False,
                                                  False, dtype=bf16),
           "server_update": bench.server_update(N_LORA, "momentum",
                                                dtype=bf16, form="avg"),
           "server_update_none": bench.server_update(N_LORA, "none",
                                                     dtype=bf16),
           "delta_accum": bench.delta_accum(N_LORA, bf16, True)}
    bench.trials, bench.reps = 3, 3
    out["local_step_full"] = bench.local_step(N_TINYLLAMA, bf16, False,
                                              False, wd=0.0, clip=1.0)
    bench.trials, bench.reps = 5, 20
    torch.cuda.empty_cache()
    for r in out.values():
        emit(dict(phase="kernel", path="llm_lora", **r))
    bad = [k for k, r in out.items()
           if not (r["max_abs_err"] <= KERNEL_TOL and r.get("bitwise", True))]
    if bad:
        raise SystemExit(f"chip_smoke: bf16 kernels at llm_lora's buckets "
                         f"disagree with their plain versions: {bad}")
    return out


def padded(n: int) -> int:
    """A bucket's length as the kernels get it: padded to GRID_ALIGN."""
    from repro_torch.kernels.fused_update import GRID_ALIGN
    return -(-n // GRID_ALIGN) * GRID_ALIGN


def moe_cut_p1_buckets() -> dict:
    """The 3-layer cut's whole-model buckets (P1 relays every leaf)."""
    import dataclasses
    from repro_torch.configs import get_config, with_peft
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils.flatten import FlatView
    cut = dataclasses.replace(with_peft(get_config("deepseek-v2-lite-16b"),
                                        MOE_PEFT), n_layers=MOE_CUT_LAYERS)
    return FlatView.of(init_lm(cut, device="meta")).buffer_sizes


def check_moe_kernels(torch, bench) -> dict:
    """Phase 2 at moe_train's buckets, bitwise against the plain versions
    (returned, keyed ``<kernel>[_form]_<dtype>``): at full width each of
    the slice's two padded buckets (the f32 routers, 3,407,872, and the
    bf16 adapters, 311,808 -> 312,320): K1 at clip 1, no decay, no
    momentum, K6 (w and p of the bucket's dtype, f32 d) and K3's apply
    ("none", an f32 delta); on the 3-layer cut K2 over the host engine's
    4 clients and K3's FedAvgM aggregate form at its slice's buckets
    (262,144 and 312,320), and K1 over its whole-model bf16 P1 bucket
    (three trials of three calls).  Three trials a row (the other
    paths' rows take five) hold the script's time."""
    out = {}
    bench.trials = 3
    for name, n in MOE_SLICE.items():
        dt = getattr(torch, name)
        n = padded(n)
        out[f"local_step_{name}"] = bench.local_step(n, dt, False, False,
                                                     wd=0.0, clip=1.0)
        out[f"delta_accum_{name}"] = bench.delta_accum(n, dt, True)
        out[f"server_update_none_{name}"] = bench.server_update(
            n, "none", dtype=dt)
    for name, n in MOE_CUT_SLICE.items():
        dt = getattr(torch, name)
        n = padded(n)
        out[f"weighted_delta_{name}"] = bench.weighted_delta(
            n, MOE_K, False, False, dtype=dt)
        out[f"server_update_{name}"] = bench.server_update(
            n, "momentum", dtype=dt, form="avg")
    bench.trials, bench.reps = 3, 3
    out["local_step_cut_p1"] = bench.local_step(
        padded(moe_cut_p1_buckets()["bfloat16"]), torch.bfloat16, False,
        False, wd=0.0, clip=1.0)
    bench.trials, bench.reps = 5, 20
    torch.cuda.empty_cache()
    for r in out.values():
        emit(dict(phase="kernel", path="moe_train", **r))
    bad = [k for k, r in out.items()
           if not (r["max_abs_err"] <= KERNEL_TOL and r.get("bitwise", True))]
    if bad:
        raise SystemExit(f"chip_smoke: kernels at moe_train's buckets "
                         f"disagree with their plain versions: {bad}")
    return out


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
    launches = {fn.__name__: fn.launches
                for fn in fu.KERNELS + fu.UPLOAD_KERNELS}

    k1, k2 = cyc.n_selected(100), fed.n_selected(100)
    want = {"local_step": cyc.rounds * k1 * cyc.local_steps +
            fed.rounds * k2 * fed.local_steps,
            "weighted_delta": fed.rounds, "server_update": fed.rounds,
            "compress_delta": 0, "topk_threshold": 0, "dp_clip_noise": 0,
            "topk_compress": 0}
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
    return launches, p1.params, res


ALGORITHMS = ("fedavg", "fedprox", "scaffold", "moon")


def p2_algorithms(torch, fu, init) -> dict:
    """Phase p2_algorithms: the paper's Table I baselines on the card.
    From the main path's P1 params, P2 2 rounds × 10 clients × 10 steps
    (cut from 25 to hold the script's time; batch 32, the FLConfig
    defaults: mu 0.01, temperature 0.5, no server optimizer) for fedavg,
    fedprox, scaffold and moon.  Asserted per algorithm: K1 200
    launches, K1 with SCAFFOLD's correction c 200 under scaffold and 0
    otherwise, K2 2, K3 and the upload
    kernels 0, accuracy above chance, ledger == closed form (4 X per
    client per round for scaffold, 2 X for the others).  Reported:
    rounds/s, ms per SGD step, and a profiled warm round's device ops
    per step (a round cut to 2 clients: the trace's size sets the
    profiler's own cost).  Then scaffold's first round against fedavg's
    from the same init and index stream (cuDNN deterministic): bitwise,
    since c = c_i = 0 there.  Returns K1's c-form launches."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import comm_accounting as acc
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.utils.tree_math import size_bytes, tree_leaves
    task, data = lenet_setup()
    rows, c_launches = {}, {}
    for algo in ALGORITHMS:
        fed = FLConfig(algorithm=algo, rounds=2, participation=0.1,
                       local_steps=10, batch_size=32, update_impl="fused",
                       sampling="host")
        steps = fed.rounds * fed.n_selected(100) * fed.local_steps
        ledger = acc.CommLedger()
        fu.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_federated(task, data, fed, init_params=init, ledger=ledger)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches(fu)
        c_launches[algo] = fu.local_step.c_launches
        want = {"local_step": steps, "weighted_delta": fed.rounds,
                "server_update": 0, "compress_delta": 0, "topk_threshold": 0,
                "dp_clip_noise": 0, "topk_compress": 0, "delta_accum": 0}
        closed = acc.overhead_without_cyclic(
            algo, fed.n_selected(100), fed.rounds, size_bytes(res.params))
        one = dataclasses.replace(fed, rounds=1, participation=0.02)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            run_federated(task, data, one, init_params=init)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t1) * 1e6
        busy, n_ops, top = device_activity(prof, n_top=6)
        one_steps = one.n_selected(100) * one.local_steps
        rows[algo] = dict(
            history=res.history, wall_s=wall, rounds_per_s=fed.rounds / wall,
            ms_per_sgd_step=wall * 1e3 / steps, launches=launches,
            expected_launches=want, local_step_c_launches=c_launches[algo],
            ledger=ledger.summary(), ledger_closed_form=closed,
            final_acc=res.history[-1]["acc"],
            profiled_round=dict(
                clients=one.n_selected(100), sgd_steps=one_steps,
                wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / wall_us if n_ops else None,
                device_ops=n_ops, device_ops_per_step=n_ops / one_steps,
                top_device_ops=top))
        if launches != want:
            raise SystemExit(f"chip_smoke: p2_algorithms {algo} launches "
                             f"{launches} != {want}")
        if c_launches[algo] != (steps if algo == "scaffold" else 0):
            raise SystemExit(f"chip_smoke: p2_algorithms {algo}: K1 with c "
                             f"launched {c_launches[algo]} times")
        if not n_ops:
            raise SystemExit("chip_smoke: the profiler saw no device op")
        if not all(math.isfinite(h["local_loss"]) for h in res.history):
            raise SystemExit(f"chip_smoke: non-finite loss under {algo}")
        if not rows[algo]["final_acc"] > 0.1:
            raise SystemExit(f"chip_smoke: {algo} final accuracy "
                             f"{rows[algo]['final_acc']} is not above chance")
        if ledger.total_bytes != closed:
            raise SystemExit(f"chip_smoke: {algo} ledger bytes differ from "
                             "the closed form")

    flags = deterministic_cudnn(torch)
    first = {}
    for algo in ("fedavg", "scaffold"):
        fed = FLConfig(algorithm=algo, rounds=1, participation=0.1,
                       local_steps=10, batch_size=32, update_impl="fused",
                       sampling="host")
        first[algo] = [t.detach().clone() for t in tree_leaves(
            run_federated(task, data, fed, init_params=init).params)]
    restore_cudnn(torch, flags)
    bitwise = all(bool(torch.equal(a, b))
                  for a, b in zip(first["scaffold"], first["fedavg"]))
    emit(dict(phase="p2_algorithms", model="lenet5", rounds=2, clients=10,
              local_steps=10, batch=32, mu=0.01, temperature=0.5,
              server_opt="none", algorithms=rows,
              scaffold_round1_equals_fedavg_bitwise=bitwise))
    if not bitwise:
        raise SystemExit("chip_smoke: scaffold's first round differs from "
                         "fedavg's")
    return c_launches


def profile_rounds(torch, task, data, cyc, fed, init) -> None:
    """Where the time goes: one warm P1 round (cut to 5 clients of its
    25: the trace's size sets the profiler's own cost) and one warm P2
    round under torch.profiler, CUDA activity only (no host-op tracing,
    so the host pays little for it).  Reports the device's busy share of
    the round's wall time and the kernels by device time."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.cyclic import cyclic_pretrain
    from repro_torch.fl.simulation import run_federated

    p1 = dataclasses.replace(cyc, rounds=1, participation=0.05)
    runs = {"P1": (cyclic_pretrain, p1, p1.n_selected(100) * p1.local_steps),
            "P2": (run_federated, dataclasses.replace(fed, rounds=1),
                   fed.n_selected(100) * fed.local_steps)}
    for name, (run, cfg, steps) in runs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(task, data, cfg, init_params=init)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, n_ops, top = device_activity(prof)
        emit(dict(phase="profile", round=name, sgd_steps=steps,
                  wall_ms=wall_us / 1e3, ms_per_step=wall_us / 1e3 / steps,
                  device_busy_ms=busy / 1e3,
                  device_busy_share=busy / wall_us if n_ops else None,
                  device_ops=n_ops,
                  device_ops_per_step=n_ops / steps,
                  top_device_ops=top))


def device_activity(prof, n_top: int = 12):
    """From a CUDA-activity trace: the device's busy microseconds (the
    union of its kernel and copy spans), the number of device ops, and
    the top ops by device time."""
    from torch.autograd import DeviceType
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    return busy, len(spans), [dict(name=k[:90], total_ms=v[0] / 1e3,
                                   count=v[1]) for k, v in top]


def gaps_before(prof, name) -> tuple:
    """For each device kernel whose name holds ``name``, in a
    CUDA-activity trace: the idle microseconds before it (its start less
    the latest end of the device ops before it; below 0 when it starts
    before that op has drained) and its own microseconds."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    gaps, own, end = [], [], -math.inf
    for a, b, kname in spans:
        if name in kname:
            gaps.append(a - end)
            own.append(b - a)
        end = max(end, b)
    return gaps, own


def kernel_time(prof, names) -> tuple:
    """Device microseconds and launches of the kernels whose name holds
    one of ``names``, in a CUDA-activity trace."""
    from torch.autograd import DeviceType
    us, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                any(k in e.name for k in names):
            us += e.time_range.end - e.time_range.start
            n += 1
    return us, n


def fused_vs_plain(torch):
    """Phase 4: the kernels against the plain path, end to end."""
    from repro_torch.core.cyclic import cyclic_pretrain, CyclicConfig
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.utils.tree_math import tree_leaves

    flags = deterministic_cudnn(torch)
    task, data = lenet_setup()
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
        finals[("fedavgm", impl)] = [t.detach().clone()
                                     for t in tree_leaves(p2.params)]
        # SCAFFOLD (K1 with its correction c) and MOON: 1 P2 round from
        # the same init, the control variates compared with the params
        for algo in ("scaffold", "moon"):
            res = run_federated(task, data, FLConfig(
                algorithm=algo, rounds=1, participation=0.1, local_steps=25,
                update_impl=impl, sampling="host", batch_indices=indices),
                init_params=init)
            st = res.state
            finals[(algo, impl)] = [t.detach().clone() for t in tree_leaves(
                (res.params, st.c_global, st.c_clients) if algo == "scaffold"
                else res.params)]
    restore_cudnn(torch, flags)
    cases = {}
    for case in ("fedavgm", "scaffold", "moon"):
        pairs = list(zip(finals[(case, "fused")],
                         finals[(case, "fused_interpret")]))
        cases[case] = dict(
            max_abs_diff=max(float((a - b).abs().max()) for a, b in pairs),
            allclose=all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                         for a, b in pairs))
    close = all(c["allclose"] for c in cases.values())
    emit(dict(phase="e2e", rounds={"P1": 1, "P2": 1}, rtol=1e-5, atol=1e-6,
              max_abs_diff=cases["fedavgm"]["max_abs_diff"],
              allclose=cases["fedavgm"]["allclose"],
              algorithms={k: cases[k] for k in ("scaffold", "moon")},
              algorithm_rounds={"P2": 1}))
    if not close:
        raise SystemExit(f"chip_smoke: fused and plain paths disagree: "
                         f"{cases}")


@functools.lru_cache(maxsize=1)
def lenet_setup():
    """The main path's task and data (LeNet-5 on cifar10-like, 100
    clients, β = 0.5, 20,000 samples), made once for the upload phases."""
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.task import vision_task
    data = DATASETS.get("cifar10-like")(n_clients=100, beta=0.5, seed=SEED,
                                        n_train=20000)
    return vision_task("lenet5", n_classes=10, in_ch=3), data


def upload_configs():
    """The P2 upload configurations: the repo's compressed setting
    (benchmarks/table4_comm.py:47), its private one
    (benchmarks/perf_fused_update.py:138), and its int8 dense mode
    (benchmarks/perf_compression.py:58: quantized, not sparsified)."""
    from repro_torch.fl.compression import CompressionSpec
    from repro_torch.fl.privacy import DPSpec
    return {"p2_compressed": dict(compression=CompressionSpec(
                bits=8, density=0.25, error_feedback=True)),
            "p2_private": dict(dp=DPSpec(clip=1.0, sigma=0.1),
                               secure_agg=True),
            "p2_int8": dict(compression=CompressionSpec(bits=8))}


def upload_launches(comp, uploads: int) -> dict:
    """The upload kernels' launches of ``uploads`` client uploads of the
    main path's bucket (below ``topk_cut()``) under CompressionSpec
    ``comp`` (None: uncompressed): a top-k upload is one fused launch,
    a quantized-only upload a standalone K4."""
    from repro_torch.fl.compression import compression_on
    out = {"compress_delta": 0, "topk_threshold": 0, "topk_compress": 0}
    if not compression_on(comp):
        return out
    if not comp.sparsifies:
        return dict(out, compress_delta=uploads)
    return dict(out, topk_compress=uploads)


def upload_phase(torch, fu, phase: str, fed_kw: dict):
    """Phases p2_compressed / p2_private / p2_int8: the main path's
    pipeline (P1 cut to 1 round, P2 FedAvgM 2 rounds × 10 clients) with
    the P2 upload of ``fed_kw``, through ``run_cyclic_then_federated``;
    launches, ledger and accuracy asserted, then a profiled P2 round and
    the kernels against the plain path.  Returns the launches and the P2
    result."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import comm_accounting as acc
    from repro_torch.core.cyclic import CyclicConfig
    from repro_torch.core.pipeline import run_cyclic_then_federated
    from repro_torch.fl.compression import compression_on
    from repro_torch.fl.engine import _upload_payload_bytes
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.utils.tree_math import size_bytes

    task, data = lenet_setup()
    cyc = CyclicConfig(rounds=1, participation=0.25, local_steps=20,
                       batch_size=32, update_impl="fused", sampling="host")
    fed = FLConfig(algorithm="fedavg", rounds=2, participation=0.1,
                   local_steps=25, server_opt="momentum", update_impl="fused",
                   sampling="host", **fed_kw)
    fu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_cyclic_then_federated(task, data, cyc, fed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches
                for fn in fu.KERNELS + fu.UPLOAD_KERNELS}

    k1, k2 = cyc.n_selected(100), fed.n_selected(100)
    compressed = compression_on(fed.compression)
    want = {"local_step": cyc.rounds * k1 * cyc.local_steps +
            fed.rounds * k2 * fed.local_steps,
            "weighted_delta": fed.rounds, "server_update": fed.rounds,
            "dp_clip_noise": 0,
            **upload_launches(fed.compression, fed.rounds * k2)}
    x = size_bytes(res.federated.params)
    payload = _upload_payload_bytes(task, fed.compression)
    p2 = (fed.rounds * acc.compressed_round_bytes("fedavg", k2, x, payload)
          if compressed else 2 * k2 * fed.rounds * x)
    mask = fed.rounds * acc.secure_agg_mask_bytes(k2) if fed.secure_agg else 0
    closed = 2 * k1 * cyc.rounds * x + p2 + mask
    ledger = res.ledger.summary()
    final_acc = res.history[-1]["acc"]

    # one profiled P2 round (warm rounds/s: the p2_rounds phase)
    one = dataclasses.replace(fed, rounds=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_federated(task, data, one, init_params=res.cyclic.params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_ops, top = device_activity(prof)
    e2e = upload_e2e(torch, task, data, fed_kw)
    emit(dict(phase=phase, model=task.name, dataset="cifar10-like",
              upload={k: str(v) for k, v in fed_kw.items()},
              history=res.history, wall_s=wall,
              profiled_p2_round=dict(
                  wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                  device_busy_share=busy / wall_us if n_ops else None,
                  device_ops=n_ops, top_device_ops=top),
              ledger=ledger, ledger_closed_form=closed,
              upload_payload_bytes=payload, full_upload_bytes=x,
              payload_ratio=x / payload,
              launches=launches, expected_launches=want,
              final_acc=final_acc, e2e=e2e))
    if launches != want:
        raise SystemExit(f"chip_smoke: {phase} launches {launches} != {want}")
    if not all(math.isfinite(h["local_loss"]) for h in res.history):
        raise SystemExit(f"chip_smoke: non-finite loss in {phase}")
    if not final_acc > 0.1:
        raise SystemExit(f"chip_smoke: {phase} final accuracy {final_acc} "
                         "is not above chance")
    if res.ledger.total_bytes != closed or res.ledger.mask_bytes != mask:
        raise SystemExit(f"chip_smoke: {phase} ledger bytes differ from "
                         "the closed form")
    if phase == "p2_compressed" and payload != 173_250:
        raise SystemExit(f"chip_smoke: compressed upload {payload} bytes, "
                         "expected 173,250")
    if not n_ops:
        raise SystemExit("chip_smoke: the profiler saw no device op")
    if not e2e["allclose"]:
        raise SystemExit(f"chip_smoke: {phase}: the kernels and the plain "
                         "path disagree")
    return launches, res


def upload_e2e(torch, task, data, fed_kw):
    """2 P2 rounds with update_impl "fused" and "fused_interpret" from
    the same init and index stream (cuDNN deterministic): the final
    params and, under error feedback, every client's residual row, at
    the e2e phase's tolerance."""
    from repro_torch.fl.engine import run_rounds
    from repro_torch.fl.simulation import FLConfig
    from repro_torch.utils.tree_math import tree_leaves

    flags = deterministic_cudnn(torch)
    init = task.init(torch.Generator().manual_seed(SEED))

    def indices(rnd, slot, step):
        g = torch.Generator().manual_seed(1_000_003 * rnd + 1009 * slot + step)
        return torch.randint(0, data.n_per_client, (32,), generator=g)

    finals = {}
    for impl in ("fused", "fused_interpret"):
        fed = FLConfig(rounds=2, participation=0.1, local_steps=25,
                       server_opt="momentum", update_impl=impl,
                       sampling="host", batch_indices=indices, **fed_kw)
        r = run_rounds(task, data, fed.strategy(), fed.schedule(),
                       init_params=init)
        finals[impl] = [t.detach().clone() for t in tree_leaves(r.params)]
        finals[impl] += list(r.algo_state.get("ef_residuals", {}).values())
    restore_cudnn(torch, flags)
    pairs = list(zip(finals["fused"], finals["fused_interpret"]))
    return dict(rounds={"P2": 2}, rtol=1e-5, atol=1e-6,
                compared=len(pairs),
                max_abs_diff=max(float((a - b).abs().max()) for a, b in pairs),
                bitwise=all(bool(torch.equal(a, b)) for a, b in pairs),
                allclose=all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                             for a, b in pairs))


def private_round(torch, params, fed_kw) -> dict:
    """One private P2 round of the engine (``run_rounds`` from
    ``params``: LeNet-5, 10 clients × 25 SGD steps, host sampling, the
    privacy of ``fed_kw``), seen through ``RoundSchedule.on_aggregate``:
    its inputs, start buffers, stacked client end states and folded
    aggregate, with the flat ops and keyed draws that rebuild its
    uploads."""
    import dataclasses
    from repro_torch.fl import privacy
    from repro_torch.fl.engine import run_rounds
    from repro_torch.fl.local import host_flat_ops
    from repro_torch.fl.simulation import FLConfig

    task, data = lenet_setup()
    fed = FLConfig(rounds=1, participation=0.1, local_steps=25,
                   update_impl="fused", sampling="host", eval_every=0,
                   seed=SEED, **fed_kw)
    seen = {}

    def capture(rnd, inputs, p, stacked, new_p):
        seen.update(inputs=inputs, p=p, stacked=stacked, folded=new_p)

    run_rounds(task, data, fed.strategy(),
               dataclasses.replace(fed.schedule(), on_aggregate=capture),
               init_params=params)
    inputs = seen["inputs"]
    fops = host_flat_ops(task, False, torch.device("cuda"))
    return dict(seen, ids=inputs.id_list(), weights=inputs.weights,
                fops=fops, dp=fed.dp, secure_agg=fed.secure_agg,
                normal_fn=privacy.keyed_normal_fn(inputs.round_key,
                                                  fops.normal))


def dp_upload(torch, fu, params, fed_kw):
    """Phase dp_upload: the 10 client uploads of one private P2 round
    (``private_round``: the engine's inputs, start buffers, stacked
    client end states and folded aggregate, ``fused_dp_aggregate``).
    From those, the uploads of every client are built by ONE rows-form
    K5 launch per bucket from the round's keyed draws and summed by K2
    with the mask total as ``extra``
    (``privacy.materialized_dp_aggregate``), then held against the
    engine's folded aggregate.  Tolerance: |materialized − folded| ≤
    1e-5·(|p| + Σₖ|w̄ₖ·uₖ| + Σᵢ|mᵢ|) + 1e-7 elementwise: the two forms
    associate the same terms differently (f32 reassociation)."""
    from repro_torch.fl import privacy

    rnd = private_round(torch, params, fed_kw)
    dp, secure_agg, ids, weights, p, stacked, folded, fops, normal_fn = (
        rnd[k] for k in ("dp", "secure_agg", "ids", "weights", "p",
                         "stacked", "folded", "fops", "normal_fn"))
    K = len(ids)

    fu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mat = privacy.materialized_dp_aggregate(dp, secure_agg, fops, ids, p,
                                            stacked, weights, normal_fn)
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches
                for fn in fu.KERNELS + fu.UPLOAD_KERNELS}
    # one K2 and one rows-form K5 per bucket, whatever K is
    want = {"local_step": 0, "weighted_delta": len(p), "server_update": 0,
            "compress_delta": 0, "topk_threshold": 0,
            "dp_clip_noise": len(p), "topk_compress": 0}

    # the form the rows form replaced, on the same draws: per client a
    # subtraction and one K5 launch, the uploads stacked, then K2; the
    # aggregates bit for bit
    wbar = (weights / torch.sum(weights)).to(torch.float32)
    names = list(p)
    scales = privacy.stacked_clip_scales(dp, [p[n] for n in names],
                                         [stacked[n] for n in names])
    ns = torch.full_like(wbar[0], dp.sigma * dp.clip)
    rows = [{n: fu.dp_clip_noise(stacked[n][k].float() - p[n].float(),
                                 normal_fn("dp", cid)[n],
                                 torch.stack([scales[k], ns]))
             for n in names} for k, cid in enumerate(ids)]
    masks = privacy.round_extra(None, secure_agg, ids, wbar,
                                zeros_fn=lambda: fops.zeros(torch.float32),
                                normal_fn=normal_fn)
    per_client = fops.weighted_delta(
        p, {n: torch.stack([u[n] for u in rows]) for n in names}, wbar,
        extra=masks, deltas=True)
    per_client_bitwise = all(bool(torch.equal(mat[n], per_client[n]))
                             for n in names)

    # the summands' magnitude, from the same draws
    norms = torch.sqrt(sum(((stacked[n].float() - p[n].float()[None]) ** 2)
                           .sum(dim=1) for n in names))
    ok, max_diff, worst = True, 0.0, 0.0
    for n in names:
        mag = p[n].float().abs()
        for k, cid in enumerate(ids):
            mag = mag + (wbar[k] * (scales[k] * (stacked[n][k].float() -
                                                  p[n].float()))).abs()
            mag = mag + (wbar[k] * dp.sigma * dp.clip *
                         normal_fn("dp", cid)[n]).abs()
            for other in ids:
                if other != cid:
                    mag = mag + normal_fn("mask", min(cid, other),
                                          max(cid, other))[n].abs()
        diff = (mat[n].float() - folded[n].float()).abs()
        ok = ok and bool(torch.isfinite(mat[n]).all()) and \
            not bool((diff > 1e-5 * mag + 1e-7).any())
        max_diff = max(max_diff, float(diff.max()))
        worst = max(worst, float((diff / (mag + 1e-30)).max()))
    emit(dict(phase="dp_upload", clients=K, ids=ids,
              delta_norms=[float(v) for v in norms],
              clip_scales=[float(v) for v in scales], dp=str(dp),
              secure_agg=secure_agg,
              tolerance="|materialized - folded| <= 1e-5*magnitude + 1e-7",
              max_abs_diff=max_diff, max_diff_over_magnitude=worst,
              materialized_wall_s=mat_s, launches=launches,
              expected_launches=want, per_client_bitwise=per_client_bitwise,
              ok=ok))
    if launches != want:
        raise SystemExit(f"chip_smoke: dp_upload launches {launches} != "
                         f"{want}")
    if not per_client_bitwise:
        raise SystemExit("chip_smoke: the rows-form DP uploads differ from "
                         "the per-client form")
    if not ok:
        raise SystemExit("chip_smoke: the materialized DP uploads disagree "
                         "with the folded aggregate")
    return launches


def p2_rounds(torch, init) -> dict:
    """Phase p2_rounds: warm P2 rounds/s of the uncompressed, compressed
    and private configurations from the same P1 params, 1 round a turn,
    in turns (each
    configuration twice, in the order a b c d d c b a), so a slow
    stretch of the host falls on all of them; the private configuration
    also under sampling="device", whose ids are drawn and read back
    when each chunk is planned."""
    from repro_torch.fl.simulation import FLConfig, run_federated
    task, data = lenet_setup()
    configs = upload_configs()
    runs = {"p2": {}, "p2_compressed": configs["p2_compressed"],
            "p2_private": configs["p2_private"],
            "p2_private_device_sampling": dict(configs["p2_private"],
                                               sampling="device")}
    times = {name: [] for name in runs}
    rounds = 1
    for name in list(runs) + list(reversed(runs)):
        kw = dict(dict(sampling="host"), **runs[name])
        fed = FLConfig(algorithm="fedavg", rounds=rounds, participation=0.1,
                       local_steps=25, server_opt="momentum",
                       update_impl="fused", **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_federated(task, data, fed, init_params=init)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    rps = {name: [rounds / t for t in ts] for name, ts in times.items()}
    emit(dict(phase="p2_rounds", rounds=rounds, order="a b c d d c b a",
              wall_s=times, rounds_per_s=rps,
              mean_rounds_per_s={k: statistics.mean(v) for k, v in rps.items()}))
    return rps


# --- the paper's other models: CharLSTM-256 and CNN-Fashion -----------------

N_CHARLM = 814_080         # CharLSTM-256's 813,632 params padded to 1024
# tinyllama-1.1b + lora:8 (llm_lora): 1,100,048,384 base and 6,307,840
# adapter params, all bf16: P1's one bucket holds both, P2's the adapters
LLM_ARCH, LLM_PEFT, LLM_K = "tinyllama-1.1b", "lora:8", 4
LLM_STEPS = 1       # SGD steps a client (4 before the MoE and zoo phases,
#                     2 before pod_sharded_zoo)
LLM_BASE, N_LORA = 1_100_048_384, 6_307_840
N_TINYLLAMA = LLM_BASE + N_LORA       # a multiple of 1024: no pad lanes
L2_FLUSH_BYTES = 256 << 20  # read before a cold-L2 call: 5x the H100's L2
CHARLM_LR = 0.8            # see charlm_configs


@functools.lru_cache(maxsize=1)
def charlm_setup():
    """CharLSTM-256 (``charlm_task(vocab=64, d_embed=8, d_hidden=256)``:
    813,632 f32 params in one bucket, padded to 814,080, above
    ``topk_cut()``) on ``shakespeare-like`` at its registered defaults
    (66 clients × 64 sequences of 80 characters, vocab 64, 512 test
    sequences)."""
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.task import charlm_task
    return (charlm_task(vocab=64, d_embed=8, d_hidden=256),
            DATASETS.get("shakespeare-like")(seed=SEED))


def charlm_configs(impl: str = "fused", **fed_kw):
    """P1 1 round × 7 clients (participation 0.1 of 66) × 5 steps, P2
    FedAvgM 1 × 7 × 5, batch 32, host sampling (cut from 2 + 2 rounds
    of 10 steps to hold the script's time).  The SGD step is
    ``CHARLM_LR`` = 0.8, the Shakespeare LSTM's in LEAF and FedProx: at
    the configs' default 0.01 the loss moves by ~5e-3 in 280 steps (a
    CPU run of this phase)."""
    from repro_torch.core.cyclic import CyclicConfig
    from repro_torch.fl.simulation import FLConfig
    common = dict(participation=0.1, local_steps=5, batch_size=32,
                  lr=CHARLM_LR, update_impl=impl, sampling="host")
    return (CyclicConfig(rounds=1, **common),
            FLConfig(algorithm="fedavg", rounds=1, server_opt="momentum",
                     **common, **fed_kw))


def profiled_round(torch, run, task, data, cfg, init, steps) -> dict:
    """One warm round of ``run`` (``cyclic_pretrain`` or ``run_federated``
    with ``cfg``, evaluation off) under torch.profiler, CUDA activity
    only: wall and device-busy ms, device ops per SGD step, busy share
    and the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(task, data, cfg, init_params=init)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_ops, top = device_activity(prof, n_top=8)
    if not n_ops:
        raise SystemExit("chip_smoke: the profiler saw no device op")
    return dict(sgd_steps=steps, wall_ms=wall_us / 1e3,
                ms_per_step=wall_us / 1e3 / steps,
                device_busy_ms=busy / 1e3, device_busy_share=busy / wall_us,
                device_ops=n_ops, device_ops_per_step=n_ops / steps,
                top_device_ops=top)


def heldout_loss(torch, task, data, params) -> float:
    """The task's loss over the whole test set, on the card."""
    from repro_torch.utils.tree_math import tree_map
    with torch.no_grad():
        return float(task.loss_fn(
            tree_map(lambda t: t.to("cuda"), params),
            torch.as_tensor(data.test_x).to("cuda"),
            torch.as_tensor(data.test_y).to("cuda", torch.int64)))


def same_leaves(torch, a, b) -> bool:
    from repro_torch.utils.tree_math import tree_leaves
    return all(bool(torch.equal(x, y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def charlm_path(torch, fu):
    """Phase charlm_path: the paper's CharLSTM-256 at full width through
    ``run_cyclic_then_federated`` (``charlm_configs``).  Asserted: K1
    70, K2 1, K3 1 and no upload kernel; ledger == closed form; the
    P2 model's loss over the 512 test sequences below the init's (the
    P1 model's reported beside them); accuracy above chance (1/64); the
    pipeline cut to 1 P1 + 1 P2 round of 2 clients (the SGD step is
    host-bound at ~0.13 s) with update_impl "fused" and
    "fused_interpret" (every kernel's plain version) from the same init
    and draws, params bitwise.  Reported: ms per SGD step of the run,
    and one profiled warm P2 round cut to one client (10 steps;
    evaluation off): device ops per step and busy share.  Returns the
    launches and the P1 params."""
    import dataclasses
    from repro_torch.core import comm_accounting
    from repro_torch.core.pipeline import run_cyclic_then_federated
    from repro_torch.fl.simulation import run_federated
    from repro_torch.utils.device import seeded_generator
    from repro_torch.utils.tree_math import size_bytes

    task, data = charlm_setup()
    cyc, fed = charlm_configs()
    fu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_cyclic_then_federated(task, data, cyc, fed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches(fu)
    k1, k2 = cyc.n_selected(data.n_clients), fed.n_selected(data.n_clients)
    steps = cyc.rounds * k1 * cyc.local_steps + \
        fed.rounds * k2 * fed.local_steps
    want = {"local_step": steps, "weighted_delta": fed.rounds,
            "server_update": fed.rounds, "compress_delta": 0,
            "topk_threshold": 0, "dp_clip_noise": 0, "topk_compress": 0,
            "delta_accum": 0}
    hist = res.history
    closed = comm_accounting.overhead_with_cyclic(
        "fedavg", k1, cyc.rounds, k2, fed.rounds,
        size_bytes(res.federated.params))
    final_acc = hist[-1]["acc"]
    # the pipeline's own init (task.init from the P1 seed)
    losses = {name: heldout_loss(torch, task, data, params) for name, params
              in (("init", task.init(seeded_generator(cyc.seed))),
                  ("p1", res.cyclic.params), ("p2", res.federated.params))}

    finals = {}
    for impl in ("fused", "fused_interpret"):
        c1, f1 = (dataclasses.replace(c, rounds=1, participation=0.03)
                  for c in charlm_configs(impl))
        finals[impl] = run_cyclic_then_federated(task, data, c1,
                                                 f1).federated.params
    bitwise = same_leaves(torch, finals["fused"], finals["fused_interpret"])

    p1 = res.cyclic.params
    prof = profiled_round(torch, run_federated, task, data,
                          dataclasses.replace(fed, rounds=1, eval_every=0,
                                              participation=0.01),
                          p1, fed.local_steps)
    emit(dict(phase="charlm_path", model="charlstm-256",
              params=size_bytes(res.federated.params) // 4, bucket=N_CHARLM, dataset="shakespeare-like", n_clients=66,
              seq_len=80, lr=CHARLM_LR, history=hist, wall_s=wall,
              sgd_steps=steps, ms_per_sgd_step=wall * 1e3 / steps,
              profiled_p2_round=prof, heldout_loss=losses,
              ledger=res.ledger.summary(), ledger_closed_form=closed,
              launches=launches, expected_launches=want,
              final_acc=final_acc, chance=1 / 64,
              fused_equals_plain_bitwise=bitwise))
    if launches != want:
        raise SystemExit(f"chip_smoke: charlm_path launches {launches} != "
                         f"{want}")
    if not all(math.isfinite(h["local_loss"]) for h in hist):
        raise SystemExit("chip_smoke: non-finite loss on charlm_path")
    if not losses["p2"] < losses["init"]:
        raise SystemExit(f"chip_smoke: charlm_path's held-out loss did not "
                         f"fall: {losses}")
    if not final_acc > 1 / 64:
        raise SystemExit(f"chip_smoke: charlm_path final accuracy "
                         f"{final_acc} is not above chance")
    if res.ledger.total_bytes != closed:
        raise SystemExit("chip_smoke: charlm_path ledger bytes differ from "
                         "the closed form")
    if not bitwise:
        raise SystemExit("chip_smoke: charlm_path's kernels and plain path "
                         "disagree")
    return launches, p1


def charlm_compressed(torch, fu, init):
    """Phase charlm_compressed: charlm_path's P2 from its P1 params with
    the repo's compressed upload (``CompressionSpec(bits=8, density=0.25,
    error_feedback=True)``, ``benchmarks/table4_comm.py:47``).  The
    bucket is above ``topk_cut()``, so each of the 7 uploads is the
    threshold's four radix launches and K4 alone with top-k and the
    residual.  Asserted: ``topk_threshold`` 28, ``compress_delta`` 7,
    ``topk_compress`` 0, K1 70, K2 1, K3 1; ledger == closed form;
    then 1 round of 2 clients with update_impl "fused" and
    "fused_interpret" from the same init and draws: params and every
    client's EF residual row bitwise."""
    import dataclasses
    from repro_torch.core import comm_accounting as acc
    from repro_torch.fl.compression import CompressionSpec
    from repro_torch.fl.engine import _upload_payload_bytes, run_rounds
    from repro_torch.utils.tree_math import size_bytes, tree_leaves

    task, data = charlm_setup()
    comp = CompressionSpec(bits=8, density=0.25, error_feedback=True)
    _, fed = charlm_configs(compression=comp)
    ledger = acc.CommLedger()
    fu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_rounds(task, data, fed.strategy(), fed.schedule(),
                     init_params=init, ledger=ledger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches(fu)
    k2 = fed.n_selected(data.n_clients)
    uploads = fed.rounds * k2
    want = {"local_step": uploads * fed.local_steps,
            "weighted_delta": fed.rounds, "server_update": fed.rounds,
            "compress_delta": uploads,
            "topk_threshold": fu.topk_launches(N_CHARLM) * uploads,
            "dp_clip_noise": 0, "topk_compress": 0, "delta_accum": 0}
    x = size_bytes(res.params)
    payload = _upload_payload_bytes(task, comp)
    closed = fed.rounds * acc.compressed_round_bytes("fedavg", k2, x, payload)
    finals = {}
    for impl in ("fused", "fused_interpret"):
        f1 = dataclasses.replace(charlm_configs(impl, compression=comp)[1],
                                 rounds=1, participation=0.03)
        r = run_rounds(task, data, f1.strategy(), f1.schedule(),
                       init_params=init)
        finals[impl] = tree_leaves(r.params) + list(
            r.algo_state["ef_residuals"].values())
    pairs = list(zip(finals["fused"], finals["fused_interpret"]))
    bitwise = all(bool(torch.equal(a, b)) for a, b in pairs)
    emit(dict(phase="charlm_compressed", model="charlstm-256",
              bucket=N_CHARLM, topk_cut=fu.topk_cut(), upload=str(comp),
              history=res.history, wall_s=wall, uploads=uploads,
              ledger=ledger.summary(), ledger_closed_form=closed,
              upload_payload_bytes=payload, full_upload_bytes=x,
              payload_ratio=x / payload, launches=launches,
              expected_launches=want, final_acc=res.history[-1]["acc"],
              fused_equals_plain_bitwise=bitwise, compared=len(pairs)))
    if launches != want:
        raise SystemExit(f"chip_smoke: charlm_compressed launches "
                         f"{launches} != {want}")
    if not all(math.isfinite(h["local_loss"]) for h in res.history):
        raise SystemExit("chip_smoke: non-finite loss on charlm_compressed")
    if ledger.total_bytes != closed:
        raise SystemExit("chip_smoke: charlm_compressed ledger bytes differ "
                         "from the closed form")
    if not bitwise:
        raise SystemExit("chip_smoke: charlm_compressed's kernels and plain "
                         "path disagree")
    return launches


def fashion_path(torch, fu):
    """Phase fashion_path: CNN-Fashion (215,370 params, padded to
    216,064; dropout 0.5 on its 1,568 flattened features) on
    ``fashion-like`` (100 clients, β = 0.5, 20,000 samples, 28×28×1):
    P1 2 rounds × 25 clients × 10 steps, P2 FedAvg 2 × 10 × 10, batch
    32, fused, each step's keep-mask drawn on the card from a generator
    seeded per (round, client slot, step).  Asserted: K1 700, K2 2, K3
    0; accuracy above chance (0.1); 1 P1 + 1 P2 round fused against
    "fused_interpret" from the same init under the same generators
    (cuDNN deterministic): every step's dropout source a CUDA generator,
    params bitwise.  Reported: ms per SGD step, and one profiled warm P2
    round cut to 2 clients: device ops per step and busy share."""
    import dataclasses
    from repro_torch.core.cyclic import CyclicConfig
    from repro_torch.core.pipeline import run_cyclic_then_federated
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.fl.task import vision_task
    from repro_torch.utils.tree_math import size_bytes

    data = DATASETS.get("fashion-like")(n_clients=100, beta=0.5, seed=SEED,
                                        n_train=20000)
    task = vision_task("cnn_fashion", n_classes=10, in_ch=1)
    common = dict(local_steps=10, batch_size=32, update_impl="fused",
                  sampling="host")
    cyc = CyclicConfig(rounds=2, participation=0.25, **common)
    fed = FLConfig(algorithm="fedavg", rounds=2, participation=0.1, **common)
    fu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_cyclic_then_federated(task, data, cyc, fed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches(fu)
    k1, k2 = cyc.n_selected(100), fed.n_selected(100)
    steps = cyc.rounds * k1 * cyc.local_steps + \
        fed.rounds * k2 * fed.local_steps
    want = {"local_step": steps, "weighted_delta": fed.rounds,
            "server_update": 0, "compress_delta": 0, "topk_threshold": 0,
            "dp_clip_noise": 0, "topk_compress": 0, "delta_accum": 0}
    final_acc = res.history[-1]["acc"]

    # fused against plain: the loss records each step's dropout source
    flags = deterministic_cudnn(torch)
    finals, sources = {}, []

    def loss_fn(params, bx, by, rng=None):
        sources.append(isinstance(rng, torch.Generator) and
                       rng.device.type == "cuda")
        return task.loss_fn(params, bx, by, rng)
    recording = dataclasses.replace(task, loss_fn=loss_fn)
    for impl in ("fused", "fused_interpret"):
        c1 = dataclasses.replace(cyc, rounds=1, update_impl=impl)
        f1 = dataclasses.replace(fed, rounds=1, update_impl=impl)
        finals[impl] = run_cyclic_then_federated(recording, data, c1,
                                                 f1).federated.params
    restore_cudnn(torch, flags)
    bitwise = same_leaves(torch, finals["fused"], finals["fused_interpret"])
    n_compared = 2 * (k1 + k2) * cyc.local_steps
    prof = profiled_round(torch, run_federated, task, data,
                          dataclasses.replace(fed, rounds=1, eval_every=0,
                                              participation=0.02),
                          res.cyclic.params, 2 * fed.local_steps)
    emit(dict(phase="fashion_path", model="cnn_fashion",
              params=size_bytes(res.federated.params) // 4,
              dataset="fashion-like", n_clients=100, beta=0.5,
              n_train=20000, dropout=0.5, history=res.history, wall_s=wall,
              sgd_steps=steps, ms_per_sgd_step=wall * 1e3 / steps,
              profiled_p2_round=prof, launches=launches,
              expected_launches=want, final_acc=final_acc,
              steps_on_a_cuda_generator=sum(sources),
              fused_equals_plain_bitwise=bitwise))
    if launches != want:
        raise SystemExit(f"chip_smoke: fashion_path launches {launches} != "
                         f"{want}")
    if not all(math.isfinite(h["local_loss"]) for h in res.history):
        raise SystemExit("chip_smoke: non-finite loss on fashion_path")
    if not final_acc > 0.1:
        raise SystemExit(f"chip_smoke: fashion_path final accuracy "
                         f"{final_acc} is not above chance")
    if len(sources) != n_compared or not all(sources):
        raise SystemExit("chip_smoke: fashion_path's steps did not all draw "
                         "dropout from a CUDA generator")
    if not bitwise:
        raise SystemExit("chip_smoke: fashion_path's kernels and plain path "
                         "disagree")
    return launches


# --- the pod backend on a one-rank NCCL mesh ---------------------------------

# pod_path's rounds a phase (4 before the MoE and zoo training phases
# joined the script)
POD_PATH_ROUNDS = 2


def pod_configs(mesh, *, rounds: int = 4, impl: str = "fused",
                batch_indices=None, cfg_kw=None, spec_kw=None):
    """The main path's two phases as pod configs on ``mesh``: P1 4 rounds
    × 25 clients × 20 steps, P2 FedAvgM 4 rounds × 10 clients × 25 steps,
    batch 32, lr 0.01 decaying 0.998 per round, evaluated on the last
    round (as CyclicConfig / FLConfig do at 4 rounds)."""
    from repro_torch.fl.pod import PodCyclicConfig, PodFLConfig, PodFLSpec
    common = dict(rounds=rounds, lr_decay=0.998, eval_every=rounds,
                  eval_batch=256, sampling="host", chunk_size=8,
                  batch_indices=batch_indices)
    cyc = PodCyclicConfig(mesh, clients_per_round=25, spec=PodFLSpec(
        local_steps=20, batch_size=32, lr=0.01, update_impl=impl), **common)
    fed = PodFLConfig(mesh, clients_per_round=10, spec=PodFLSpec(
        local_steps=25, batch_size=32, lr=0.01, server_opt="momentum",
        update_impl=impl, **(spec_kw or {})), **common, **(cfg_kw or {}))
    return cyc, fed


def all_launches(fu) -> dict:
    return {fn.__name__: fn.launches
            for fn in fu.KERNELS + fu.UPLOAD_KERNELS + fu.POD_KERNELS}


def pod_path(torch, fu, mesh):
    """Phase pod_path: the main path on the pod backend through
    ``run_phase_schedule`` with ``PodCyclicConfig`` then ``PodFLConfig``
    (sequential aggregation: one K6 per client, then K3 "none" and the
    FedAvgM K3 per round); launches, collectives, ledger and accuracy
    asserted."""
    from repro_torch.core import comm_accounting
    from repro_torch.core.pipeline import Phase, run_phase_schedule
    from repro_torch.fl import pod
    from repro_torch.utils.tree_math import size_bytes

    task, data = lenet_setup()
    cyc, fed = pod_configs(mesh, rounds=POD_PATH_ROUNDS)
    fu.reset_launch_counts()
    pod.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_phase_schedule(task, data, [Phase("P1", cyc), Phase("P2", fed)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, collectives = all_launches(fu), dict(pod.COLLECTIVES)
    k1, k2 = cyc.clients_per_round, fed.clients_per_round
    steps = cyc.rounds * k1 * cyc.spec.local_steps + \
        fed.rounds * k2 * fed.spec.local_steps
    want = {"local_step": steps, "weighted_delta": 0,
            "server_update": 2 * fed.rounds, "compress_delta": 0,
            "topk_threshold": 0, "dp_clip_noise": 0, "topk_compress": 0,
            "delta_accum": fed.rounds * k2}
    x_bytes = size_bytes(res.params)
    closed = comm_accounting.overhead_with_cyclic(
        "fedavg", k1, cyc.rounds, k2, fed.rounds, x_bytes)
    final_acc = res.history[-1]["acc"]
    p1 = res.phases[0].result.params

    # one profiled warm P2 round (CUDA activity only), as profile_rounds
    import dataclasses
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    one = dataclasses.replace(fed, rounds=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pod.run_pod_rounds(task, data, one, init_params=p1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_ops, top = device_activity(prof)
    emit(dict(phase="pod_path", mesh=str(mesh), backend=dist.get_backend(),
              model="lenet5", dataset="cifar10-like", n_clients=100,
              history=res.history, wall_s=wall,
              rounds_per_s=len(res.history) / wall,
              ledger=res.ledger.summary(), ledger_closed_form=closed,
              launches=launches, expected_launches=want,
              collectives=collectives, final_acc=final_acc,
              profiled_p2_round=dict(
                  wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                  device_busy_share=busy / wall_us if n_ops else None,
                  device_ops=n_ops, top_device_ops=top)))
    if launches != want:
        raise SystemExit(f"chip_smoke: pod_path launches {launches} != {want}")
    if not n_ops:
        raise SystemExit("chip_smoke: the profiler saw no device op")
    if collectives["grad"] != steps or collectives["lane_combine"]:
        raise SystemExit(f"chip_smoke: pod_path collectives {collectives}")
    if not all(math.isfinite(h["local_loss"]) for h in res.history):
        raise SystemExit("chip_smoke: non-finite loss on the pod path")
    if not final_acc > 0.1:
        raise SystemExit(f"chip_smoke: pod_path final accuracy {final_acc} "
                         "is not above chance")
    if res.ledger.total_bytes != closed:
        raise SystemExit("chip_smoke: pod_path ledger bytes differ from the "
                         "closed form")
    return launches, p1


def pod_hierarchical(torch, fu, mesh, init):
    """Phase pod_hierarchical: one round of the pod P2 from the pod P1's
    params with ``aggregation="hierarchical", n_pods=2`` (two unsharded
    lanes on one rank) against the sequential round from the same start,
    cuDNN deterministic: only the order of addition differs, so the
    params agree within rtol 1e-5 (atol 1e-7); 10 K6 launches asserted.
    One round: each later round's 250 SGD steps amplify that difference
    by a factor that depends on the start (``tools/pod_hierarchical_
    drift.py``), so after four the gate read the start, not the lanes."""
    from repro_torch.fl.pod import run_pod_rounds
    from repro_torch.utils.tree_math import tree_leaves
    task, data = lenet_setup()
    flags = deterministic_cudnn(torch)
    finals, launches = {}, {}
    for agg, kw in (("sequential", {}),
                    ("hierarchical", {"aggregation": "hierarchical",
                                      "n_pods": 2})):
        _, fed = pod_configs(mesh, rounds=1, cfg_kw=kw)
        fu.reset_launch_counts()
        r = run_pod_rounds(task, data, fed, init_params=init)
        launches[agg] = all_launches(fu)
        finals[agg] = [t.detach().clone() for t in tree_leaves(r.params)]
    restore_cudnn(torch, flags)
    pairs = list(zip(finals["hierarchical"], finals["sequential"]))
    close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in pairs)
    emit(dict(phase="pod_hierarchical", n_pods=2, rtol=1e-5, atol=1e-7,
              max_abs_diff=max(float((a - b).abs().max()) for a, b in pairs),
              bitwise=all(bool(torch.equal(a, b)) for a, b in pairs),
              allclose=close, launches=launches))
    if launches["hierarchical"]["delta_accum"] != 10:
        raise SystemExit(f"chip_smoke: pod_hierarchical K6 launches "
                         f"{launches['hierarchical']['delta_accum']} != 10")
    if not close:
        raise SystemExit("chip_smoke: hierarchical and sequential pod "
                         "aggregation disagree")


def pod_compressed(torch, fu, mesh, init):
    """Phase pod_compressed: the pod P2 with CompressionSpec(8, 0.25,
    True) from the pod P1's params: each client's upload through the
    threshold and K4, accumulated by the accum-only K6; launches, ledger
    (= closed form, 173,250 upload bytes per client) and accuracy
    asserted."""
    from repro_torch.core import comm_accounting as acc
    from repro_torch.fl.compression import CompressionSpec
    from repro_torch.fl.engine import _upload_payload_bytes
    from repro_torch.fl.pod import run_pod_rounds
    from repro_torch.utils.tree_math import size_bytes
    task, data = lenet_setup()
    comp = CompressionSpec(bits=8, density=0.25, error_feedback=True)
    _, fed = pod_configs(mesh, spec_kw={"compression": comp})
    ledger = acc.CommLedger()
    fu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pod_rounds(task, data, fed, init_params=init, ledger=ledger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches(fu)
    k2 = fed.clients_per_round
    want = {"local_step": fed.rounds * k2 * fed.spec.local_steps,
            "weighted_delta": 0, "server_update": 2 * fed.rounds,
            "dp_clip_noise": 0, "delta_accum": fed.rounds * k2,
            **upload_launches(comp, fed.rounds * k2)}
    payload = _upload_payload_bytes(task, comp)
    closed = fed.rounds * acc.compressed_round_bytes(
        "fedavg", k2, size_bytes(res.params), payload)
    final_acc = res.history[-1]["acc"]
    emit(dict(phase="pod_compressed", upload=str(comp), history=res.history,
              wall_s=wall, ledger=ledger.summary(), ledger_closed_form=closed,
              upload_payload_bytes=payload, launches=launches,
              expected_launches=want, final_acc=final_acc))
    if launches != want:
        raise SystemExit(f"chip_smoke: pod_compressed launches {launches} "
                         f"!= {want}")
    if payload != 173_250 or ledger.total_bytes != closed:
        raise SystemExit("chip_smoke: pod_compressed ledger bytes differ "
                         "from the closed form")
    if not final_acc > 0.1:
        raise SystemExit(f"chip_smoke: pod_compressed final accuracy "
                         f"{final_acc} is not above chance")
    return launches


def pod_vs_host(torch, mesh):
    """Phase pod_vs_host: 1 P1 + 1 P2 round on the pod and on the host
    engine from the same init and index stream (cuDNN deterministic), at
    the JAX package's host↔pod tolerances (tests/test_pod_engine.py):
    relay atol = rtol = 1e-6, aggregate atol = rtol = 1e-4, losses rtol
    1e-5; then the pod's "fused" against its "fused_interpret",
    bitwise."""
    from repro_torch.core.cyclic import CyclicConfig, cyclic_pretrain
    from repro_torch.fl.pod import run_pod_rounds
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.utils.tree_math import tree_leaves
    task, data = lenet_setup()
    flags = deterministic_cudnn(torch)
    init = task.init(torch.Generator().manual_seed(SEED))

    def indices(rnd, slot, step):
        g = torch.Generator().manual_seed(1_000_003 * rnd + 1009 * slot + step)
        return torch.randint(0, data.n_per_client, (32,), generator=g)

    def leaves(tree):
        return [t.detach().clone() for t in tree_leaves(tree)]
    cyc = CyclicConfig(rounds=1, participation=0.25, local_steps=20,
                       batch_size=32, update_impl="fused", sampling="host",
                       batch_indices=indices)
    fed = FLConfig(rounds=1, participation=0.1, local_steps=25,
                   server_opt="momentum", update_impl="fused",
                   sampling="host", batch_indices=indices)
    h1 = cyclic_pretrain(task, data, cyc, init_params=init)
    h2 = run_federated(task, data, fed, init_params=h1.params)
    host = (leaves(h1.params), leaves(h2.params), h1.history + h2.history)
    pods = {}
    for impl in ("fused", "fused_interpret"):
        pcyc, pfed = pod_configs(mesh, rounds=1, impl=impl,
                                 batch_indices=indices)
        p1 = run_pod_rounds(task, data, pcyc, init_params=init, phase="P1")
        p2 = run_pod_rounds(task, data, pfed, init_params=p1.params)
        pods[impl] = (leaves(p1.params), leaves(p2.params),
                      p1.history + p2.history)
    restore_cudnn(torch, flags)

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))
    pod = pods["fused"]
    relay_ok = all(torch.allclose(a, b, rtol=1e-6, atol=1e-6)
                   for a, b in zip(pod[0], host[0]))
    agg_ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                 for a, b in zip(pod[1], host[1]))
    loss_ok = all(abs(a["local_loss"] - b["local_loss"]) <=
                  1e-5 * abs(b["local_loss"]) for a, b in zip(pod[2], host[2]))
    plain = pods["fused_interpret"]
    bitwise = all(bool(torch.equal(a, b)) for a, b in
                  zip(pod[0] + pod[1], plain[0] + plain[1]))
    charlm = charlm_pod_vs_host(torch, mesh)
    emit(dict(phase="pod_vs_host", rounds={"P1": 1, "P2": 1},
              charlm=charlm,
              relay_tol="atol = rtol = 1e-6", aggregate_tol="atol = rtol = "
              "1e-4", relay_max_abs_diff=gap(pod[0], host[0]),
              relay_bitwise=all(bool(torch.equal(a, b))
                                for a, b in zip(pod[0], host[0])),
              aggregate_max_abs_diff=gap(pod[1], host[1]),
              losses={"pod": [h["local_loss"] for h in pod[2]],
                      "host": [h["local_loss"] for h in host[2]]},
              fused_vs_plain_max_abs_diff=gap(pod[0] + pod[1],
                                              plain[0] + plain[1]),
              fused_vs_plain_bitwise=bitwise))
    if not (relay_ok and agg_ok and loss_ok):
        raise SystemExit("chip_smoke: the pod and the host engine disagree")
    if not bitwise:
        raise SystemExit("chip_smoke: the pod's kernels and plain path "
                         "disagree")
    if not charlm["within_tol"]:
        raise SystemExit(f"chip_smoke: CharLSTM on the pod and the host "
                         f"engine disagree: {charlm}")


def charlm_pod_vs_host(torch, mesh) -> dict:
    """One CharLSTM-256 P2 FedAvgM round (charlm_path's shapes: batch 32,
    10 steps, lr 0.8, cut to 2 clients) on the pod and on the host engine
    from the same init and host-sampled draws, at the JAX package's
    host↔pod tolerances: losses rtol 1e-5, params atol = rtol = 1e-4;
    the eval stream's accuracy reported beside."""
    import dataclasses
    from repro_torch.fl.pod import PodFLConfig, PodFLSpec, run_pod_rounds
    from repro_torch.fl.simulation import run_federated
    from repro_torch.utils.tree_math import tree_leaves
    task, data = charlm_setup()
    init = task.init(torch.Generator().manual_seed(SEED))
    _, fed = charlm_configs()
    fed = dataclasses.replace(fed, rounds=1, participation=0.03,
                              eval_every=1)
    host = run_federated(task, data, fed, init_params=init)
    pcfg = PodFLConfig(mesh, rounds=1, clients_per_round=2,
                       spec=PodFLSpec(local_steps=fed.local_steps,
                                      batch_size=fed.batch_size, lr=fed.lr,
                                      server_opt="momentum",
                                      update_impl="fused"),
                       lr_decay=fed.lr_decay, eval_every=1,
                       eval_batch=fed.eval_batch, seed=fed.seed,
                       sampling="host")
    pod = run_pod_rounds(task, data, pcfg, init_params=init)
    pairs = list(zip(tree_leaves(pod.params), tree_leaves(host.params)))
    losses = ([h["local_loss"] for h in pod.history],
              [h["local_loss"] for h in host.history])
    ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4) for a, b in pairs) \
        and all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(*losses))
    return dict(model="charlstm-256", clients=2, steps=fed.local_steps,
                tol="params atol = rtol = 1e-4, losses rtol 1e-5",
                within_tol=ok,
                max_abs_diff=max(float((a - b).abs().max())
                                 for a, b in pairs),
                losses={"pod": losses[0], "host": losses[1]},
                acc={"pod": pod.history[-1]["acc"],
                     "host": host.history[-1]["acc"]})


def pod_algorithms(torch, fu, mesh) -> int:
    """Phase pod_algorithms: SCAFFOLD on the one-rank pod through
    ``run_phase_schedule``, the P2 shape of ``p2_algorithms`` (4 rounds ×
    10 clients × 25 steps, batch 32, no server optimizer), and the host
    engine's SCAFFOLD from the same init and index stream, both cuDNN
    deterministic.  Asserted: K1 1,000 launches, all of them with c; K6
    40; K2 0; K3 4 (the pod's apply); ledger == closed form (4 X);
    accuracy above chance; the pod's final params and control variates
    against the host's at the pod phases' aggregate tolerance (atol =
    rtol = 1e-4, as pod_vs_host).  Returns K1's c-form launches."""
    from repro_torch.core import comm_accounting as acc
    from repro_torch.core.pipeline import Phase, run_phase_schedule
    from repro_torch.fl.pod import PodFLConfig, PodFLSpec
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.utils.tree_math import size_bytes, tree_leaves
    task, data = lenet_setup()

    def indices(rnd, slot, step):
        g = torch.Generator().manual_seed(1_000_003 * rnd + 1009 * slot + step)
        return torch.randint(0, data.n_per_client, (32,), generator=g)
    pcfg = PodFLConfig(mesh, rounds=4, clients_per_round=10, spec=PodFLSpec(
        algorithm="scaffold", local_steps=25, batch_size=32, lr=0.01,
        update_impl="fused"), lr_decay=0.998, eval_every=4, eval_batch=256,
        sampling="host", chunk_size=8, batch_indices=indices)
    hcfg = FLConfig(algorithm="scaffold", rounds=4, participation=0.1,
                    local_steps=25, batch_size=32, update_impl="fused",
                    sampling="host", batch_indices=indices)
    flags = deterministic_cudnn(torch)
    fu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_phase_schedule(task, data, [Phase("P2", pcfg)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, c_launches = all_launches(fu), fu.local_step.c_launches
    host = run_federated(task, data, hcfg)
    restore_cudnn(torch, flags)
    st = res.phases[0].result.algo_state
    pod_t = tree_leaves((res.params, st["c_global"], st["c_clients"].rows))
    host_t = tree_leaves((host.params, host.state.c_global,
                          host.state.c_clients))
    close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                for a, b in zip(pod_t, host_t))
    steps = 4 * 10 * 25
    want = {"local_step": steps, "weighted_delta": 0, "server_update": 4,
            "compress_delta": 0, "topk_threshold": 0, "dp_clip_noise": 0,
            "topk_compress": 0, "delta_accum": 40}
    closed = acc.overhead_without_cyclic("scaffold", 10, 4,
                                         size_bytes(res.params))
    final_acc = res.history[-1]["acc"]
    emit(dict(phase="pod_algorithms", algorithm="scaffold", mesh=str(mesh),
              history=res.history, wall_s=wall, rounds_per_s=4 / wall,
              launches=launches, expected_launches=want,
              local_step_c_launches=c_launches, final_acc=final_acc,
              ledger=res.ledger.summary(), ledger_closed_form=closed,
              vs_host_tol="atol = rtol = 1e-4",
              vs_host_max_abs_diff=max(float((a - b).abs().max())
                                       for a, b in zip(pod_t, host_t)),
              vs_host_bitwise=all(bool(torch.equal(a, b))
                                  for a, b in zip(pod_t, host_t))))
    if launches != want or c_launches != steps:
        raise SystemExit(f"chip_smoke: pod_algorithms launches {launches}, "
                         f"K1 with c {c_launches}")
    if not final_acc > 0.1:
        raise SystemExit(f"chip_smoke: pod scaffold final accuracy "
                         f"{final_acc} is not above chance")
    if res.ledger.total_bytes != closed:
        raise SystemExit("chip_smoke: pod_algorithms ledger bytes differ "
                         "from the closed form")
    if not close:
        raise SystemExit("chip_smoke: the pod's and the host's SCAFFOLD "
                         "disagree")
    return c_launches


def pod_rounds(torch, mesh, init) -> dict:
    """Phase pod_rounds: warm P2 rounds/s of the pod (sequential K6) and
    of the host engine (K2) from the same P1 params, 1 round a turn, in
    turns (a b b a)."""
    from repro_torch.fl.pod import run_pod_rounds
    from repro_torch.fl.simulation import FLConfig, run_federated
    task, data = lenet_setup()
    rounds = 1
    _, pfed = pod_configs(mesh, rounds=rounds)
    hfed = FLConfig(algorithm="fedavg", rounds=rounds, participation=0.1,
                    local_steps=25, server_opt="momentum",
                    update_impl="fused", sampling="host")
    runs = {"pod": lambda: run_pod_rounds(task, data, pfed, init_params=init),
            "host": lambda: run_federated(task, data, hfed, init_params=init)}
    times = {name: [] for name in runs}
    for name in ("pod", "host", "host", "pod"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    rps = {name: [rounds / t for t in ts] for name, ts in times.items()}
    emit(dict(phase="pod_rounds", rounds=rounds, order="pod host host pod",
              wall_s=times, rounds_per_s=rps,
              mean_rounds_per_s={k: statistics.mean(v)
                                 for k, v in rps.items()}))
    return rps


# --- M10: the sparse client store and the overlapped pipeline ---------------

def store_bytes(state) -> int:
    """Bytes a client-state table holds on the card (a dense stack, the
    pod's ClientRows or a sparse store's table and index)."""
    from repro_torch.fl.pod import ClientRows
    from repro_torch.utils.tree_math import tree_leaves
    if isinstance(state, ClientRows):
        state = state.rows
    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


def store_run(torch, task, data, fed, init, *, store=None, overlap=False):
    """One P2 run of ``fed`` through ``engine.run_rounds``, with its
    algorithm's client rows in ``store`` (None: the dense store) and the
    overlapped loop on or off.  Returns the result, the strategy and the
    wall seconds (device synchronized at both ends)."""
    import dataclasses
    from repro_torch.fl.engine import run_rounds
    strategy = fed.strategy()
    if store is not None:
        strategy = dataclasses.replace(strategy, state_store=store)
    schedule = dataclasses.replace(fed.schedule(), overlap=overlap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_rounds(task, data, strategy, schedule, init_params=init,
                     label=fed.algorithm)
    torch.cuda.synchronize()
    return res, strategy, time.perf_counter() - t0


def store_rows(strategy, res) -> dict:
    """Every table of per-client rows of a run as dense stacks (a sparse
    store's through ``to_dense``), with ``c_global`` when there is one."""
    from repro_torch.fl.engine import SparseClientStateStore
    out = {}
    for key, store in strategy._residency_entries():
        st = res.algo_state[key]
        out[key] = (store.to_dense(st)
                    if isinstance(store, SparseClientStateStore) else st)
    if "c_global" in res.algo_state:
        out["c_global"] = res.algo_state["c_global"]
    return out


def bitwise_runs(torch, a, b) -> bool:
    """Params, losses and client state of two (result, strategy) pairs
    bitwise equal."""
    from repro_torch.utils.tree_math import tree_leaves
    (ra, sa), (rb, sb) = a, b
    if [h["local_loss"] for h in ra.history] != \
            [h["local_loss"] for h in rb.history]:
        return False
    pairs = list(zip(tree_leaves(ra.params), tree_leaves(rb.params)))
    xa, xb = store_rows(sa, ra), store_rows(sb, rb)
    if sorted(xa) != sorted(xb):
        return False
    for key in xa:
        pairs += list(zip(tree_leaves(xa[key]), tree_leaves(xb[key])))
    return all(bool(torch.equal(x, y)) for x, y in pairs)


# client_store's parity runs: SGD steps per client (25 before PR 23; the
# residency plan, the gates and the spills depend on the ids only)
STORE_STEPS = 1      # SGD steps a client in the parity runs (5 before
                     # pod_sharded joined the script, 10 before the MoE
                     # and zoo training phases, 2 before pod_sharded_zoo)


def client_store(torch, fu, init, mesh) -> dict:
    """Phase client_store (M10).  Parity: the main path's LeNet-5 on
    cifar10-like from its P1 params, P2 6 rounds × 10 clients ×
    ``STORE_STEPS`` (1) step, chunk 2, host sampling, of SCAFFOLD with p2_compressed's uploads
    (int8 + top-k 25% + EF: the control variates AND the residual rows
    in sparse stores) and of MOON, each with the dense store and the
    synchronous loop, the sparse store (capacity 20 = chunk × K) and the
    synchronous loop, and the sparse store and the overlapped loop; then
    SCAFFOLD under device sampling, dense against sparse-overlap.  All
    bitwise (params, losses, control variates, residual rows, moon's
    previous models through ``to_dense``; cuDNN deterministic), rows
    spilled and faulted back in under host sampling, launches per run K1
    60 (with c under SCAFFOLD), topk_compress 60 under SCAFFOLD, K2 6, 3
    dispatches.  Scale: cnn_femnist
    on femnist-like at LEAF FEMNIST's 3,550 writers (n_train cut to
    227,200, 64 a writer), SCAFFOLD 2 rounds × 10 × 25, dense-sync
    against sparse-overlap at capacity 64, bitwise, each store's bytes
    on the card and rounds/s in turns.  Pod: pod_algorithms' SCAFFOLD
    with store="sparse" (capacity 20, chunk 2) bitwise against its
    dense run."""
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.engine import SparseClientStateStore
    from repro_torch.fl.simulation import FLConfig
    from repro_torch.fl.task import vision_task
    from repro_torch.utils.tree_math import count_params
    task, data = lenet_setup()
    comp = upload_configs()["p2_compressed"]["compression"]
    flags = deterministic_cudnn(torch)
    out, bad = {}, []
    configs = {
        "scaffold_compressed": FLConfig(
            algorithm="scaffold", rounds=6, participation=0.1,
            local_steps=STORE_STEPS, batch_size=32, update_impl="fused",
            sampling="host", chunk_size=2, compression=comp),
        "moon": FLConfig(
            algorithm="moon", rounds=6, participation=0.1,
            local_steps=STORE_STEPS, batch_size=32, update_impl="fused",
            sampling="host", chunk_size=2),
        "scaffold_device_sampling": FLConfig(
            algorithm="scaffold", rounds=6, participation=0.1,
            local_steps=STORE_STEPS, batch_size=32, update_impl="fused",
            sampling="device", chunk_size=2)}
    modes = {"dense_sync": (False, False), "sparse_sync": (True, False),
             "sparse_overlap": (True, True)}
    for name, fed in configs.items():
        runs, rows = {}, {}
        for mode, (sparse, overlap) in modes.items():
            if name == "scaffold_device_sampling" and mode == "sparse_sync":
                continue
            fu.reset_launch_counts()
            res, strat, wall = store_run(
                torch, task, data, fed, init, overlap=overlap,
                store=SparseClientStateStore(capacity=20) if sparse else None)
            launches = all_launches(fu)
            c_launches = fu.local_step.c_launches
            steps = 6 * 10 * STORE_STEPS
            want = {"local_step": steps, "weighted_delta": 6,
                    "server_update": 0, "compress_delta": 0,
                    "topk_threshold": 0, "dp_clip_noise": 0,
                    "topk_compress": 60 if fed.compression else 0,
                    "delta_accum": 0}
            stores = strat.residency_stores
            rows[mode] = dict(
                wall_s=wall, rounds_per_s=6 / wall, dispatches=res.dispatches,
                timing=res.timing, launches=launches,
                local_step_c_launches=c_launches,
                final_loss=res.history[-1]["local_loss"],
                store_bytes={k: store_bytes(res.algo_state[k])
                             for k, _ in strat._residency_entries()},
                spilled_rows=[getattr(s, "spilled_rows", 0) for s in stores],
                refaulted_rows=[getattr(s, "refaulted_rows", 0)
                                for s in stores])
            runs[mode] = (res, strat)
            if launches != want or c_launches != (
                    steps if fed.algorithm == "scaffold" else 0):
                bad.append(f"{name}/{mode} launches {launches}, K1 with c "
                           f"{c_launches}")
            if res.dispatches != 3:
                bad.append(f"{name}/{mode} dispatches {res.dispatches}")
            # host sampling's ids are known here: seed 0 spills 32 rows a
            # table and faults 3 back in; the card's device draws are
            # reported only
            if sparse and fed.sampling == "host" and not all(
                    s.spilled_rows > 0 and s.refaulted_rows > 0
                    for s in stores):
                bad.append(f"{name}/{mode}: no row spilled and refaulted")
        same = {mode: bitwise_runs(torch, runs["dense_sync"], runs[mode])
                for mode in runs if mode != "dense_sync"}
        out[name] = dict(runs=rows, bitwise_vs_dense_sync=same)
        if not all(same.values()):
            bad.append(f"{name}: sparse or overlapped runs differ from "
                       f"dense-sync: {same}")

    # scale: LEAF FEMNIST's writer count
    t0 = time.perf_counter()
    fdata = DATASETS.get("femnist-like")(n_clients=3550, seed=SEED,
                                         n_train=227_200)
    data_s = time.perf_counter() - t0
    ftask = vision_task("cnn_femnist", n_classes=62, in_ch=1)
    finit = ftask.init(torch.Generator().manual_seed(SEED))
    ffed = FLConfig(algorithm="scaffold", rounds=2, participation=10 / 3550,
                    local_steps=25, batch_size=32, update_impl="fused",
                    sampling="host", chunk_size=1)
    turns, scale_runs, walls = [], {}, {"dense_sync": [], "sparse_overlap": []}
    for mode in ("dense_sync", "sparse_overlap", "sparse_overlap",
                 "dense_sync"):
        sparse = mode == "sparse_overlap"
        res, strat, wall = store_run(
            torch, ftask, fdata, ffed, finit, overlap=sparse,
            store=SparseClientStateStore(capacity=64) if sparse else None)
        walls[mode].append(wall)
        turns.append(mode)
        if mode not in scale_runs:
            scale_runs[mode] = (res, strat)
    sres, sstrat = scale_runs["sparse_overlap"]
    dres, _ = scale_runs["dense_sync"]
    scale_same = bitwise_runs(torch, scale_runs["dense_sync"],
                              scale_runs["sparse_overlap"])
    out["scale"] = dict(
        model="cnn_femnist", dataset="femnist-like", n_clients=3550,
        n_train=227_200, reduced="n_train 227,200 (64 a writer) against "
        "LEAF FEMNIST's ~805k samples; 2 rounds", data_gen_s=data_s,
        params=count_params(finit),
        capacity=64, order=" ".join(turns), wall_s=walls,
        rounds_per_s={m: [2 / w for w in ws] for m, ws in walls.items()},
        store_bytes={"dense": store_bytes(dres.algo_state["c_clients"]),
                     "sparse": store_bytes(sres.algo_state["c_clients"])},
        timing={"dense_sync": dres.timing, "sparse_overlap": sres.timing},
        bitwise=scale_same)
    if not scale_same:
        bad.append("scale: sparse-overlap differs from dense-sync")

    # the pod: pod_algorithms' SCAFFOLD with the sparse store
    out["pod"] = pod_sparse(torch, task, data, mesh)
    if not out["pod"]["bitwise"]:
        bad.append("pod: the sparse store differs from the dense one")
    restore_cudnn(torch, flags)
    emit(dict(phase="client_store", model="lenet5", rounds=6, clients=10,
              local_steps=STORE_STEPS, chunk=2, capacity=20, **out))
    if bad:
        raise SystemExit(f"chip_smoke: client_store: {bad}")
    return out


def pod_sparse(torch, task, data, mesh) -> dict:
    """pod_algorithms' SCAFFOLD (4 rounds × 10 × 25, batch 32, its index
    stream) on the one-rank mesh with the dense store (chunk 8) and with
    store="sparse" (capacity 20, chunk 2, overlap on): bitwise."""
    import dataclasses
    from repro_torch.fl.engine import run_rounds
    from repro_torch.fl.pod import PodFLConfig, PodFLSpec

    def indices(rnd, slot, step):
        g = torch.Generator().manual_seed(1_000_003 * rnd + 1009 * slot + step)
        return torch.randint(0, data.n_per_client, (32,), generator=g)
    base = PodFLConfig(mesh, rounds=4, clients_per_round=10, spec=PodFLSpec(
        algorithm="scaffold", local_steps=25, batch_size=32, lr=0.01,
        update_impl="fused"), lr_decay=0.998, eval_every=4, eval_batch=256,
        sampling="host", chunk_size=8, batch_indices=indices)
    runs, walls = {}, {}
    for name, cfg in (("dense", base),
                      ("sparse", dataclasses.replace(
                          base, store="sparse", store_capacity=20,
                          chunk_size=2))):
        strategy = cfg.strategy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_rounds(task, data, strategy, cfg.schedule(),
                         label="pod-scaffold", device=mesh.device)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        runs[name] = (res, strategy)
    sres, sstrat = runs["sparse"]
    dense_rows = runs["dense"][0].algo_state["c_clients"].rows
    sparse_rows = sstrat.state_store.to_dense(sres.algo_state["c_clients"])
    from repro_torch.utils.tree_math import tree_leaves
    pairs = list(zip(tree_leaves(runs["dense"][0].params),
                     tree_leaves(sres.params)))
    pairs += list(zip(tree_leaves(dense_rows), tree_leaves(sparse_rows)))
    pairs += list(zip(tree_leaves(runs["dense"][0].algo_state["c_global"]),
                      tree_leaves(sres.algo_state["c_global"])))
    same = all(bool(torch.equal(a, b)) for a, b in pairs) and \
        [h["local_loss"] for h in runs["dense"][0].history] == \
        [h["local_loss"] for h in sres.history]
    return dict(wall_s=walls, timing=sres.timing,
                spilled_rows=sstrat.state_store.spilled_rows,
                refaulted_rows=sstrat.state_store.refaulted_rows,
                store_bytes={"dense": store_bytes(
                    runs["dense"][0].algo_state["c_clients"]),
                    "sparse": store_bytes(sres.algo_state["c_clients"])},
                bitwise=same)


# --- M7: the Fig. 7 diagnostics ----------------------------------------------

def fig7_states(torch, main_res) -> dict:
    """The four model states of ``benchmarks/fig7_landscape.py`` on the
    main path: random init, the main path's P1 params, its P2 params
    (from P1), and one more P2 run of the main path's 4 rounds from the
    random init."""
    from repro_torch.fl.simulation import FLConfig, run_federated
    task, data = lenet_setup()
    w_rand = task.init(torch.Generator().manual_seed(SEED))
    fed = FLConfig(algorithm="fedavg", rounds=4, participation=0.1,
                   local_steps=25, server_opt="momentum", update_impl="fused",
                   sampling="host")
    fed_rand = run_federated(task, data, fed, init_params=w_rand)
    return {"random-init": w_rand,
            "cyclic-pretrained": main_res.cyclic.params,
            "final-from-random": fed_rand.params,
            "final-from-cyclic": main_res.federated.params}


def landscape(torch, states: dict, card: str = "cuda") -> dict:
    """Phase landscape (M7): ``benchmarks/fig7_landscape.py``'s probe on
    LeNet-5 — base loss and sharpness at α 0.1 / 0.5 / 1.0 over 6
    filter-normalized directions and the top Hessian eigenvalue after 10
    power iterations, on 512 test samples — for each of ``states``, and
    its 9-point slice at radius 1.0 for the two final models.  The same
    calls run on the CPU from the same directions and start vector;
    held: losses (base and slice) rtol 1e-4, each sharpness entry within
    1e-4 of the two losses it subtracts, the eigenvalue rtol 1e-3; every
    value finite.  The rows are reported, not gated."""
    from repro_torch.core import diagnostics as diag
    from repro_torch.utils import tree_math as tm
    task, data = lenet_setup()
    n = min(512, len(data.test_y))
    x, y = data.test_x[:n], data.test_y[:n]
    loss_card = diag.make_batch_loss(task, x, y, device=card)
    loss_cpu = diag.make_batch_loss(task, x, y, device="cpu")
    alphas = (0.1, 0.5, 1.0)
    rows, slices, bad = [], {}, []
    times = {"card_s": 0.0, "cpu_s": 0.0}

    def on(tree, dev):
        return tm.tree_map(lambda t: t.detach().to(dev), tree)

    def draws(params, seed, k):
        g = torch.Generator().manual_seed(seed)
        return [tm.random_like(g, on(params, "cpu")) for _ in range(k)]

    for tag, params in states.items():
        # as the benchmark: one key's split for the directions, another
        # draw for the power iteration's start and the slice
        dirs = draws(params, SEED + 100, 6)
        v0 = draws(params, SEED + 101, 1)[0]
        got = {}
        for where, loss, dev in (("card", loss_card, card),
                                 ("cpu", loss_cpu, "cpu")):
            p = on(params, dev)
            t0 = time.perf_counter()
            sharp = diag.sharpness_probe(loss, p, n_dirs=6, alphas=alphas,
                                         directions=dirs)
            eig = diag.hessian_top_eig(loss, p, n_iter=10, v0=v0)
            if tag.startswith("final"):
                slices.setdefault(tag, {})[where] = diag.landscape_slice(
                    loss, p, n_points=9, radius=1.0, direction=v0)
            if dev != "cpu":
                torch.cuda.synchronize()
            times[f"{where}_s"] += time.perf_counter() - t0
            got[where] = dict(sharp, hessian_top=eig)
        c, h = got["card"], got["cpu"]
        vals = list(c.values()) + list(h.values())
        ok = all(math.isfinite(v) for v in vals)
        ok &= math.isclose(c["base_loss"], h["base_loss"], rel_tol=1e-4)
        for a in alphas:
            k = f"sharpness@{a}"
            tol = 1e-4 * (2 * abs(h["base_loss"]) + abs(h[k]))
            ok &= abs(c[k] - h[k]) <= tol
        ok &= math.isclose(c["hessian_top"], h["hessian_top"], rel_tol=1e-3)
        rows.append(dict(state=tag, card=c, cpu=h, agree=ok))
        if not ok:
            bad.append(tag)
    slice_rows = {}
    for tag, s in slices.items():
        card, cpu = s["card"]["loss"], s["cpu"]["loss"]
        ok = bool(all(math.isfinite(v) for v in list(card) + list(cpu)) and
                  all(math.isclose(a, b, rel_tol=1e-4)
                      for a, b in zip(card, cpu)))
        slice_rows[tag] = dict(alpha=[float(a) for a in s["card"]["alpha"]],
                               card=[float(v) for v in card],
                               cpu=[float(v) for v in cpu], agree=ok)
        if not ok:
            bad.append(f"slice {tag}")
    by = {r["state"]: r["card"] for r in rows}
    emit(dict(phase="landscape", model="lenet5", test_samples=n, n_dirs=6,
              alphas=alphas, n_iter=10, slice_points=9, radius=1.0,
              tol="losses rtol 1e-4; sharpness within 1e-4 of its two "
              "losses; hessian_top rtol 1e-3", rows=rows, slices=slice_rows,
              final_from_cyclic_flatter=by["final-from-cyclic"]["sharpness@1.0"]
              <= by["final-from-random"]["sharpness@1.0"],
              **times))
    if bad:
        raise SystemExit(f"chip_smoke: landscape: the card and the CPU "
                         f"disagree or a value is not finite: {bad}")
    return rows


# --- federated LM training with LoRA through run_pod_training ---------------

@functools.lru_cache(maxsize=1)
def llm_setup():
    """tinyllama-1.1b with rank-8 LoRA adapters at full width and depth
    (22 layers, d_model 2048, 32 heads over 4 KV heads, d_ff 5632, vocab
    32000, bf16, random weights from the seed) and the example's data:
    ``make_synthetic_tokenlm(n_clients=16, seq_len=128,
    n_seq_per_client=32, vocab=32000, beta=0.5)``, made on the host
    once (seconds returned; ``llm_lora`` and ``pod_sharded`` share it)."""
    from repro_torch.data.synthetic import make_synthetic_tokenlm
    cfg = llm_setup_config()
    t0 = time.perf_counter()
    data = make_synthetic_tokenlm(n_clients=16, seq_len=128,
                                  n_seq_per_client=32, vocab=cfg.vocab_size,
                                  beta=0.5, seed=SEED)
    return cfg, data, time.perf_counter() - t0


def stream_mean(torch, metric, params, data, batch: int = 16) -> float:
    """The engine's eval stream by hand: ``metric``'s per-sample values
    over the whole test set, weighted (pad 0), on the card."""
    from repro_torch.fl.engine import batch_test_set
    ev_x, ev_y, ev_w = batch_test_set(data.test_x, data.test_y, batch)
    tot = 0.0
    with torch.no_grad():
        for b in range(ev_x.shape[0]):
            v = metric(params, torch.as_tensor(ev_x[b]).cuda(),
                       torch.as_tensor(ev_y[b]).cuda().long())
            tot += float(torch.sum(v * torch.as_tensor(ev_w[b]).cuda()))
    return tot / float(ev_w.sum())


def ulp_close(torch, a, b, n_ulp: int = 2) -> bool:
    """bf16 trees within ``n_ulp`` units in the last place of each other
    (|a − b| ≤ n_ulp · 2⁻⁷ · |b|, or both below 1e-30)."""
    from repro_torch.utils.tree_math import tree_leaves
    return all(bool(torch.all((x.float() - y.float()).abs() <=
                              n_ulp * 2.0 ** -7 * y.float().abs() + 1e-30))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def llm_lora(torch, fu, mesh) -> dict:
    """Phase llm_lora: federated next-token training of tinyllama-1.1b +
    lora:8 (``llm_setup``) through ``launch.train.run_pod_training`` on
    the one-rank NCCL mesh, the example's settings with 2 P2 rounds and
    LLM_STEPS (1) step a client: P1 1 round × 4 clients × 1 step
    relaying the whole model (one bf16 bucket of 1,106,356,224), P2 2
    rounds × 4 × 1 on the adapter bucket (6,307,840), batch 8, lr 0.03,
    the example's per-sequence loss as the eval metric every round
    (batch 16).  Asserted: K1 4 in P1 (its launches at P1's evaluation,
    the one before P2 starts), K1 8,
    K6 8, K3 2 and K2 0 in P2, no upload kernel; every frozen leaf after
    P2 bitwise P1's end value, every adapter leaf moved; the ledger's
    upload per client the adapter slice's bytes (12,615,680); the eval
    loss finite and P2's last below the init's; one P2 round under
    "fused" bitwise the same round under "fused_interpret"; one P2
    FedAvgM round of the host engine (AggregateStrategy: K2 and K3's
    aggregate form) against the pod's from P1's params, losses
    bitwise and params within 2 bf16 ulps (the two sum the f32 client
    deltas in another order before rounding to bf16, and the momentum
    step then differences values one ulp apart).  Reported: ms per SGD
    step of a warm P1 round of one client and of a profiled warm P2
    round (device ops per step, busy share), peak memory, seconds."""
    import dataclasses
    from repro_torch.configs import param_count
    from repro_torch.fl.engine import (AggregateStrategy, RoundSchedule,
                                       run_rounds)
    from repro_torch.fl.local import LocalSpec
    from repro_torch.fl.pod import (PodCyclicConfig, PodFLConfig,
                                    run_pod_rounds)
    from repro_torch.fl.task import lm_task
    from repro_torch.launch.train import (PodFLSpec, run_pod_training,
                                          sequence_loss_metric)
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import rules
    from repro_torch.utils.flatten import FlatView
    from repro_torch.utils.tree_math import tree_leaves
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    cfg, data, data_s = llm_setup()
    task = lm_task(cfg)
    shapes = task.shapes()
    mask = rules.trainable_mask(shapes, "lora")
    p1_view = FlatView.of(shapes)
    p2_view = FlatView.of(shapes, filter=mask)
    n_params = param_count(cfg)
    if (n_params, p1_view.buffer_sizes, p2_view.buffer_sizes) != (
            N_TINYLLAMA, {"bfloat16": N_TINYLLAMA}, {"bfloat16": N_LORA}):
        raise SystemExit(f"chip_smoke: tinyllama-1.1b + lora:8 has "
                         f"{n_params} params, buckets "
                         f"{p1_view.buffer_sizes} / {p2_view.buffer_sizes}")
    spec = PodFLSpec(local_steps=LLM_STEPS, batch_size=8, lr=0.03,
                     update_impl="fused", peft=LLM_PEFT)
    metric = sequence_loss_metric(cfg)
    p1_launches = {}

    def eval_fn(params, bx, by):
        # P1's one round evaluates before P2 starts: its launches so far
        if not p1_launches:
            p1_launches.update(all_launches(fu))
        return metric(params, bx, by)

    init = init_lm(cfg, SEED, "cuda")
    init_loss = stream_mean(torch, metric, init, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fu.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_pod_training(cfg, data, cyclic_rounds=1, fl_rounds=2,
                           clients_per_round=LLM_K, spec=spec, mesh=mesh,
                           seed=SEED, eval_fn=eval_fn, eval_batch=16,
                           init_params=init)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches(fu)
    p2_launches = {k: launches[k] - p1_launches[k] for k in launches}
    zero = dict.fromkeys(launches, 0)
    want_p1 = dict(zero, local_step=1 * LLM_K * LLM_STEPS)
    want_p2 = dict(zero, local_step=2 * LLM_K * LLM_STEPS,
                   delta_accum=2 * LLM_K,
                   server_update=2)
    p1 = res.schedule.phases[0].result.params
    frozen_ok, moved = True, 0
    for a, b, m in zip(tree_leaves(p1), tree_leaves(res.params), mask):
        if m:
            moved += int(not torch.equal(a, b))
        else:
            frozen_ok &= bool(torch.equal(a, b))
    led = res.schedule.ledger
    per_client = led.p2_upload_bytes // (2 * LLM_K)
    closed = 2 * N_LORA
    evals = [h["eval"] for h in res.history]

    # the kernels against their plain versions: one P2 round each way
    def p2_round(impl, **kw):
        c = PodFLConfig(mesh, rounds=1, clients_per_round=LLM_K, seed=SEED +
                        17, spec=dataclasses.replace(spec, update_impl=impl,
                                                     **kw))
        return run_pod_rounds(task, data, c, init_params=p1)
    fu.reset_launch_counts()
    fused = p2_round("fused")
    bitwise = same_leaves(torch, fused.params,
                          p2_round("fused_interpret").params)
    del fused

    # the host engine against the pod: one FedAvgM round from P1's params
    fu.reset_launch_counts()
    pod_m = p2_round("fused", server_opt="momentum")
    pod_launches = all_launches(fu)
    fu.reset_launch_counts()
    host = run_rounds(task, data, AggregateStrategy(
        spec=LocalSpec(n_steps=LLM_STEPS, batch_size=8, lr=0.03,
                       update_impl="fused",
                       peft=LLM_PEFT),
        participation=LLM_K / data.n_clients, server_opt="momentum"),
        RoundSchedule(rounds=1, lr_decay=1.0, eval_every=0, seed=SEED + 17,
                      chunk_size=4), init_params=p1)
    host_launches = all_launches(fu)
    host_loss_bitwise = [h["local_loss"] for h in host.history] == \
        [h["local_loss"] for h in pod_m.history]
    host_ok = ulp_close(torch, host.params, pod_m.params)
    host_gap = max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(tree_leaves(host.params), tree_leaves(pod_m.params)))
    host_bitwise = same_leaves(torch, host.params, pod_m.params)
    del host, pod_m

    # warm timings: a P1 round of one client, a profiled P2 round
    c1 = PodCyclicConfig(mesh, rounds=1, clients_per_round=1, seed=SEED,
                         spec=dataclasses.replace(spec, peft=None))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_pod_rounds(task, data, c1, init_params=p1, phase="P1")
    torch.cuda.synchronize()
    p1_step_ms = (time.perf_counter() - t0) * 1e3 / LLM_STEPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p2_round("fused")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_ops, top = device_activity(prof, n_top=8)
    steps = LLM_K * LLM_STEPS
    emit(dict(phase="llm_lora", model=f"{LLM_ARCH} + {LLM_PEFT}",
              params=n_params, base_params=LLM_BASE, adapter_params=N_LORA,
              p1_bucket=N_TINYLLAMA, p2_bucket=N_LORA, dtype="bfloat16",
              dataset="make_synthetic_tokenlm(16 clients, 32 x 128, vocab "
              "32000, beta 0.5)", data_s=data_s,
              history=res.history, init_eval_loss=init_loss, run_s=run_s,
              launches_p1=p1_launches, expected_p1=want_p1,
              launches_p2=p2_launches, expected_p2=want_p2,
              frozen_bitwise=frozen_ok, adapters_moved=moved,
              adapter_leaves=sum(mask), ledger=led.summary(),
              upload_bytes_per_client=per_client,
              upload_closed_form=closed,
              upload_ratio=led.summary()["payload_ratio"],
              fused_equals_plain_bitwise=bitwise,
              host_vs_pod=dict(server_opt="momentum", rounds=1,
                               tol="2 bf16 ulps", within_tol=host_ok,
                               bitwise=host_bitwise, max_abs_diff=host_gap,
                               losses_bitwise=host_loss_bitwise,
                               host_launches=host_launches,
                               pod_launches=pod_launches),
              p1_ms_per_sgd_step=p1_step_ms,
              profiled_p2_round=dict(
                  sgd_steps=steps, wall_ms=wall_us / 1e3,
                  ms_per_step=wall_us / 1e3 / steps,
                  device_busy_ms=busy / 1e3,
                  device_busy_share=busy / wall_us if n_ops else None,
                  device_ops=n_ops, device_ops_per_step=n_ops / steps,
                  top_device_ops=top),
              peak_memory_bytes=peak,
              phase_s=time.perf_counter() - t_phase))
    if p1_launches != want_p1 or p2_launches != want_p2:
        raise SystemExit(f"chip_smoke: llm_lora launches P1 {p1_launches} "
                         f"P2 {p2_launches}")
    if not frozen_ok or moved != sum(mask):
        raise SystemExit(f"chip_smoke: llm_lora frozen leaves changed "
                         f"({frozen_ok}) or adapters did not move "
                         f"({moved}/{sum(mask)})")
    if per_client != closed or led.p2_upload_bytes != 2 * LLM_K * closed:
        raise SystemExit(f"chip_smoke: llm_lora upload bytes {per_client} "
                         f"!= the adapter slice's {closed}")
    if not (all(math.isfinite(e) for e in evals) and evals[-1] < init_loss):
        raise SystemExit(f"chip_smoke: llm_lora eval loss {evals} did not "
                         f"fall below the init's {init_loss}")
    if not bitwise:
        raise SystemExit("chip_smoke: llm_lora's kernels and plain path "
                         "disagree")
    if not (host_ok and host_loss_bitwise):
        raise SystemExit("chip_smoke: llm_lora's host engine and pod "
                         "disagree")
    if host_launches["weighted_delta"] != 1 or \
            host_launches["server_update"] != 1:
        raise SystemExit(f"chip_smoke: the host engine's P2 round launched "
                         f"{host_launches}")
    if not n_ops:
        raise SystemExit("chip_smoke: the profiler saw no device op")
    del res, p1, init
    torch.cuda.empty_cache()
    return dict(p1=p1_launches, p2=p2_launches, host=host_launches,
                all={k: p1_launches[k] + p2_launches[k] for k in launches})


# pod_sharded: tinyllama-1.1b + lora:8 on a (2, 2) data x model mesh of
# four gloo ranks, each a process driving cuda:0 (one card: NCCL refuses
# two ranks on one device)
SHARDED_MESH = (2, 2)
# 1 SGD step a client (2 before pod_sharded_zoo: the script's time)
SHARDED_K, SHARDED_STEPS, SHARDED_BATCH = 2, 1, 8
# fsdp_tp computes tensor-parallel; fsdp_only (gather-then-compute) runs
# P1 alone, the phase its bitwise gate against replicated reads
SHARDED_LAYOUTS = ("fsdp_tp", "replicated", "fsdp_only")
# fsdp_tp against replicated in bf16 (the CPU tests' f32 tolerances do
# not carry over): every GEMM of a tensor-parallel step has other shapes
# (half the heads, columns or rows), so cuBLAS sums in another order and
# a bf16 output can round to the neighbouring value; the row-parallel
# halves then sum over model in bf16.  Through 22 layers and 8 SGD steps
# that moves the losses by ~2e-5 relative and ~1.5% of the params by an
# ulp (PR 28 calls 1-2: losses 1.9e-5 and 2.4e-5 apart, the largest
# difference of a leaf 3.4-3.7% of its largest magnitude); reducing the
# row-parallel outputs in f32 moved neither (call 2).  The gates: losses within rtol 5e-5, each leaf within 2**-4
# of its largest magnitude.
SHARDED_LOSS_RTOL = 5e-5
SHARDED_TP_TOL = 2.0 ** -4
# the gather-then-compute bytes gathered a step (PR 26's fsdp_tp)
SHARDED_GATHERED_BEFORE = 2_765_660_160
# the per-shard rows of its fsdp_tp buckets: P1's base over data + model,
# P2's adapters over data and over model (kernel rows at these sizes)
SHARDED_P1_ROW, SHARDED_P2_ROW = 274_989_056, 1_576_960


def _run_ranks(name: str, flag: str, world: int, store: str, tmp: str,
               env=None, timeout: float = 900.0) -> list:
    """Runs ``world`` ranks of ``chip_smoke.py FLAG R STORE TMP``, each
    one's output in ``TMP/rank<R>.log``, and returns their reports
    (``TMP/rank<R>.json``).  As soon as one rank fails, or ``timeout``
    seconds have passed, it ends every rank (the others would wait in a
    collective) and fails with the end of each rank's log."""
    logs = [open(Path(tmp, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(r), store,
         tmp], stdout=f, stderr=subprocess.STDOUT, text=True, env=env)
        for r, f in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and \
                all(p.returncode in (None, 0) for p in procs) and \
                time.monotonic() < deadline:
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        late = " (out of time)" if time.monotonic() >= deadline else ""
        raise SystemExit(f"chip_smoke: {name}{late}: " + "\n".join(
            f"rank {r} exited {p.returncode}:\n"
            f"{Path(tmp, f'rank{r}.log').read_text()[-3000:]}"
            for r, p in enumerate(procs)))
    return [json.loads(Path(tmp, f"rank{r}.json").read_text())
            for r in range(world)]


def pod_sharded_worker(rank: int, store: str, out: str) -> int:
    """One rank of ``pod_sharded`` (``chip_smoke.py --pod-sharded-rank R
    STORE OUT``): joins the four-rank gloo group over the ``file://``
    store on cuda:0, then under each of SHARDED_LAYOUTS runs
    tinyllama-1.1b + lora:8 on ``llm_setup``'s data (the parent's, read
    from ``OUT/data.pkl``) through ``run_pod_training`` from one seeded
    init, made once: P1 1 round x 2 clients x 1 step relaying the whole
    model, then P2 1 x 2 x 1 on the adapters, batch 8, lr 0.03 (fsdp_only:
    P1 alone).  Writes ``OUT/rank<R>.json`` (per layout: seconds, ms a
    step, the collectives and their bytes, K1/K6/K3 launches, the bytes
    of the carried buffers, peak memory, whether P2 kept the frozen
    leaves, whether each phase computed tensor-parallel), whether
    fsdp_only's P1 params equal the replicated run's bit for bit, and
    fsdp_tp's largest difference from the replicated params."""
    import pickle
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=math.prod(SHARDED_MESH), rank=rank)
    from repro_torch.fl import pod
    from repro_torch.kernels import fused_update as fu
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import PodFLSpec, run_pod_training
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import rules
    from repro_torch.utils.tree_math import tree_leaves

    mesh = make_mesh(SHARDED_MESH, ("data", "model"), "cuda:0")
    cfg = llm_setup_config()
    t0 = time.perf_counter()
    data = pickle.loads(Path(out, "data.pkl").read_bytes())
    init = init_lm(cfg, SEED, "cuda")
    mask = rules.trainable_mask(init, "lora")
    torch.cuda.synchronize()
    spec = PodFLSpec(local_steps=SHARDED_STEPS, batch_size=SHARDED_BATCH,
                     lr=0.03, update_impl="fused", peft=LLM_PEFT)
    steps = SHARDED_K * SHARDED_STEPS
    report, finals = {"rank": rank, "coords": mesh.coords,
                      "setup_s": time.perf_counter() - t0}, {}
    for layout in SHARDED_LAYOUTS:
        fl_rounds = 0 if layout == "fsdp_only" else 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pod.reset_collective_counts()
        fu.reset_launch_counts()
        dist.barrier()
        t0 = time.perf_counter()
        res = run_pod_training(cfg, data, cyclic_rounds=1,
                               fl_rounds=fl_rounds,
                               clients_per_round=SHARDED_K, spec=spec,
                               mesh=mesh, seed=SEED, layout=layout,
                               init_params=init)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        phases = [ph.result for ph in res.schedule.phases]
        n_steps = len(phases) * steps
        report[layout] = dict(
            run_s=run_s, ms_per_step=run_s * 1e3 / n_steps,
            collectives=dict(pod.COLLECTIVES),
            collective_bytes=dict(pod.COLLECTIVE_BYTES),
            gathered_bytes_per_step=pod.COLLECTIVE_BYTES["gather"] /
            n_steps,
            tp_bytes_per_step=pod.COLLECTIVE_BYTES["tp"] / n_steps,
            tp_compute=[ph.tp_compute for ph in phases],
            launches={k: fn.launches for k, fn in (
                ("local_step", fu.local_step),
                ("delta_accum", fu.delta_accum),
                ("server_update", fu.server_update))},
            resident_p1=phases[0].resident_bytes,
            resident_p2=phases[-1].resident_bytes if fl_rounds else None,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            losses=[h["loss"] for h in res.history],
            frozen_kept_by_p2=all(torch.equal(a, b) for a, b, m in zip(
                tree_leaves(phases[0].params), tree_leaves(res.params),
                mask) if not m))
        if layout == "fsdp_tp":
            finals[layout] = tree_leaves(res.params)
        elif layout == "replicated":
            report["tp_vs_replicated"] = _tp_vs_replicated(
                torch, finals.pop("fsdp_tp"), tree_leaves(res.params))
            # the runs read the init and never write it: a run that did
            # would start the other layouts elsewhere and fail the gates
            report["moved"] = sum(int(not torch.equal(x, y)) for x, y in
                                  zip(tree_leaves(res.params),
                                      tree_leaves(init)))
            finals["replicated/P1"] = tree_leaves(phases[0].params)
        else:
            a, b = tree_leaves(res.params), finals.pop("replicated/P1")
            report["fsdp_only_bitwise"] = len(a) == len(b) and all(
                x.dtype == y.dtype and torch.equal(x, y)
                for x, y in zip(a, b))
        del res, phases
        torch.cuda.empty_cache()
    Path(out, f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _tp_vs_replicated(torch, a, b, base=None) -> dict:
    """fsdp_tp's leaves ``a`` against replicated's ``b`` (each leaf of
    ``b`` on ``a``'s device for the comparison), or with ``base`` (the
    init's leaves) their changes from it, ``a - base`` against
    ``b - base``: the largest difference of a leaf over its largest
    magnitude (``rel``, and the leaf's index), the largest of a leaf's
    L2 norm of the difference over its L2 norm (``l2``, and the leaf's
    index), the largest difference, the share of elements that differ,
    and the share that differ by more than one ulp of the larger of the
    two values in the leaves' dtype."""
    rel = l2 = max_abs = differ = beyond = n = 0
    worst = worst_l2 = None
    for i, (x, y) in enumerate(zip(a, b)):
        y = y.to(x.device)
        big = torch.maximum(x.float().abs(), y.float().abs())
        if base is not None:
            z = base[i].to(x.device).float()
            x, y = x.float() - z, y.float() - z
            del z
        d = (x.float() - y.float()).abs()
        top = float(d.max())
        r = top / max(float(y.float().abs().max()), 1e-30)
        if r > rel:
            rel, worst = r, i
        norm = float(torch.linalg.vector_norm(y.float()))
        r = float(torch.linalg.vector_norm(d)) / norm if norm else \
            (0.0 if top == 0 else math.inf)
        if r > l2:
            l2, worst_l2 = r, i
        max_abs = max(max_abs, top)
        differ += int((d > 0).sum())
        dt = a[i].dtype
        ulp = torch.finfo(dt).eps * torch.exp2(torch.floor(
            torch.log2(big.clamp(min=torch.finfo(dt).tiny))))
        beyond += int((d > ulp).sum())
        n += d.numel()
        del d, big, ulp, x, y
    return dict(dtypes_equal=all(x.dtype == y.dtype for x, y in zip(a, b)),
                rel=rel, worst_leaf=worst, l2=l2, worst_leaf_l2=worst_l2,
                max_abs=max_abs, differ=differ / n, beyond_one_ulp=beyond / n)


def pod_sharded(torch) -> dict:
    """Phase pod_sharded: sharded FSDP/TP groups on four ranks of one
    card.  Spawns four ``pod_sharded_worker`` processes (gloo over a
    ``file://`` store under TMPDIR, all on cuda:0; the kernels run on the
    card, the collectives go through gloo, which takes CUDA tensors) and
    gates: fsdp_tp computed tensor-parallel in both phases on every rank
    (``tp_compute``, "tp" all-reduces) and fsdp_only and replicated did
    not; fsdp_only's P1 params bitwise the replicated run's; fsdp_tp's
    losses within SHARDED_LOSS_RTOL and its params within SHARDED_TP_TOL
    of the replicated run's; each rank's resident frozen rows in P2 the
    per-shard sizes of the fsdp_tp view, a quarter of the replicated
    run's but for the few leaves sharded over one axis or none (550 MB
    against 2.2 GB); K1, K6 and K3 launched once per bucket each step,
    client and round (4 x P1's buckets + 4 x P2's, 2 x P2's, P2's); the
    gathers and gradient collectives by kind, exactly
    (``want_collectives``: under fsdp_tp one a part of a bucket,
    ``ShardedFlatView.model_local``; the "tp" kind is dryrun_check
    (b)'s); fsdp_tp's bytes gathered a step below the
    gather-then-compute run's; P2 kept every frozen leaf; the losses
    finite.  Reported per rank: ms a step, bytes gathered and all-reduced
    over model a step, collectives by kind, peak memory, and the card.
    Returns the fsdp_tp launches of rank 0 (the kernel rows' launches)
    and every rank's report (dryrun_check reads their collectives)."""
    import pickle
    import tempfile
    import dataclasses
    from repro_torch.fl.task import lm_task
    from repro_torch.sharding import rules, tensor_parallel
    from repro_torch.utils.tree_math import tree_paths

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, data, _ = llm_setup()
    shapes = lm_task(cfg).shapes()
    mesh = _StaticMesh(SHARDED_MESH)
    views = {(layout, ph): rules.sharded_flat_view(
        shapes, mesh, layout, "lora" if ph == "P2" else None)
        for layout in SHARDED_LAYOUTS for ph in ("P1", "P2")}
    tp1, tp2 = views[("fsdp_tp", "P1")], views[("fsdp_tp", "P2")]
    rows = {g.size for g in tp1.trainable_groups} | \
        {g.size for g in tp2.trainable_groups}
    if not {SHARDED_P1_ROW, SHARDED_P2_ROW} <= rows:
        raise SystemExit(f"chip_smoke: pod_sharded's fsdp_tp rows are "
                         f"{sorted(rows)}")
    # the tensor-parallel layout of a rank (the same on every one)
    tp = tensor_parallel.TPContext(
        mesh=None, size=SHARDED_MESH[1], rank=0,
        plan=tensor_parallel.plan(cfg, SHARDED_MESH[1]),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        vocab_size=cfg.vocab_size)
    local = [tp.local(p) for p in tree_paths(shapes)]
    tmp = tempfile.mkdtemp(prefix="pod_sharded_")
    Path(tmp, "data.pkl").write_bytes(pickle.dumps(data))
    store = os.path.join(tmp, "store")
    world = math.prod(SHARDED_MESH)
    ranks = _run_ranks("pod_sharded", "--pod-sharded-rank", world, store,
                       tmp, timeout=600)
    steps = SHARDED_K * SHARDED_STEPS

    def phases(layout):
        return ("P1",) if layout == "fsdp_only" else ("P1", "P2")

    def want(layout):
        n1 = len(views[(layout, "P1")].trainable_groups)
        if layout == "fsdp_only":
            return dict(local_step=steps * n1, delta_accum=0,
                        server_update=0)
        n2 = len(views[(layout, "P2")].trainable_groups)
        return dict(local_step=steps * (n1 + n2), delta_accum=SHARDED_K * n2,
                    server_update=n2)

    def want_collectives(layout):
        """A phase's collectives a rank but the "tp" kind: each step
        gathers every part of a bucket sharded over mesh axes (trainable
        and frozen; a part: the bucket, or under fsdp_tp its leaves that
        keep their model tile and the rest) at the loss, and the result
        gathers the buckets once more; each step reduces each trainable
        part's gradient with one collective (the mesh's one batch axis,
        data: a reduce-scatter for a part sharded over it, else an
        all-reduce); one loss reduction a phase (one chunk)."""
        out = dict.fromkeys(("grad", "gather", "clip", "batch",
                             "lane_combine", "store_gather", "store_spill",
                             "moe"), 0)
        for ph in phases(layout):
            v = views[(layout, ph)]
            lv, parts = (v.model_local(local) if layout == "fsdp_tp" else
                         (v, {g.name: ((g.name, None),) for g in v.groups}))
            out["gather"] += steps * sum(
                1 for ps in parts.values() for n, _ in ps
                if lv.group_map[n].axes)
            out["gather"] += sum(1 for g in v.groups if g.axes)
            out["grad"] += steps * sum(len(parts[g.name])
                                       for g in v.trainable_groups)
            out["batch"] += 1
        return out
    frozen_rows = 2 * sum(g.size for g in tp2.frozen_groups)
    frozen_whole = 2 * sum(g.size * g.n_shards for g in tp2.frozen_groups)
    bad = []
    for rk in ranks:
        tp_run, rep = rk["fsdp_tp"], rk["replicated"]
        for layout in SHARDED_LAYOUTS:
            got = rk[layout]
            if got["launches"] != want(layout):
                bad.append(f"rank {rk['rank']} {layout} launches "
                           f"{got['launches']} != {want(layout)}")
            if not (got["frozen_kept_by_p2"] and all(
                    math.isfinite(x) for x in got["losses"])):
                bad.append(f"rank {rk['rank']} {layout}: frozen leaves "
                           f"changed or losses {got['losses']}")
            tp_on = layout == "fsdp_tp"
            if got["tp_compute"] != [tp_on] * len(phases(layout)) or \
                    (got["collectives"]["tp"] > 0) != tp_on:
                bad.append(f"rank {rk['rank']} {layout}: tp_compute "
                           f"{got['tp_compute']}, tp collectives "
                           f"{got['collectives']['tp']}")
            coll = {k: v for k, v in got["collectives"].items() if k != "tp"}
            if coll != want_collectives(layout):
                bad.append(f"rank {rk['rank']} {layout} collectives "
                           f"{coll} != {want_collectives(layout)}")
        if (tp_run["resident_p2"]["frozen"], rep["resident_p2"]["frozen"]) \
                != (frozen_rows, frozen_whole):
            bad.append(f"rank {rk['rank']} frozen bytes "
                       f"{tp_run['resident_p2']['frozen']} / "
                       f"{rep['resident_p2']['frozen']}")
        if not rk["fsdp_only_bitwise"] or rk["moved"] == 0:
            bad.append(f"rank {rk['rank']}: fsdp_only and replicated P1 "
                       f"params differ ({rk['fsdp_only_bitwise']}) or none "
                       f"moved")
        close = rk["tp_vs_replicated"]
        if not (close["dtypes_equal"] and close["rel"] <= SHARDED_TP_TOL):
            bad.append(f"rank {rk['rank']}: fsdp_tp params off the "
                       f"replicated run's: {close}")
        if not all(math.isclose(a, b, rel_tol=SHARDED_LOSS_RTOL,
                                abs_tol=0.0)
                   for a, b in zip(tp_run["losses"], rep["losses"])):
            bad.append(f"rank {rk['rank']}: fsdp_tp losses "
                       f"{tp_run['losses']} against {rep['losses']}")
        if not tp_run["gathered_bytes_per_step"] < SHARDED_GATHERED_BEFORE:
            bad.append(f"rank {rk['rank']}: fsdp_tp gathers "
                       f"{tp_run['gathered_bytes_per_step']} B a step")
    emit(dict(phase="pod_sharded", model=f"{LLM_ARCH} + {LLM_PEFT}",
              mesh=dict(zip(("data", "model"), SHARDED_MESH)),
              backend="gloo, four processes on cuda:0",
              rounds={"P1": f"1 x 2 clients x {SHARDED_STEPS} steps",
                      "P2": f"1 x 2 clients x {SHARDED_STEPS} steps (not "
                            f"fsdp_only)"},
              batch=SHARDED_BATCH, tp_plan=dataclasses.asdict(tp.plan),
              per_step={layout: dict(
                  ms=[rk[layout]["ms_per_step"] for rk in ranks],
                  gathered_bytes=ranks[0][layout]["gathered_bytes_per_step"],
                  tp_bytes=ranks[0][layout]["tp_bytes_per_step"],
                  peak_memory_bytes=[rk[layout]["peak_memory_bytes"]
                                     for rk in ranks])
                  for layout in SHARDED_LAYOUTS},
              buckets={f"{layout}/{ph}": {
                  g.name: [g.n_shards, g.size] for g in v.groups}
                  for (layout, ph), v in views.items()},
              frozen_bytes_per_rank={"fsdp_tp": frozen_rows,
                                     "replicated": frozen_whole},
              expected_launches={layout: want(layout)
                                 for layout in SHARDED_LAYOUTS},
              expected_collectives={layout: want_collectives(layout)
                                    for layout in SHARDED_LAYOUTS},
              tp_tol=SHARDED_TP_TOL, loss_rtol=SHARDED_LOSS_RTOL,
              ranks=ranks, card=nvidia_smi(),
              phase_s=time.perf_counter() - t_phase))
    if bad:
        raise SystemExit("chip_smoke: pod_sharded: " + "; ".join(bad))
    return ranks[0]["fsdp_tp"]["launches"], ranks


class _StaticMesh:
    """What the sharding rules read of a mesh, without a process group."""

    def __init__(self, shape):
        import numpy as np
        self.axis_names = ("data", "model")
        self.devices = np.zeros(shape)
        self.shape = dict(zip(self.axis_names, shape))


def llm_setup_config():
    """``llm_setup``'s model config without its data."""
    from repro_torch.configs import get_config, with_peft
    return with_peft(get_config(LLM_ARCH), LLM_PEFT)


def check_sharded_kernels(torch, bench) -> dict:
    """Phase 2 at pod_sharded's per-shard rows under fsdp_tp (returned,
    bitwise against their plain versions): K1 (clip 1, no decay, no
    momentum) over P1's row of the base (N 274,989,056; three trials of
    three calls) and over P2's row of an adapter bucket (N 1,576,960),
    K6 with p at that row (bf16 w and p, f32 delta) and K3's apply
    ("none")."""
    bf16 = torch.bfloat16
    out = {"local_step": bench.local_step(SHARDED_P2_ROW, bf16, False,
                                          False, wd=0.0, clip=1.0),
           "delta_accum": bench.delta_accum(SHARDED_P2_ROW, bf16, True),
           "server_update": bench.server_update(SHARDED_P2_ROW, "none",
                                                dtype=bf16)}
    bench.trials, bench.reps = 3, 3
    out["local_step_p1"] = bench.local_step(SHARDED_P1_ROW, bf16, False,
                                            False, wd=0.0, clip=1.0)
    bench.trials, bench.reps = 5, 20
    torch.cuda.empty_cache()
    for r in out.values():
        emit(dict(phase="kernel", path="pod_sharded", **r))
    bad = [k for k, r in out.items()
           if not (r["max_abs_err"] <= KERNEL_TOL and r.get("bitwise", True))]
    if bad:
        raise SystemExit(f"chip_smoke: kernels at pod_sharded's rows "
                         f"disagree with their plain versions: {bad}")
    return out


# pod_sharded_moe: the MoE zoo on four gloo ranks of one card.  (a) the
# 3-layer cut of deepseek-v2-lite-16b + lora:8 (the dense layer and two
# MoE layers at full width) on (2, 2): P1 and P2 1 x 2 x 1 at batch 8 x
# 128 under fsdp_tp (experts and MLA heads over model, the batch over
# data) and replicated (the batch over data); (b) the whole model on
# (1, 4) under fsdp_tp, P2 alone (16 experts and 4 heads a rank)
MOE_SHARDED_MESH, MOE_FULL_MESH = (2, 2), (1, 4)
MOE_SHARDED_LAYOUTS = ("fsdp_tp", "replicated")
# fsdp_tp against replicated in bf16: pod_sharded's reasons, and the
# router's top-k turns bf16 rounding into other routing: a few pairs of
# each layer's 49,152 go to other experts and other pairs overflow (the
# CPU tests hold the f32 step at rtol 1e-5 / atol 2e-5).  Each gate sits
# between the sound runs' largest reading on an H100 and the control's
# (fsdp_tp's P1 with the router's gradient summed over model, |model|
# times too large; PERF.md, pod_sharded_moe): the leaf's change from the
# init over P1, the L2 norm of its gap over the change's L2 norm (sound
# 0.382, a LoRA factor that moves by a few bf16 ulps; the control 1.016,
# the router); a leaf's largest gap over its largest magnitude at P2's
# end, pod_sharded's 2**-4 (sound 0.0557–0.0566).  The losses (sound
# 7.0e-5 apart, the same bits on every run) cannot tell the control
# (6.9e-6) from a sound run: their gate only bounds the bf16 drift
MOE_SHARDED_LOSS_RTOL = 1e-4
MOE_SHARDED_TP_TOL = 2.0 ** -4
MOE_SHARDED_DELTA_TOL = 0.6


def _moe_drops(log, n_layers: int) -> dict:
    """Per MoE layer (a forward's calls in layer order), the routed pairs
    a rank dropped and routed over a run's ``record_routing`` log, and
    the capacities."""
    return dict(dropped=[sum(int(e["dropped"]) for e in log[i::n_layers])
                         for i in range(n_layers)],
                routed=[sum(e["pairs"] for e in log[i::n_layers])
                        for i in range(n_layers)],
                capacity=sorted({e["capacity"] for e in log}))


def pod_sharded_moe_worker(rank: int, store: str, out: str) -> int:
    """One rank of ``pod_sharded_moe`` (``chip_smoke.py
    --pod-sharded-moe-rank R STORE OUT``): joins the four-rank gloo group
    over the ``file://`` store on cuda:0 and reads the parent's
    ``moe_setup`` config and data from ``OUT/data.pkl``.  (a) on
    MOE_SHARDED_MESH, under each of MOE_SHARDED_LAYOUTS, the 3-layer cut
    through ``run_pod_training`` from one seeded init: P1 1 x 2 x 1
    relaying the whole model, then P2 1 x 2 x 1 on the MOE_FILTER slice,
    batch 8, lr 0.03; then, when the parent asks for it, the control,
    fsdp_tp's P1 with a planted fault (``TPContext.partial`` patched in
    this process to mark the router partial).  (b) on MOE_FULL_MESH under fsdp_tp, the whole
    model, P2 1 x 2 x 1 on the slice: the ranks draw the init one at a
    time behind barriers, each packs its rows (``engine.FlatRows``) and
    frees the tree, so the card holds one whole model at most; the run
    starts and ends with the rows.  Writes ``OUT/rank<R>.json``: per run
    the seconds, ms a step, the collectives and their bytes, K1/K6/K3
    launches, the carried buffers' bytes, peak memory, the losses, the
    dropped pairs per MoE layer, whether each phase computed
    tensor-parallel and kept the frozen leaves; fsdp_tp's and the
    control's differences from the replicated params
    (``_tp_vs_replicated``: at P2's end, and of the changes from the
    init at P1's and P2's ends); (b) whether every router moved (each
    layer's row) and every frozen row stayed bitwise."""
    import dataclasses
    import faulthandler
    import pickle
    import torch
    import torch.distributed as dist
    faulthandler.enable()
    torch.cuda.set_device(0)
    world = math.prod(MOE_SHARDED_MESH)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    from repro_torch.fl import pod
    from repro_torch.fl.engine import FlatRows
    from repro_torch.fl.task import lm_task
    from repro_torch.kernels import fused_update as fu
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import run_pod_training
    from repro_torch.models.layers import record_routing
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import rules
    from repro_torch.sharding import tensor_parallel as tpl
    from repro_torch.utils.tree_math import tree_leaves, tree_map

    cfg, data, control = pickle.loads(Path(out, "data.pkl").read_bytes())
    cut = dataclasses.replace(cfg, n_layers=MOE_CUT_LAYERS)
    spec = moe_spec(local_steps=SHARDED_STEPS, batch_size=SHARDED_BATCH)
    steps = SHARDED_K * SHARDED_STEPS

    def launches():
        return {k: fn.launches for k, fn in (
            ("local_step", fu.local_step), ("delta_accum", fu.delta_accum),
            ("server_update", fu.server_update))}

    def run(model, mesh, layout, init, cyclic_rounds, fl_rounds=1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pod.reset_collective_counts()
        fu.reset_launch_counts()
        dist.barrier()
        t0 = time.perf_counter()
        with record_routing() as log:
            res = run_pod_training(model, data, cyclic_rounds=cyclic_rounds,
                                   fl_rounds=fl_rounds,
                                   clients_per_round=SHARDED_K,
                                   spec=spec, mesh=mesh, seed=SEED,
                                   layout=layout, init_params=init)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        phases = [ph.result for ph in res.schedule.phases]
        n_steps = len(phases) * steps
        per_step = {k: pod.COLLECTIVE_BYTES[k] / n_steps
                    for k in ("gather", "tp", "moe")}
        return res, phases, dict(
            run_s=run_s, ms_per_step=run_s * 1e3 / n_steps,
            collectives=dict(pod.COLLECTIVES),
            collective_bytes=dict(pod.COLLECTIVE_BYTES),
            bytes_per_step=per_step, tp_compute=[ph.tp_compute
                                                 for ph in phases],
            launches=launches(),
            resident=[ph.resident_bytes for ph in phases],
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            losses=[h["loss"] for h in res.history],
            drops=_moe_drops(log, model.n_layers - model.n_dense_layers))

    # (a) the cut on (2, 2): replicated, then fsdp_tp, then with
    # ``control`` the control (fsdp_tp's P1 with the router marked
    # partial: its gradient, whole on every rank, summed over model,
    # |model| times what it is); the init waits on the host (each run
    # copies its rows to the card), so that four ranks' result gathers
    # fit on the one card.  Every rank ends with the same whole params,
    # so rank 0 alone keeps replicated's P1 and P2 ends (on the host:
    # four ranks' copies would exceed the machine's memory) and compares
    mesh = make_mesh(MOE_SHARDED_MESH, ("data", "model"), "cuda:0")
    t0 = time.perf_counter()
    init = tree_map(lambda t: t.cpu(), init_lm(cut, SEED, "cuda"))
    torch.cuda.empty_cache()
    base = tree_leaves(init)
    mask = rules.trainable_mask(init, MOE_FILTER)
    report = {"rank": rank, "coords": dict(mesh.coords),
              "setup_s": time.perf_counter() - t0}
    ref = None
    for layout in ("replicated", "fsdp_tp"):
        res, phases, got = run(cut, mesh, layout, init, 1)
        got["frozen_kept_by_p2"] = all(torch.equal(a, b) for a, b, m in zip(
            tree_leaves(phases[0].params), tree_leaves(res.params), mask)
            if not m)
        report[layout] = got
        ends = [tree_leaves(phases[0].params), tree_leaves(res.params)]
        if rank != 0:
            pass
        elif ref is None:
            ref = [[t.cpu() for t in leaves] for leaves in ends]
        else:
            report["tp_vs_replicated"] = _tp_vs_replicated(
                torch, ends[1], ref[1])
            report["tp_vs_replicated_p1_delta"] = _tp_vs_replicated(
                torch, ends[0], ref[0], base)
            report["tp_vs_replicated_delta"] = _tp_vs_replicated(
                torch, ends[1], ref[1], base)
        del res, phases, ends
        torch.cuda.empty_cache()
    if control:
        sound = tpl.TPContext.partial
        tpl.TPContext.partial = lambda self, path: \
            sound(self, path) or path.endswith("/router/w")
        try:
            res, phases, got = run(cut, mesh, "fsdp_tp", init, 1,
                                   fl_rounds=0)
        finally:
            tpl.TPContext.partial = sound
        report["control"] = got
        if rank == 0:
            report["control_vs_replicated_p1_delta"] = _tp_vs_replicated(
                torch, tree_leaves(res.params), ref[0], base)
        del res, phases
    del init, base, ref
    torch.cuda.empty_cache()

    # (b) the whole model on (1, 4): one whole tree on the card at a time
    mesh = make_mesh(MOE_FULL_MESH, ("data", "model"), "cuda:0")
    fops = pod.PodFLConfig(mesh, rounds=1, clients_per_round=SHARDED_K,
                           spec=spec, layout="fsdp_tp").strategy().flat_ops(
                               lm_task(cfg), mesh.device)
    rows = None
    for r in range(world):
        if r == rank:
            t0 = time.perf_counter()
            tree = init_lm(cfg, SEED, "cuda")
            rows = FlatRows(fops.flatten(tree), fops.flatten_frozen(tree))
            del tree
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            init_s = time.perf_counter() - t0
        dist.barrier()
    frozen0 = {n: t.cpu() for n, t in rows.frozen.items()}
    trained0 = {n: t.clone() for n, t in rows.params.items()}
    res, phases, got = run(cfg, mesh, "fsdp_tp", rows, 0)
    end = res.params
    # each layer's router row moved (the slot of the stacked leaf in the
    # rank's rows); every frozen row bitwise its init
    moved = []
    for path, slot in zip(_tree_paths_of(fops), fops.view.slots):
        if path.endswith("router/w"):
            a, b = (t[slot.buffer][slot.offset:slot.offset + slot.size]
                    .reshape(slot.shape) for t in (trained0, end.params))
            moved.append([bool((x != y).any()) for x, y in zip(a, b)])
    kept = True
    for n, t in end.frozen.items():
        for lo in range(0, t.numel(), 1 << 28):
            kept &= bool(torch.equal(t[lo:lo + (1 << 28)].cpu(),
                                     frozen0[n][lo:lo + (1 << 28)]))
    got.update(init_s=init_s, routers_moved=moved, frozen_kept=kept,
               rows={n: t.numel() for n, t in end.params.items()},
               frozen_rows={n: t.numel() for n, t in end.frozen.items()})
    report["full"] = got
    del res, phases, end, rows, frozen0, trained0
    torch.cuda.empty_cache()
    Path(out, f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _tree_paths_of(fops):
    """The leaf paths of a flat view's tree, in its slots' order."""
    from repro_torch.utils.tree_math import tree_paths, tree_unflatten
    return tree_paths(tree_unflatten(fops.view.treedef,
                                     [0] * len(fops.view.slots)))


def moe_sharded_views():
    """The views of pod_sharded_moe's runs on a static mesh: (a) the cut
    under each layout, P1 (the whole model) and P2 (the MOE_FILTER
    slice); (b) the whole model's P2 under fsdp_tp on (1, 4)."""
    import dataclasses
    from repro_torch.fl.task import lm_task
    from repro_torch.sharding import rules
    cfg = moe_setup_config()
    cut = lm_task(dataclasses.replace(cfg, n_layers=MOE_CUT_LAYERS)).shapes()
    mesh = _StaticMesh(MOE_SHARDED_MESH)
    views = {(layout, ph): rules.sharded_flat_view(
        cut, mesh, layout, MOE_FILTER if ph == "P2" else None)
        for layout in MOE_SHARDED_LAYOUTS for ph in ("P1", "P2")}
    views["full"] = rules.sharded_flat_view(
        lm_task(cfg).shapes(), _StaticMesh(MOE_FULL_MESH), "fsdp_tp",
        MOE_FILTER)
    return views


def pod_sharded_moe(torch, control: bool = False) -> dict:
    """Phase pod_sharded_moe: expert parallelism and MLA's heads over
    ``model``, and each MoE layer's capacity global over the batch
    group, on four ranks of one card (``pod_sharded_moe_worker``: gloo
    over a ``file://`` store under TMPDIR, four processes on cuda:0).
    Gates, (a) the 3-layer cut on (2, 2): fsdp_tp computed with the
    experts and heads split in both phases on every rank (``tp_compute``,
    "tp" > 0) and replicated did not, both dispatched over data ("moe"
    > 0); fsdp_tp's losses within MOE_SHARDED_LOSS_RTOL and its params
    within MOE_SHARDED_TP_TOL of replicated's, its P1 changes from the
    init within MOE_SHARDED_DELTA_TOL (L2) of replicated's, and with
    ``control`` (``--pod-sharded-moe-control``) the control's beyond it; each rank's resident
    frozen rows in P2 (the experts among them) the fsdp_tp view's
    per-shard sizes; K1, K6 and K3 launched once per bucket, step,
    client and round; P2 kept every frozen leaf; pairs dropped.  (b)
    the whole model on (1, 4): finite losses, tp_compute, every router
    moved (each layer), every frozen row bitwise, each rank's rows the
    view's per-shard sizes.
    The collectives against lower_pod_round are dryrun_check (b)'s.
    Reported: dropped pairs per layer, ms a step, peak memory a rank,
    bytes gathered and all-reduced ("tp", "moe") a step, the card.
    Returns rank 0's fsdp_tp launches of (a) (the kernel rows'
    launches) and every rank's report."""
    import pickle
    import tempfile
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, data, _ = moe_setup()
    views = moe_sharded_views()
    tmp = tempfile.mkdtemp(prefix="pod_sharded_moe_")
    Path(tmp, "data.pkl").write_bytes(pickle.dumps((cfg, data, control)))
    store = os.path.join(tmp, "store")
    world = math.prod(MOE_SHARDED_MESH)
    # four processes share the card: expandable segments keep each
    # one's freed blocks from pinning memory the others need
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    ranks = _run_ranks("pod_sharded_moe", "--pod-sharded-moe-rank", world,
                       store, tmp, env)
    steps = SHARDED_K * SHARDED_STEPS

    def want(layout):
        n1 = len(views[(layout, "P1")].trainable_groups)
        n2 = len(views[(layout, "P2")].trainable_groups)
        return dict(local_step=steps * (n1 + n2),
                    delta_accum=SHARDED_K * n2, server_update=n2)

    def nbytes(groups, whole=False):
        from repro_torch.utils.flatten import torch_dtype
        return sum(g.size * (g.n_shards if whole else 1) *
                   torch_dtype(g.name).itemsize for g in groups)
    frozen_rows = nbytes(views[("fsdp_tp", "P2")].frozen_groups)
    frozen_whole = nbytes(views[("replicated", "P2")].frozen_groups, True)
    full = views["full"]
    want_full = dict(local_step=steps * len(full.trainable_groups),
                     delta_accum=SHARDED_K * len(full.trainable_groups),
                     server_update=len(full.trainable_groups))
    bad = []
    for rk in ranks:
        r = rk["rank"]
        for layout in MOE_SHARDED_LAYOUTS:
            got, tp_on = rk[layout], layout == "fsdp_tp"
            if got["launches"] != want(layout):
                bad.append(f"rank {r} {layout} launches {got['launches']} "
                           f"!= {want(layout)}")
            if got["tp_compute"] != [tp_on] * 2 or \
                    (got["collectives"]["tp"] > 0) != tp_on or \
                    got["collectives"]["moe"] <= 0:
                bad.append(f"rank {r} {layout}: tp_compute "
                           f"{got['tp_compute']}, collectives "
                           f"{got['collectives']}")
            if not (got["frozen_kept_by_p2"] and all(
                    math.isfinite(x) for x in got["losses"])):
                bad.append(f"rank {r} {layout}: frozen leaves changed or "
                           f"losses {got['losses']}")
        tp_run, rep = rk["fsdp_tp"], rk["replicated"]
        if (tp_run["resident"][1]["frozen"], rep["resident"][1]["frozen"]) \
                != (frozen_rows, frozen_whole):
            bad.append(f"rank {r} frozen bytes {tp_run['resident'][1]} / "
                       f"{rep['resident'][1]}")
        if not all(math.isclose(a, b, rel_tol=MOE_SHARDED_LOSS_RTOL,
                                abs_tol=0.0)
                   for a, b in zip(tp_run["losses"], rep["losses"])):
            bad.append(f"rank {r}: fsdp_tp losses {tp_run['losses']} "
                       f"against {rep['losses']}")
        fr = rk["full"]
        if not (fr["tp_compute"] == [True] and fr["frozen_kept"] and
                all(math.isfinite(x) for x in fr["losses"]) and
                fr["routers_moved"] and all(all(m) for m in
                                            fr["routers_moved"]) and
                fr["launches"] == want_full and
                fr["frozen_rows"] == full.local_view().frozen_sizes and
                fr["rows"] == full.local_view().buffer_sizes):
            bad.append(f"rank {r} (1, 4): tp_compute {fr['tp_compute']}, "
                       f"frozen kept {fr['frozen_kept']}, losses "
                       f"{fr['losses']}, routers {fr['routers_moved']}, "
                       f"launches {fr['launches']} != {want_full}, rows "
                       f"{fr['rows']} / {fr['frozen_rows']}")
    # the params, whole and alike on every rank: rank 0's comparisons
    close, moved = (ranks[0][k] for k in ("tp_vs_replicated",
                                           "tp_vs_replicated_p1_delta"))
    if not (close["dtypes_equal"] and close["rel"] <= MOE_SHARDED_TP_TOL):
        bad.append(f"fsdp_tp params off the replicated run's: {close}")
    if not moved["l2"] <= MOE_SHARDED_DELTA_TOL:
        bad.append(f"fsdp_tp's P1 changes off the replicated run's: {moved}")
    readings = dict(
        loss_gap=max(abs(a / b - 1) for a, b in zip(
            ranks[0]["fsdp_tp"]["losses"], ranks[0]["replicated"]["losses"])),
        rel=close["rel"], p1_delta_l2=moved["l2"], p1_delta_rel=moved["rel"],
        delta_l2=ranks[0]["tp_vs_replicated_delta"]["l2"])
    if control:
        ctl = ranks[0]["control_vs_replicated_p1_delta"]
        readings.update(
            control_loss_gap=abs(ranks[0]["control"]["losses"][0] /
                                 ranks[0]["replicated"]["losses"][0] - 1),
            control_p1_delta_l2=ctl["l2"], control_p1_delta_rel=ctl["rel"])
        for rk in ranks:
            if not (rk["control"]["tp_compute"] == [True] and all(
                    math.isfinite(x) for x in rk["control"]["losses"])):
                bad.append(f"rank {rk['rank']} control: {rk['control']}")
        if not ctl["l2"] > MOE_SHARDED_DELTA_TOL:
            bad.append(f"the control passed the P1 changes' gate: {ctl}")
    # a layer's drops over the batch: the ranks of one model coordinate
    batch_ranks = ranks[::MOE_SHARDED_MESH[1]]
    dropped = {layout: [sum(d) for d in zip(*(
        rk[layout]["drops"]["dropped"] for rk in batch_ranks))]
        for layout in MOE_SHARDED_LAYOUTS}
    if not all(sum(d) > 0 for d in dropped.values()):
        bad.append(f"no pair dropped: {dropped}")
    emit(dict(phase="pod_sharded_moe", part="cut",
              model=f"deepseek-v2-lite-16b + {MOE_PEFT}, "
                    f"{MOE_CUT_LAYERS} layers", trainable_filter=MOE_FILTER,
              mesh=dict(zip(("data", "model"), MOE_SHARDED_MESH)),
              backend="gloo, four processes on cuda:0",
              rounds={"P1": f"1 x 2 clients x {SHARDED_STEPS} steps",
                      "P2": f"1 x 2 clients x {SHARDED_STEPS} steps"},
              batch=SHARDED_BATCH, seq=128,
              dropped_per_layer=dropped,
              per_step={layout: dict(
                  ms=[rk[layout]["ms_per_step"] for rk in ranks],
                  bytes=ranks[0][layout]["bytes_per_step"],
                  peak_memory_bytes=[rk[layout]["peak_memory_bytes"]
                                     for rk in ranks])
                  for layout in MOE_SHARDED_LAYOUTS},
              frozen_bytes_per_rank={"fsdp_tp": frozen_rows,
                                     "replicated": frozen_whole},
              expected_launches={layout: want(layout)
                                 for layout in MOE_SHARDED_LAYOUTS},
              tp_tol=MOE_SHARDED_TP_TOL, loss_rtol=MOE_SHARDED_LOSS_RTOL,
              delta_tol=MOE_SHARDED_DELTA_TOL, readings=readings,
              ranks=[{k: v for k, v in rk.items() if k != "full"}
                     for rk in ranks], card=nvidia_smi()))
    emit(dict(phase="pod_sharded_moe", part="full",
              model=f"deepseek-v2-lite-16b + {MOE_PEFT}",
              mesh=dict(zip(("data", "model"), MOE_FULL_MESH)),
              rounds={"P2": f"1 x 2 clients x {SHARDED_STEPS} steps"},
              batch=SHARDED_BATCH,
              seq=128, rows=full.local_view().buffer_sizes,
              frozen_rows=full.local_view().frozen_sizes,
              expected_launches=want_full,
              ms_per_step=[rk["full"]["ms_per_step"] for rk in ranks],
              peak_memory_bytes=[rk["full"]["peak_memory_bytes"]
                                 for rk in ranks],
              bytes_per_step=ranks[0]["full"]["bytes_per_step"],
              ranks=[rk["full"] for rk in ranks], card=nvidia_smi(),
              phase_s=time.perf_counter() - t_phase))
    if bad:
        raise SystemExit("chip_smoke: pod_sharded_moe: " + "; ".join(bad))
    return ranks[0]["fsdp_tp"]["launches"], ranks


def moe_setup_config():
    """``moe_setup``'s model config without its data."""
    from repro_torch.configs import get_config, with_peft
    return with_peft(get_config("deepseek-v2-lite-16b"), MOE_PEFT)


def check_sharded_moe_kernels(torch, bench) -> dict:
    """Phase 2 at pod_sharded_moe's per-shard rows of the cut under
    fsdp_tp (returned, bitwise against their plain versions): K1 (clip
    1, no decay, no momentum), K6 with p and K3's apply ("none") at each
    of P2's rows (the f32 routers, the adapters over data and over
    model, bf16), and K1 over P1's largest row (the base over data +
    model, three trials of three calls)."""
    from repro_torch.utils.flatten import torch_dtype
    views = moe_sharded_views()
    out = {}
    for g in views[("fsdp_tp", "P2")].trainable_groups:
        dt, n, tag = torch_dtype(g.name), padded(g.size), \
            g.name.replace("@", "_").replace("+", "_")
        out[f"local_step_{tag}"] = bench.local_step(n, dt, False, False,
                                                    wd=0.0, clip=1.0)
        out[f"delta_accum_{tag}"] = bench.delta_accum(n, dt, True)
        out[f"server_update_{tag}"] = bench.server_update(n, "none",
                                                          dtype=dt)
    top = max(views[("fsdp_tp", "P1")].trainable_groups, key=lambda g: g.size)
    bench.trials, bench.reps = 3, 3
    out["local_step_p1"] = bench.local_step(
        padded(top.size), torch_dtype(top.name), False, False, wd=0.0,
        clip=1.0)
    bench.trials, bench.reps = 5, 20
    torch.cuda.empty_cache()
    for r in out.values():
        emit(dict(phase="kernel", path="pod_sharded_moe", **r))
    bad = [k for k, r in out.items()
           if not (r["max_abs_err"] <= KERNEL_TOL and r.get("bitwise", True))]
    if bad:
        raise SystemExit(f"chip_smoke: kernels at pod_sharded_moe's rows "
                         f"disagree with their plain versions: {bad}")
    return out


# pod_sharded_zoo: tensor parallelism over model for the SSM, hybrid, VLM
# and audio zoo on four gloo ranks of one card.  (a) hymba-1.5b + lora:8
# at full width and depth on (2, 2): 25 SSM heads a rank, the MLP's
# columns halved, the attention whole (25 heads); P1 1 x 2 x 2 then P2
# 1 x 2 x 2 at batch 8 x 128 under fsdp_tp and replicated, then one
# FedProx P2 round (mu ZOO_PROX_MU) under both; (b) mamba2-1.3b at full
# width and depth on (1, 4), serving in f32: 16 SSM heads and a quarter
# of the vocabulary a rank, K8 on the rank's heads, against the whole
# tree served by one process; (c) internvl2-1b and musicgen-medium cut to
# ZOO_STEP_LAYERS layers at full width on (2, 2), f32: make_train_step
# on the model-local tree against the whole tree's, and the prefill on
# the split heads through K7
ZOO_MESH, ZOO_SERVE_MESH = (2, 2), (1, 4)
ZOO_ARCH, ZOO_PEFT, ZOO_PROX_MU = "hymba-1.5b", "lora:8", 0.01
ZOO_STEPS = 2           # SGD steps a client in (a)
ZOO_LAYOUTS = ("fsdp_tp", "replicated")
ZOO_SERVE_ARCH, ZOO_SERVE_B, ZOO_SERVE_S, ZOO_SERVE_NEW = \
    "mamba2-1.3b", 2, 1024, 8
# (arch, patch embeddings, text tokens or frames); hymba-1.5b's cut also
# runs the control: the gated norm's sum of squares through
# reduce_from_model, an identity backward
ZOO_STEP_ARCHS = (("internvl2-1b", 256, 128), ("musicgen-medium", 0, 128),
                  ("hymba-1.5b", 0, 128))
ZOO_STEP_LAYERS, ZOO_STEP_B, ZOO_STEP_LR = 2, 4, 1e-2
# (a)'s gates, fsdp_tp against replicated in bf16 (pod_sharded_moe's
# measures): the losses; a leaf's largest gap over its largest magnitude
# at P2's end and at the FedProx round's; P1's changes from the init, a
# leaf's L2 gap over its change's L2 norm.  In bf16 through 32 layers
# they bound drift and an unchanged leaf (which reads 1.0 on both
# measures of a leaf) only: an H100 read 3.1e-4, 0.291 (a LoRA leaf),
# 0.134 and 0.670, and a control with the gated norm's backward left out
# read 0.672, as the sound run (PERF.md)
ZOO_LOSS_RTOL = 1e-3
ZOO_TP_TOL = 0.6
ZOO_DELTA_TOL = 0.85
# (a)'s cut: the same runs of hymba-1.5b + lora:8 at full width, cut to
# ZOO_CUT_LAYERS layers, in f32, and the control (fsdp_tp's P1 with the
# gated norm's sum of squares through reduce_from_model).  The gates on
# the same measures, the P1 changes' placed between the sound runs' and
# the control's readings (PERF.md): the control must exceed it
ZOO_CUT_LAYERS = 2
ZOO_CUT_LOSS_RTOL = 1e-4
ZOO_CUT_TP_TOL = 1e-3
ZOO_CUT_DELTA_TOL = 1e-2
# the four ranks' time, all three parts (an H100 took 291 s for the
# phase, PERF.md): a rank still running then is ended
ZOO_RANKS_TIMEOUT = 480.0
# (b), f32: the TP logits against the whole tree's, the largest gap over
# the largest magnitude of a step's logits, and the SSM state's (in_proj's
# columns, the norm over model and out_proj's rows sum in other orders).
# The same weights in bf16 are read, not gated: on an H100 (PERF.md)
# the logits after the prefill were 7.2% off the whole f32 tree's
# model-local and 6.8% whole, the greedy tokens other in both: bf16
# rounding, not the split
ZOO_SERVE_TOL = 1e-3
# (c), f32: each gradient leaf's and the two-step params' largest gap
# over the leaf's largest magnitude, and the losses (the CPU tests read
# ~1e-6); the prefill's logits through K7 (online softmax)
ZOO_STEP_TOL = 1e-4
ZOO_PREFILL_TOL = 1e-4


def _note(rank: int, what: str) -> None:
    """A rank's progress, with the seconds since its process started, in
    its log (``_run_ranks`` shows the log's end if the phase fails)."""
    print(f"rank {rank} {time.perf_counter() - _T0:.1f} s: {what}",
          file=sys.stderr, flush=True)


def _free_leftovers(torch) -> None:
    """Free what the last run left: tensors held only by reference cycles
    (the engine's closures), the card's cached blocks, and the cached
    pinned host blocks through which gloo moved CUDA tensors (each run's
    collectives have other sizes; four ranks' caches of whole-model
    blocks would not fit the host's memory, nor four ranks' leftovers
    the card's)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    release = getattr(torch._C, "_host_emptyCache", None)
    if release is not None:
        release()


class _CardLeaves(list):
    """Host leaves that ``_tp_vs_replicated`` reads one at a time on the
    card (a whole model's comparison on the host's cores takes minutes)."""

    def __getitem__(self, i):
        return list.__getitem__(self, i).cuda()

    def __iter__(self):
        return (t.cuda() for t in list.__iter__(self))


def _zoo_hymba(torch, rank, data, report):
    """pod_sharded_zoo (a) in one rank: see ``pod_sharded_zoo_worker``.
    The whole model in bf16, then the f32 cut with its control under
    ``report["cut"]``."""
    import dataclasses
    from repro_torch.configs import get_config, with_peft
    _zoo_pod_runs(torch, rank, data, with_peft(get_config(ZOO_ARCH),
                                               ZOO_PEFT), False, report)
    report["cut"] = {}
    t0 = time.perf_counter()
    _zoo_pod_runs(torch, rank, data, with_peft(dataclasses.replace(
        get_config(ZOO_ARCH), n_layers=ZOO_CUT_LAYERS, dtype=torch.float32,
        param_dtype=torch.float32), ZOO_PEFT), True, report["cut"])
    report["cut_s"] = time.perf_counter() - t0


def _zoo_pod_runs(torch, rank, data, cfg, control, report):
    """(a)'s runs of ``cfg`` under each layout, P1 + P2 then FedProx; with
    ``control``, fsdp_tp's P1 again with the gated norm's sum of squares
    through ``reduce_from_model`` (an identity backward)."""
    import torch.distributed as dist
    from repro_torch.fl import pod
    from repro_torch.fl.engine import FlatRows
    from repro_torch.fl.task import lm_task
    from repro_torch.kernels import fused_update as fu
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (PodFLSpec, relay_spec,
                                          run_pod_training)
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import rules
    from repro_torch.sharding import tensor_parallel as tpl
    from repro_torch.utils.tree_math import tree_leaves

    task = lm_task(cfg)
    mask = rules.trainable_mask(task.shapes(), "lora")
    mesh = make_mesh(ZOO_MESH, ("data", "model"), "cuda:0")
    steps = SHARDED_K * ZOO_STEPS
    t0 = time.perf_counter()
    # rank 0 alone keeps host copies (the init, the replicated run's
    # ends) to compare; each run starts from the rows of an init drawn
    # anew on the card and ends with its rows (engine.FlatRows), so that
    # no rank holds a whole tree through a run: four ranks' whole trees
    # and gathers did not fit the card
    base = [t.cpu() for t in tree_leaves(init_lm(cfg, SEED, "cuda"))] \
        if rank == 0 else None
    torch.cuda.empty_cache()
    report["setup_s"] = time.perf_counter() - t0

    def spec(**kw):
        return PodFLSpec(local_steps=ZOO_STEPS, batch_size=SHARDED_BATCH,
                         lr=0.03, update_impl="fused", peft=ZOO_PEFT, **kw)

    def ops(layout, phase, sp):
        conf = (pod.PodCyclicConfig(mesh, rounds=1, spec=relay_spec(sp),
                                    clients_per_round=SHARDED_K,
                                    layout=layout) if phase == "P1" else
                pod.PodFLConfig(mesh, rounds=1, spec=sp,
                                clients_per_round=SHARDED_K, layout=layout))
        return conf.strategy().flat_ops(task, mesh.device)

    def rows(fops, tree):
        """The rank's rows of ``tree``, on the host: the run copies them
        to the card (a copy on the card beside the run's own would not
        fit four replicated ranks)."""
        def host(bufs):
            return {n: t.cpu() for n, t in bufs.items()}
        return FlatRows(host(fops.flatten(tree)),
                        host(fops.flatten_frozen(tree))
                        if fops.view.frozen_sizes else None)

    def run(layout, phases, sp, start=None):
        """``phases`` ("P1", then "P2", or one of them) from ``start``
        (a whole tree; the init when None), each through
        ``run_pod_training`` from and to rows; the whole tree after each
        phase is gathered as the engine's result gather does.  Returns
        the whole ends and the report."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pod.reset_collective_counts()
        fu.reset_launch_counts()
        tree = start if start is not None else init_lm(cfg, SEED, "cuda")
        got = dict(run_s=0.0, tp_compute=[], resident=[], losses=[])
        ends = []
        for phase in phases:
            fops = ops(layout, phase, sp)
            r = rows(fops, tree)
            del tree
            _free_leftovers(torch)
            dist.barrier()
            t0 = time.perf_counter()
            res = run_pod_training(
                cfg, data, cyclic_rounds=int(phase == "P1"),
                fl_rounds=int(phase == "P2"), clients_per_round=SHARDED_K,
                spec=sp, mesh=mesh, seed=SEED, layout=layout,
                init_params=r)
            torch.cuda.synchronize()
            got["run_s"] += time.perf_counter() - t0
            ph = res.schedule.phases[-1].result
            got["tp_compute"].append(ph.tp_compute)
            got["resident"].append(ph.resident_bytes)
            got["losses"] += [h["loss"] for h in res.history]
            _note(rank, f"{cfg.n_layers} layers {layout} {phase}: "
                  f"{got['losses']}")
            end = res.params
            del r, res, ph
            # the four ranks' leftovers back to the card before the whole
            # tree is gathered
            _free_leftovers(torch)
            with torch.no_grad():
                tree = fops.unflatten(end.params, end.frozen)
            del end
            ends.append([t.cpu() for t in tree_leaves(tree)]
                        if rank == 0 else None)
        del tree
        if rank == 0 and "P2" in phases:
            # P2 kept every frozen leaf of its start (P1's end, or the
            # init): the whole trees hold every rank's rows
            got["frozen_kept"] = all(torch.equal(a, b) for a, b, m in zip(
                ends[-1], ends[-2] if len(ends) == 2 else base, mask)
                if not m)
        n_steps = len(phases) * steps
        got.update(
            ms_per_step=got["run_s"] * 1e3 / n_steps,
            collectives=dict(pod.COLLECTIVES),
            collective_bytes=dict(pod.COLLECTIVE_BYTES),
            bytes_per_step={k: pod.COLLECTIVE_BYTES[k] / n_steps
                            for k in ("gather", "tp", "grad")},
            launches={k: fn.launches for k, fn in (
                ("local_step", fu.local_step),
                ("delta_accum", fu.delta_accum),
                ("server_update", fu.server_update))},
            peak_memory_bytes=torch.cuda.max_memory_allocated())
        _free_leftovers(torch)
        return ends, got

    def compare(a, b, start=None):
        """fsdp_tp's host leaves ``a`` against replicated's ``b`` on the
        card, its blocks given back before the next run."""
        out = _tp_vs_replicated(torch, _CardLeaves(a), b, start)
        _free_leftovers(torch)
        return out

    ref = None
    for layout in ("replicated", "fsdp_tp"):
        ends, report[layout] = run(layout, ("P1", "P2"), spec())
        if rank == 0 and ref is None:
            ref = ends
        elif rank == 0:
            report["tp_vs_replicated"] = compare(ends[1], ref[1])
            report["tp_vs_replicated_p1_delta"] = compare(ends[0], ref[0],
                                                          base)
        del ends
    prox_ref = None
    for layout in ("replicated", "fsdp_tp"):
        ends, report[f"fedprox_{layout}"] = run(
            layout, ("P2",), spec(algorithm="fedprox", mu=ZOO_PROX_MU))
        if rank == 0 and prox_ref is None:
            prox_ref = ends
        elif rank == 0:
            report["fedprox_tp_vs_replicated"] = compare(ends[0],
                                                         prox_ref[0])
        del ends
    if control:
        sound = tpl.sum_over_model
        tpl.sum_over_model = tpl.reduce_from_model
        try:
            ends, report["control"] = run("fsdp_tp", ("P1",), spec())
        finally:
            tpl.sum_over_model = sound
        if rank == 0:
            report["control_vs_replicated_p1_delta"] = compare(
                ends[0], ref[0], base)
        del ends
    del base, ref, prox_ref
    _free_leftovers(torch)


def _zoo_serve(torch, rank, report):
    """pod_sharded_zoo (b) in one rank: see ``pod_sharded_zoo_worker``."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.fl import pod
    from repro_torch.fl.task import lm_task
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.ssm import local_ssm_state
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    from repro_torch.utils.tree_math import tree_map

    cfg = dataclasses.replace(get_config(ZOO_SERVE_ARCH), ssd_impl="pallas",
                              dtype=torch.float32, param_dtype=torch.float32)
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    mesh = make_mesh(ZOO_SERVE_MESH, ("data", "model"), "cuda:0")
    params = init_lm(cfg, SEED, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size,
                                      (ZOO_SERVE_B, ZOO_SERVE_S),
                                      generator=gen, device="cuda")}
    T = ZOO_SERVE_S + ZOO_SERVE_NEW

    def local(c, tree):
        """The rank's model-local tree of ``tree`` under ``c``."""
        fops = pod._sharded_flat_ops(lm_task(c), mesh, "fsdp_tp", False)
        with torch.no_grad():
            return fops.tp_tree(fops.flatten(tree))

    def generate(tree, c, tp, new=ZOO_SERVE_NEW):
        """A prefill and ``new`` greedy decode steps: the tokens, each
        step's logits, the SSM state after the prefill, the seconds and
        the K8 launches of the prefill."""
        with torch.no_grad():
            torch.cuda.synchronize()
            k8 = ssd.ssd_scan.launches
            t0 = time.perf_counter()
            logits, cache, S = prefill(tree, c, prompt, T, tp=tp)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            k8 = ssd.ssd_scan.launches - k8
            state = [t.clone() for t in cache["scan"]["ssm"]]
            steps, toks = [logits.float()], []
            t0 = time.perf_counter()
            for i in range(new):
                tok = torch.argmax(logits[:, -1:], dim=-1)
                toks.append(tok)
                logits, cache = decode_step(tree, c, tok, cache, S + i,
                                            tp=tp)
                steps.append(logits.float())
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        return (torch.cat(toks, dim=1), steps, state, prefill_s,
                decode_s, k8)

    def rel(xs, ys):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(xs, ys)]

    tree = local(cfg, params)
    tp = tree.tp
    # a warm-up (a prefill and one decode step) before the timed run
    dist.barrier()
    generate(tree, cfg, tp, new=1)
    pod.reset_collective_counts()
    ssd.ssd_scan.launches = 0
    dist.barrier()
    toks, logits, state, prefill_s, decode_s, k8 = generate(tree, cfg, tp)
    _note(rank, f"(b) f32 model-local: prefill {prefill_s:.2f} s")
    got = dict(prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=decode_s * 1e3 / ZOO_SERVE_NEW,
               ssd_launches_per_prefill=k8,
               ssd_launches=ssd.ssd_scan.launches, ssm_heads=tp.ssm_range[1],
               vocab_cols=tp.vocab_range[1],
               tp_plan=dataclasses.asdict(tp.plan),
               collectives=dict(pod.COLLECTIVES),
               collective_bytes=dict(pod.COLLECTIVE_BYTES),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del tree
    torch.cuda.empty_cache()
    # the whole tree served by one process at a time (the others wait)
    for r in range(math.prod(ZOO_SERVE_MESH)):
        if r == rank:
            w_toks, w_logits, w_state, w_pre, w_dec, w_k8 = generate(
                params, cfg, None)
        dist.barrier()
    mine = local_ssm_state(w_state, cfg.ssm_cfg(), tp)
    got.update(
        whole_prefill_ms=w_pre * 1e3,
        whole_decode_ms_per_step=w_dec * 1e3 / ZOO_SERVE_NEW,
        whole_ssd_launches_per_prefill=w_k8,
        tokens_equal=bool(torch.equal(toks, w_toks)),
        tokens=toks.tolist(), whole_tokens=w_toks.tolist(),
        logits_rel=rel(logits, w_logits),
        state_rel=[float((a.float() - b.float()).abs().max() /
                         b.float().abs().max()) for a, b in zip(state, mine)],
        state_shapes=[list(t.shape) for t in state])
    del w_state, mine, state
    _note(rank, "(b) f32 whole")
    # bf16 against f32, read not gated: the same weights in a bf16
    # model's dtypes (the SSM's A_log, D and dt_bias stay f32), the
    # model-local tree on every rank, then the whole tree on rank 0, each
    # step's logits against the whole f32 tree's
    params = tree_map(lambda t, m: t.to(m.dtype), params,
                      lm_task(bf16).shapes())
    tree = local(bf16, params)
    dist.barrier()
    b_toks, b_logits, _, b_pre, _, _ = generate(tree, bf16, tree.tp)
    del tree
    got.update(bf16_tp_logits_rel=rel(b_logits, w_logits),
               bf16_tp_tokens_equal=bool(torch.equal(b_toks, w_toks)),
               bf16_tp_prefill_ms=b_pre * 1e3)
    if rank == 0:
        b_toks, b_logits, _, _, _, _ = generate(params, bf16, None)
        got.update(bf16_whole_logits_rel=rel(b_logits, w_logits),
                   bf16_whole_tokens_equal=bool(torch.equal(b_toks, w_toks)))
    dist.barrier()
    report["serve"] = got
    del params
    _free_leftovers(torch)


def _zoo_steps(torch, rank, report):
    """pod_sharded_zoo (c) in one rank: see ``pod_sharded_zoo_worker``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.fl import pod
    from repro_torch.fl.task import lm_task
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_lm, prefill
    from repro_torch.sharding import tensor_parallel as tpl
    from repro_torch.utils import tree_math as tm

    mesh = make_mesh(ZOO_MESH, ("data", "model"), "cuda:0")
    out = {}
    for arch, n_patch, n_text in ZOO_STEP_ARCHS:
        cfg = dataclasses.replace(
            get_config(arch), n_layers=ZOO_STEP_LAYERS, dtype=torch.float32,
            param_dtype=torch.float32)
        fops = pod._sharded_flat_ops(lm_task(cfg), mesh, "fsdp_tp", False)
        params = init_lm(cfg, SEED, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        B = ZOO_STEP_B

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        def ints(hi, *shape):
            return torch.randint(0, hi, shape, generator=gen, device="cuda")
        if cfg.input_mode == "vlm":
            batch = {"patch_embeds": randn(B, n_patch, cfg.d_model),
                     "tokens": ints(cfg.vocab_size, B, n_text),
                     "labels": ints(cfg.vocab_size, B, n_text)}
        elif cfg.input_mode == "embeddings":
            batch = {"frame_embeds": randn(B, n_text, cfg.d_model),
                     "labels": ints(cfg.vocab_size, B, n_text,
                                    cfg.n_codebooks)}
        else:
            batch = {"tokens": ints(cfg.vocab_size, B, n_text),
                     "labels": ints(cfg.vocab_size, B, n_text)}

        def local(tree):
            with torch.no_grad():
                return fops.tp_tree(fops.flatten(tree))

        def gap(got, want):
            return max(float((a - b).abs().max() / b.abs().max().clamp(
                min=1e-30)) for a, b in zip(tm.tree_leaves(got),
                                            tm.tree_leaves(want)))
        tree = local(params)
        _, treedef = tm.tree_flatten(params)
        pod.reset_collective_counts()
        lt, gt = steps._value_and_grad(cfg, tree, batch)
        tp_count = pod.COLLECTIVES["tp"]
        lw, gw = steps._value_and_grad(cfg, params, batch)
        want = local(tm.tree_unflatten(treedef, gw))
        grad = gap(tm.tree_unflatten(treedef, gt), want)
        control = None
        if cfg.has_ssm:     # the gated norm's backward left out
            sound = tpl.sum_over_model
            tpl.sum_over_model = tpl.reduce_from_model
            try:
                _, gc = steps._value_and_grad(cfg, tree, batch)
            finally:
                tpl.sum_over_model = sound
            control = gap(tm.tree_unflatten(treedef, gc), want)
            del gc
        del gt, gw, want
        step = steps.make_train_step(cfg, steps.TrainSpec(lr=ZOO_STEP_LR))
        pw, mw = params, steps.init_momentum(params)
        pt, mt = tree, steps.init_momentum(tree)
        losses = []
        for _ in range(2):
            pw, mw, a = step(pw, mw, batch)
            pt, mt, b = step(pt, mt, batch)
            losses.append([float(b["loss"]), float(a["loss"])])
        par = gap(pt, local(pw))
        del pw, mw, pt, mt
        # the prefill on the split heads through K7, against the whole
        # tree's through K7
        kcfg = dataclasses.replace(cfg, attn_impl="pallas")
        pre = {k: v for k, v in batch.items() if k != "labels"}
        with torch.no_grad():
            lw_, _, _ = prefill(params, kcfg, pre, n_patch + n_text)
            fa.flash_attention.launches = 0
            lt_, _, _ = prefill(tree, kcfg, pre, n_patch + n_text,
                                tp=tree.tp)
            k7 = fa.flash_attention.launches
        out[arch] = dict(
            first_loss=[float(lt), float(lw)], losses=losses, grad=grad,
            params=par, control_grad=control, tp=tp_count,
            tp_plan=dataclasses.asdict(tree.tp.plan),
            heads=tree.tp.heads if tree.tp.plan.attn else cfg.n_heads,
            kv_heads=tree.tp.kv_range[1] if tree.tp.plan.attn
            else cfg.n_kv_heads,
            prefill_rel=float((lt_ - lw_).abs().max() / lw_.abs().max()),
            k7_launches_per_prefill=k7)
        del params, tree, lt_, lw_
        _free_leftovers(torch)
    report["steps"] = out


def pod_sharded_zoo_worker(rank: int, store: str, out: str) -> int:
    """One rank of ``pod_sharded_zoo`` (``chip_smoke.py
    --pod-sharded-zoo-rank R STORE OUT``): joins the four-rank gloo group
    over the ``file://`` store on cuda:0 and reads the parent's
    ``llm_setup`` data (vocab 32,000: hymba-1.5b's 32,001 words hold
    them) from ``OUT/data.pkl``.  (a) on ZOO_MESH, hymba-1.5b + lora:8
    from one seeded init (drawn anew on the card for each run) through
    ``run_pod_training`` under replicated, then fsdp_tp: P1 1 x 2 x 2
    relaying the whole model, then P2 1 x 2 x 2 on the adapters, batch
    8, lr 0.03; then FedProx P2 1 x 2 x 2 (mu ZOO_PROX_MU) from the init
    under both; then the same runs of the f32 cut to ZOO_CUT_LAYERS
    layers, and its control: fsdp_tp's P1 again with the gated norm's
    sum of squares through ``reduce_from_model``.  (b) on
    ZOO_SERVE_MESH, mamba2-1.3b in f32 with ssd_impl "pallas": the rank's
    model-local tree serves ZOO_SERVE_B x ZOO_SERVE_S + ZOO_SERVE_NEW
    greedy tokens (K8 on its 16 heads) after a warm-up, then each rank
    in turn serves the whole tree alone; then the weights in bf16, the
    model-local tree on every rank and the whole tree on rank 0.  (c) on ZOO_MESH, ZOO_STEP_ARCHS cut to
    ZOO_STEP_LAYERS layers at full width in f32: ``make_train_step`` on
    the model-local tree and on the whole tree, 2 steps of batch
    ZOO_STEP_B, and a prefill through K7 on each.  Writes
    ``OUT/rank<R>.json``: per run the seconds, ms a step, collectives and
    their bytes, K1/K6/K3 launches, resident bytes, peak memory, losses,
    tp_compute; rank 0 the params' and P1 changes' gaps from the
    replicated run, of the cut's runs and the control's under "cut"; (b)
    prefill ms, ms a decode step, K8 launches a prefill, the tokens and
    logits against the whole tree's, the SSM state against its heads of
    the whole state, the bf16 logits against the whole f32 tree's; (c) the losses', the
    first gradient's and the params' gaps, K7 launches a prefill."""
    import faulthandler
    import pickle
    import torch
    import torch.distributed as dist
    faulthandler.enable()
    torch.cuda.set_device(0)
    world = math.prod(ZOO_MESH)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    data = pickle.loads(Path(out, "data.pkl").read_bytes())
    report = {"rank": rank}
    t0 = time.perf_counter()
    _zoo_hymba(torch, rank, data, report)
    report["hymba_s"] = time.perf_counter() - t0
    _note(rank, "(a) done")
    t0 = time.perf_counter()
    _zoo_serve(torch, rank, report)
    report["serve_s"] = time.perf_counter() - t0
    _note(rank, "(b) done")
    t0 = time.perf_counter()
    _zoo_steps(torch, rank, report)
    report["steps_s"] = time.perf_counter() - t0
    _note(rank, "(c) done")
    Path(out, f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def zoo_views():
    """The views of pod_sharded_zoo (a)'s runs on a static mesh: under
    each layout, P1 (the whole model) and P2 (the adapters)."""
    from repro_torch.configs import get_config, with_peft
    from repro_torch.fl.task import lm_task
    from repro_torch.sharding import rules
    shapes = lm_task(with_peft(get_config(ZOO_ARCH), ZOO_PEFT)).shapes()
    mesh = _StaticMesh(ZOO_MESH)
    return {(layout, ph): rules.sharded_flat_view(
        shapes, mesh, layout, "lora" if ph == "P2" else None)
        for layout in ZOO_LAYOUTS for ph in ("P1", "P2")}


def pod_sharded_zoo(torch) -> list:
    """Phase pod_sharded_zoo: tensor parallelism over ``model`` for the
    SSM, hybrid, VLM and audio zoo, and FedProx under it, on four ranks
    of one card (``pod_sharded_zoo_worker``: gloo over a ``file://``
    store under TMPDIR, four processes on cuda:0).  Gates, (a)
    hymba-1.5b + lora:8 on (2, 2): fsdp_tp computed tensor-parallel in
    every phase on every rank, FedProx included (``tp_compute``, "tp" >
    0), replicated did not; fsdp_tp's losses within ZOO_LOSS_RTOL and
    its params within ZOO_TP_TOL of replicated's, at P2's end and at the
    FedProx round's, its P1 changes within ZOO_DELTA_TOL (L2) of
    replicated's (bf16: drift and unchanged-leaf bounds); the f32 cut to
    ZOO_CUT_LAYERS layers on the same measures within ZOO_CUT_LOSS_RTOL,
    ZOO_CUT_TP_TOL and ZOO_CUT_DELTA_TOL, its control's P1 changes
    beyond ZOO_CUT_DELTA_TOL; each rank's resident frozen rows in P2 the fsdp_tp view's per-shard
    sizes; K1, K6 and K3 once a bucket row; the frozen leaves kept.  (b)
    mamba2-1.3b served on (1, 4) in f32: 16 SSM heads a rank, K8
    launched once a layer a prefill (48) on each rank and on the whole
    tree, the greedy tokens the whole tree's, each step's logits within
    ZOO_SERVE_TOL, each rank's SSM state and conv history its part of
    the whole tree's within ZOO_SERVE_TOL.  (c) internvl2-1b (7 q + 1 kv
    heads a rank), musicgen-medium (12 heads and 2 codebooks a rank) and
    hymba-1.5b (25 SSM heads a rank, the attention whole) cut to 2
    layers, f32: losses, the first gradient and the two-step params
    within ZOO_STEP_TOL of the whole tree's, "tp" > 0, the prefill
    through K7 (2 launches a rank) within ZOO_PREFILL_TOL, hymba's
    control gradient beyond 100 x ZOO_STEP_TOL.  The collectives against
    lower_pod_round are dryrun_check (b)'s.  Reported: ms a step, peak
    memory a rank, bytes gathered and all-reduced a step, prefill ms and
    ms a decode step, the card.  Returns every rank's report."""
    import pickle
    import tempfile
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _, data, data_s = llm_setup()
    views = zoo_views()
    tmp = tempfile.mkdtemp(prefix="pod_sharded_zoo_")
    Path(tmp, "data.pkl").write_bytes(pickle.dumps(data))
    store = os.path.join(tmp, "store")
    world = math.prod(ZOO_MESH)
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    ranks = _run_ranks("pod_sharded_zoo", "--pod-sharded-zoo-rank", world,
                       store, tmp, env, ZOO_RANKS_TIMEOUT)
    steps = SHARDED_K * ZOO_STEPS

    def want(layout, p1=True):
        n1 = len(views[(layout, "P1")].trainable_groups) if p1 else 0
        n2 = len(views[(layout, "P2")].trainable_groups)
        return dict(local_step=steps * (n1 + n2),
                    delta_accum=SHARDED_K * n2, server_update=n2)

    def nbytes(groups, whole=False):
        from repro_torch.utils.flatten import torch_dtype
        return sum(g.size * (g.n_shards if whole else 1) *
                   torch_dtype(g.name).itemsize for g in groups)
    frozen_rows = nbytes(views[("fsdp_tp", "P2")].frozen_groups)
    frozen_whole = nbytes(views[("replicated", "P2")].frozen_groups, True)
    bad = []

    def finite(xs):
        return all(math.isfinite(x) for x in xs)

    def loss_gap(a, b):
        return max(abs(x / y - 1) for x, y in zip(a["losses"], b["losses"]))

    def pair(name, r, rk, loss_rtol):
        """Gates of a rank's runs of (a) or of its cut (``rk``): fsdp_tp
        computed tensor-parallel in every phase, replicated did not,
        frozen leaves kept, finite losses, fsdp_tp's within
        ``loss_rtol`` of replicated's."""
        for layout in ZOO_LAYOUTS:
            tp_on = layout == "fsdp_tp"
            for key, p1 in ((layout, True), (f"fedprox_{layout}", False)):
                got = rk[key]
                if got["tp_compute"] != [tp_on] * (2 if p1 else 1) or \
                        (got["collectives"]["tp"] > 0) != tp_on:
                    bad.append(f"rank {r} {name}{key}: tp_compute "
                               f"{got['tp_compute']}, collectives "
                               f"{got['collectives']}")
                if not (got.get("frozen_kept", r != 0) and
                        finite(got["losses"])):
                    bad.append(f"rank {r} {name}{key}: frozen leaves "
                               f"changed or losses {got['losses']}")
        for key in ("", "fedprox_"):
            a, b = rk[f"{key}fsdp_tp"], rk[f"{key}replicated"]
            if not loss_gap(a, b) <= loss_rtol:
                bad.append(f"rank {r} {name}{key}fsdp_tp losses "
                           f"{a['losses']} against {b['losses']}")

    def params_gates(name, r0, tp_tol, delta_tol):
        """Rank 0's gates of fsdp_tp's params against replicated's at P2's
        and FedProx's ends and of its P1 changes; the readings."""
        close, moved, prox = (r0[k] for k in (
            "tp_vs_replicated", "tp_vs_replicated_p1_delta",
            "fedprox_tp_vs_replicated"))
        for ph, c in (("P2", close), ("FedProx", prox)):
            if not (c["dtypes_equal"] and c["rel"] <= tp_tol):
                bad.append(f"{name}fsdp_tp's {ph} params off replicated's: "
                           f"{c}")
        if not moved["l2"] <= delta_tol:
            bad.append(f"{name}fsdp_tp's P1 changes off replicated's: "
                       f"{moved}")
        return dict(
            loss_gap=loss_gap(r0["fsdp_tp"], r0["replicated"]),
            fedprox_loss_gap=loss_gap(r0["fedprox_fsdp_tp"],
                                      r0["fedprox_replicated"]),
            rel=close["rel"], fedprox_rel=prox["rel"],
            p1_delta_l2=moved["l2"], p1_delta_rel=moved["rel"])
    for rk in ranks:
        r = rk["rank"]
        pair("", r, rk, ZOO_LOSS_RTOL)
        pair("the cut's ", r, rk["cut"], ZOO_CUT_LOSS_RTOL)
        for layout in ZOO_LAYOUTS:
            tp_on = layout == "fsdp_tp"
            for key, p1 in ((layout, True), (f"fedprox_{layout}", False)):
                got = rk[key]
                if got["launches"] != want(layout, p1):
                    bad.append(f"rank {r} {key} launches {got['launches']} "
                               f"!= {want(layout, p1)}")
                if got["resident"][-1]["frozen"] != (
                        frozen_rows if tp_on else frozen_whole):
                    bad.append(f"rank {r} {key} frozen bytes "
                               f"{got['resident'][-1]}")
        sv = rk["serve"]
        if not (sv["ssm_heads"] == 16 and sv["tp_plan"]["ssm"] and
                sv["ssd_launches_per_prefill"] == 48 and
                sv["whole_ssd_launches_per_prefill"] == 48 and
                sv["tokens_equal"] and
                max(sv["logits_rel"]) <= ZOO_SERVE_TOL and
                max(sv["state_rel"]) <= ZOO_SERVE_TOL and
                sv["collectives"]["tp"] > 0):
            bad.append(f"rank {r} (b): {sv}")
        for arch, st in rk["steps"].items():
            ok = st["tp"] > 0 and st["k7_launches_per_prefill"] == \
                ZOO_STEP_LAYERS and max(st["grad"], st["params"]) <= \
                ZOO_STEP_TOL and st["prefill_rel"] <= ZOO_PREFILL_TOL and \
                all(abs(x - y) <= ZOO_STEP_TOL * abs(y)
                    for x, y in [st["first_loss"]] + st["losses"]) and \
                (st["control_grad"] is None or
                 st["control_grad"] > 100 * ZOO_STEP_TOL)
            if not ok:
                bad.append(f"rank {r} (c) {arch}: {st}")
    r0 = ranks[0]
    readings = params_gates("", r0, ZOO_TP_TOL, ZOO_DELTA_TOL)
    cut = params_gates("the cut's ", r0["cut"], ZOO_CUT_TP_TOL,
                       ZOO_CUT_DELTA_TOL)
    ctl = r0["cut"]["control_vs_replicated_p1_delta"]
    cut.update(control_p1_delta_l2=ctl["l2"], control_p1_delta_rel=ctl["rel"],
               control_loss_gap=loss_gap(r0["cut"]["control"],
                                         r0["cut"]["replicated"]))
    if not ctl["l2"] > ZOO_CUT_DELTA_TOL:
        bad.append(f"the cut's control passed the P1 changes' gate: {ctl}")
    serve = [rk["serve"] for rk in ranks]
    readings.update(
        cut=cut,
        serve_logits_rel=max(max(sv["logits_rel"]) for sv in serve),
        serve_state_rel=max(max(sv["state_rel"]) for sv in serve),
        serve_bf16_tp_logits_rel=max(max(sv["bf16_tp_logits_rel"])
                                     for sv in serve),
        serve_bf16_whole_logits_rel=max(serve[0]["bf16_whole_logits_rel"]),
        steps={arch: {k: max(rk["steps"][arch][k] or 0.0 for rk in ranks)
                      for k in ("grad", "params", "prefill_rel",
                                "control_grad")}
               for arch in r0["steps"]})
    emit(dict(phase="pod_sharded_zoo", part="hybrid",
              model=f"{ZOO_ARCH} + {ZOO_PEFT}",
              mesh=dict(zip(("data", "model"), ZOO_MESH)),
              backend="gloo, four processes on cuda:0",
              rounds={"P1": f"1 x 2 clients x {ZOO_STEPS} steps",
                      "P2": f"1 x 2 clients x {ZOO_STEPS} steps",
                      "FedProx P2": f"1 x 2 clients x {ZOO_STEPS} steps, "
                                    f"mu {ZOO_PROX_MU}"},
              batch=SHARDED_BATCH, seq=128, data_s=data_s,
              per_step={key: dict(
                  ms=[rk[key]["ms_per_step"] for rk in ranks],
                  bytes=r0[key]["bytes_per_step"],
                  peak_memory_bytes=[rk[key]["peak_memory_bytes"]
                                     for rk in ranks])
                  for key in ("fsdp_tp", "replicated", "fedprox_fsdp_tp",
                              "fedprox_replicated")},
              frozen_bytes_per_rank={"fsdp_tp": frozen_rows,
                                     "replicated": frozen_whole},
              tp_tol=ZOO_TP_TOL, loss_rtol=ZOO_LOSS_RTOL,
              delta_tol=ZOO_DELTA_TOL,
              cut=dict(layers=ZOO_CUT_LAYERS, dtype="float32",
                       loss_rtol=ZOO_CUT_LOSS_RTOL, tp_tol=ZOO_CUT_TP_TOL,
                       delta_tol=ZOO_CUT_DELTA_TOL,
                       ms=[rk["cut"]["fsdp_tp"]["ms_per_step"]
                           for rk in ranks]),
              readings=readings,
              ranks=[{k: v for k, v in rk.items()
                      if k not in ("serve", "steps")} for rk in ranks],
              card=nvidia_smi()))
    emit(dict(phase="pod_sharded_zoo", part="ssm_serve",
              model=ZOO_SERVE_ARCH,
              mesh=dict(zip(("data", "model"), ZOO_SERVE_MESH)),
              batch=ZOO_SERVE_B, prompt=ZOO_SERVE_S,
              new_tokens=ZOO_SERVE_NEW, tol=ZOO_SERVE_TOL,
              ranks=[rk["serve"] for rk in ranks], card=nvidia_smi()))
    emit(dict(phase="pod_sharded_zoo", part="steps",
              layers=ZOO_STEP_LAYERS, batch=ZOO_STEP_B, dtype="float32",
              shapes={a: dict(patches=p, positions=t)
                      for a, p, t in ZOO_STEP_ARCHS},
              tol=ZOO_STEP_TOL, prefill_tol=ZOO_PREFILL_TOL,
              ranks=[rk["steps"] for rk in ranks], card=nvidia_smi(),
              phase_s=time.perf_counter() - t_phase))
    if bad:
        raise SystemExit("chip_smoke: pod_sharded_zoo: " + "; ".join(bad))
    return ranks


def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms for a kernel-vs-plain comparison;
    returns the flags to restore, so later timings run as the main path
    does."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return flags


def restore_cudnn(torch, flags) -> None:
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def reset_kernel_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ssd_scan as ssd
    fu.reset_launch_counts()
    fa.flash_attention.launches = ssd.ssd_scan.launches = 0


def kernel_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": fa.flash_attention.launches,
            "ssd_scan": ssd.ssd_scan.launches}


def serve(torch):
    """Phase 5: hymba-1.5b at full width through Engine.generate on the
    kernel path, launch counts asserted."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine
    from repro_torch.utils.tree_math import count_params

    cfg = dataclasses.replace(get_config("hymba-1.5b"), attn_impl="pallas",
                              ssd_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(eng.params)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                                      generator=gen, device="cuda")}

    reset_kernel_counts()
    tokens, cold = eng.generate(prompt, SERVE_NEW)
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": cfg.n_layers * (1 + SERVE_NEW),
            "ssd_scan": cfg.n_layers}
    again, warm = eng.generate(prompt, SERVE_NEW)
    per_phase = phase_launches(torch, eng, prompt)
    emit(dict(phase="serve", model=cfg.name, params=n_params,
              dtype=str(cfg.dtype)[6:], batch=SERVE_B, prompt=SERVE_S,
              new_tokens=SERVE_NEW, window=cfg.window,
              global_layers=list(cfg.global_attn_layers), init_s=init_s,
              prefill_ms=cold.prefill_s * 1e3,
              decode_ms_per_step=cold.decode_s * 1e3 / SERVE_NEW,
              tok_per_s=cold.tok_per_s,
              warm_prefill_ms=warm.prefill_s * 1e3,
              warm_decode_ms_per_step=warm.decode_s * 1e3 / SERVE_NEW,
              warm_tok_per_s=warm.tok_per_s,
              prefill_tok_per_s=SERVE_B * SERVE_S / warm.prefill_s,
              peak_memory_gb=peak_gb, launches=launches,
              expected_launches=want, launches_by_phase=per_phase,
              repeat_tokens_identical=bool(torch.equal(tokens, again)),
              first_tokens=tokens[0, :16].tolist()))
    if n_params != HYMBA_PARAMS:
        raise SystemExit(f"chip_smoke: hymba-1.5b has {n_params} params, "
                         f"expected {HYMBA_PARAMS}")
    if launches != want:
        raise SystemExit(f"chip_smoke: serve launches {launches} != {want}")
    for kname, total in launches.items():
        split = per_phase[kname]
        if split["prefill"] + SERVE_NEW * split["decode_step"] != total:
            raise SystemExit(f"chip_smoke: {kname} launches per prefill and "
                             f"per decode step {split} do not make up the "
                             f"total {total}")
    if tokens.shape != (SERVE_B, SERVE_NEW) or \
            not 0 <= int(tokens.min()) <= int(tokens.max()) < cfg.vocab_size:
        raise SystemExit("chip_smoke: generated tokens out of range")
    return eng, prompt, tokens, launches, per_phase


def phase_launches(torch, eng, prompt, max_len: int = SERVE_T):
    """The K7 and K8 launches of one prefill and of one decode step, each
    read from counts set to 0 just before it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.serve import prompt_length
    from repro_torch.models.transformer import decode_step, prefill

    kernels = {"flash_attention": fa.flash_attention,
               "ssd_scan": ssd.ssd_scan}
    cfg, counts = eng.cfg, {}

    def run(phase, fn):
        for k in kernels.values():
            k.launches = 0
        out = fn()
        for name, k in kernels.items():
            counts.setdefault(name, {})[phase] = k.launches
        return out

    with torch.inference_mode():
        logits, cache, _ = run("prefill", lambda: prefill(
            eng.params, cfg, prompt, max_len))
        x = greedy_input(cfg, logits)
        run("decode_step", lambda: decode_step(
            eng.params, cfg, x, cache, prompt_length(cfg, prompt)))
        del cache
    return counts


def greedy_input(cfg, logits):
    """The next decode step's input from the last logits: the greedy ids
    (B, 1[, n_codebooks]), or the audio stand-in frames."""
    from repro_torch.launch.serve import decode_input
    return decode_input(cfg, logits[:, -1].argmax(-1)[:, None])


def forced_logits(torch, params, cfg, prompt, tokens, max_len=SERVE_T):
    """Prefill logits, then one decode step per generated token, fed the
    given tokens (teacher forcing): (B, 1 + new, V[, n_codebooks]) f32."""
    from repro_torch.launch.serve import decode_input, prompt_length
    from repro_torch.models.transformer import decode_step, prefill
    S = prompt_length(cfg, prompt)
    with torch.inference_mode():
        logits, cache, _ = prefill(params, cfg, prompt, max_len)
        out = [logits[:, -1].float()]
        for i in range(tokens.shape[1]):
            logits, cache = decode_step(
                params, cfg, decode_input(cfg, tokens[:, i:i + 1]), cache,
                S + i)
            out.append(logits[:, -1].float())
        del cache
    return torch.stack(out, dim=1)


def logit_gap(a, b):
    """Max and RMS of |a - b| over (B, 1 + steps, ...) logits, split into
    the prefill and the decode steps, and the argmax agreement."""
    d = (a - b).abs()
    return dict(max=float(d.max()), rms=float(d.square().mean().sqrt()),
                prefill_max=float(d[:, 0].max()),
                decode_max=float(d[:, 1:].max()),
                argmax_agree=float((a.argmax(-1) == b.argmax(-1))
                                   .float().mean()))


def serve_e2e(torch, eng, prompt, tokens, max_len=SERVE_T,
              phase="serve_e2e"):
    """Phase 6: the kernel path against the plain path on the same
    weights and prompt.  Tolerance: the kernels may move the logits no
    further from the plain bf16 path than bf16 rounding itself does, i.e.
    the kernel-vs-plain gap (max and RMS over the prefill and the
    teacher-forced decode steps) must not exceed the plain bf16 path's
    gap to the same computation in f32."""
    import dataclasses
    from repro_torch.launch.serve import Engine
    from repro_torch.utils.tree_math import tree_map

    cfg = eng.cfg
    steps = tokens.shape[1]
    plain_cfg = dataclasses.replace(cfg, attn_impl="pallas_interpret",
                                    ssd_impl="pallas_interpret")
    f32_cfg = dataclasses.replace(plain_cfg, dtype=torch.float32,
                                  param_dtype=torch.float32)
    kern = forced_logits(torch, eng.params, cfg, prompt, tokens, max_len)
    plain = forced_logits(torch, eng.params, plain_cfg, prompt, tokens,
                          max_len)
    p32 = tree_map(lambda t: t.float(), eng.params)
    ref32 = forced_logits(torch, p32, f32_cfg, prompt, tokens, max_len)
    del p32
    kp, pf = logit_gap(kern, plain), logit_gap(plain, ref32)
    kf = logit_gap(kern, ref32)
    reproduces = bool(torch.equal(kern.argmax(-1)[:, :steps], tokens))
    plain_eng = Engine(plain_cfg, params=eng.params)
    plain_tokens, _ = plain_eng.generate(prompt, steps)
    agree = (plain_tokens == tokens).reshape(tokens.shape[0], steps, -1)
    diverged = (~agree.all(-1)).float().argmax(dim=1)
    first_div = [int(d) if not bool(a.all()) else None
                 for d, a in zip(diverged, agree)]
    ok = bool(torch.isfinite(kern).all()) and kp["max"] <= pf["max"] and \
        kp["rms"] <= pf["rms"]
    emit(dict(phase=phase, model=cfg.name, steps=steps,
              tolerance="kernel-vs-plain max and rms <= plain-bf16-vs-f32",
              kernel_vs_plain=kp, plain_vs_f32=pf, kernel_vs_f32=kf,
              teacher_forced_run_reproduces_generate=reproduces,
              greedy_token_agreement=float(agree.float().mean()),
              first_divergent_step=first_div, ok=ok))
    if not ok:
        raise SystemExit(f"chip_smoke: {cfg.name}'s kernel path leaves the "
                         "plain path's bf16 noise")


K8_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_scan_kernel")


def serve_profile(torch, eng, prompt, max_len=SERVE_T,
                  phase="serve_profile") -> dict:
    """Phase 7: one prefill and one decode step under torch.profiler
    (CUDA activity only): device-busy share and top device ops; returns
    K8's device kernels per run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import prompt_length
    from repro_torch.models.transformer import decode_step, prefill

    cfg = eng.cfg
    with torch.inference_mode():
        logits, cache, _ = prefill(eng.params, cfg, prompt, max_len)
        x = greedy_input(cfg, logits)
        del logits
        runs = {"prefill": lambda: prefill(eng.params, cfg, prompt, max_len),
                "decode_step": lambda: decode_step(
                    eng.params, cfg, x, cache, prompt_length(cfg, prompt))}
        k8_kernels = {}
        for name, fn in runs.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy, n_ops, top = device_activity(prof, n_top=15)
            k7_us, k7_n = kernel_time(prof, ("fa_split_kernel",
                                             "fa_wgmma_kernel", "fa_kernel"))
            k8_us, k8_n = kernel_time(prof, K8_KERNELS)
            k8_kernels[name] = k8_n
            emit(dict(phase=phase, model=cfg.name, run=name,
                      wall_ms=wall_us / 1e3,
                      device_busy_ms=busy / 1e3,
                      device_busy_share=busy / wall_us if n_ops else None,
                      device_ops=n_ops, k7_ms=k7_us / 1e3, k7_launches=k7_n,
                      k8_ms=k8_us / 1e3, k8_launches=k8_n,
                      k8_ms_by_kernel={k: kernel_time(prof, (k,))[0] / 1e3
                                       for k in K8_KERNELS},
                      top_device_ops=top))
            if not n_ops:
                raise SystemExit("chip_smoke: the profiler saw no device op")
    return k8_kernels


def serve_run(torch, arch: str):
    """``arch`` at full width and depth (bf16, random from SEED) through
    Engine.generate on the kernel path: init seconds and peak memory,
    then a batch of 8 prompts of 2048 positions (vlm: the config's patch
    embeddings, then tokens), ZOO_NEW greedy tokens twice (cold, then
    warm), the launches of the first run read from counts set to 0 just
    before it."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, prompt_batch
    from repro_torch.utils.tree_math import count_params, tree_leaves

    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas",
                              ssd_impl="pallas")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    eng = Engine(cfg, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = count_params(eng.params)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = prompt_batch(cfg, SERVE_B, SERVE_S - cfg.n_prefix_tokens, gen)
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    tokens, cold = eng.generate(prompt, ZOO_NEW)
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    again, warm = eng.generate(prompt, ZOO_NEW)
    line = dict(model=cfg.name, params=n_params, dtype=str(cfg.dtype)[6:],
                batch=SERVE_B, prompt_positions=SERVE_S,
                new_tokens=ZOO_NEW, init_s=init_s,
                memory_before_init_gb=before_gb,
                init_peak_memory_gb=init_peak_gb,
                params_gb=sum(t.numel() * t.element_size()
                              for t in tree_leaves(eng.params)) / 1e9,
                prefill_ms=cold.prefill_s * 1e3,
                decode_ms_per_step=cold.decode_s * 1e3 / ZOO_NEW,
                tok_per_s=cold.tok_per_s,
                warm_prefill_ms=warm.prefill_s * 1e3,
                warm_decode_ms_per_step=warm.decode_s * 1e3 / ZOO_NEW,
                warm_tok_per_s=warm.tok_per_s,
                prefill_tok_per_s=SERVE_B * SERVE_S / warm.prefill_s,
                peak_memory_gb=peak_gb, launches=launches,
                repeat_tokens_identical=bool(torch.equal(tokens, again)),
                first_tokens=tokens[0, :8].tolist())
    if n_params != ZOO_PARAMS[arch]:
        raise SystemExit(f"chip_smoke: {arch} has {n_params} params, "
                         f"expected {ZOO_PARAMS[arch]}")
    want_shape = (SERVE_B, ZOO_NEW) + ((cfg.n_codebooks,)
                                       if cfg.n_codebooks > 1 else ())
    if tokens.shape != want_shape or \
            not 0 <= int(tokens.min()) <= int(tokens.max()) < cfg.vocab_size:
        raise SystemExit(f"chip_smoke: {arch}'s tokens are out of range or "
                         f"of shape {tuple(tokens.shape)}")
    return eng, prompt, tokens, line


def moe_drops(torch, eng, prompt) -> dict:
    """The routed pairs each MoE layer drops past its capacity, in one
    prefill and in one decode step (``layers.record_routing``)."""
    from repro_torch.launch.serve import prompt_length
    from repro_torch.models.layers import record_routing
    from repro_torch.models.transformer import decode_step, prefill
    cfg, out = eng.cfg, {}
    with torch.inference_mode():
        with record_routing() as log:
            logits, cache, _ = prefill(eng.params, cfg, prompt, ZOO_T)
        out["prefill"] = log
        with record_routing() as log:
            decode_step(eng.params, cfg, greedy_input(cfg, logits), cache,
                        prompt_length(cfg, prompt))
        out["decode_step"] = log
        del cache
    return {run: dict(capacity=log[0]["capacity"], pairs=log[0]["pairs"],
                      dropped_per_layer=[int(r["dropped"]) for r in log])
            for run, log in out.items()}


def moe_serve(torch) -> dict:
    """deepseek-v2-lite-16b at full width and depth (MoE + MLA, 15.7 B
    bf16 params) through Engine.generate: no K7 launch (MLA is not K7's),
    repeat-identical tokens, the dropped pairs per MoE layer, one
    profiled prefill and decode step; then the depth cut (moe_cut).
    Returns the path's launches."""
    eng, prompt, tokens, line = serve_run(torch, "deepseek-v2-lite-16b")
    drops = moe_drops(torch, eng, prompt)
    emit(dict(phase="moe_serve", **line, routing=drops))
    if line["launches"]["flash_attention"] != 0:
        raise SystemExit(f"chip_smoke: deepseek's MLA launched K7: "
                         f"{line['launches']}")
    if not line["repeat_tokens_identical"]:
        raise SystemExit("chip_smoke: deepseek's repeat run gave other "
                         "tokens")
    serve_profile(torch, eng, prompt, ZOO_T, phase="moe_serve_profile")
    cfg = eng.cfg
    del eng, prompt, tokens
    torch.cuda.empty_cache()
    moe_cut(torch, cfg)
    return line["launches"]


def routing_diff(torch, a, b) -> int:
    """(token, k) routing choices that differ between two record_routing
    logs of the same run."""
    return sum(int((x["topk_idx"].cpu() != y["topk_idx"].cpu()).sum())
               for x, y in zip(a, b))


def moe_cut(torch, cfg) -> None:
    """deepseek-v2-lite-16b at full width cut to n_layers 3 (the dense
    layer and two MoE layers; a full-width f32 copy of the whole model,
    63 GB, does not fit beside it): bf16 against f32 on the card,
    teacher-forced at the serve shapes (the gap reported), and the card's
    f32 against the same code on the host CPU at batch 2 x prompt 128:
    logits within MOE_CPU_TOL and identical top-k routing."""
    import dataclasses
    from repro_torch.configs import param_count
    from repro_torch.launch.serve import Engine, prompt_batch
    from repro_torch.models.layers import record_routing
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils.tree_math import tree_map

    cut = dataclasses.replace(cfg, n_layers=3)
    cut32 = dataclasses.replace(cut, dtype=torch.float32,
                                param_dtype=torch.float32)
    p16 = init_lm(cut, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = prompt_batch(cut, SERVE_B, SERVE_S, gen)
    tokens, _ = Engine(cut, params=p16).generate(prompt, MOE_CUT_NEW)
    max_len = SERVE_S + MOE_CUT_NEW
    with record_routing() as r16:
        l16 = forced_logits(torch, p16, cut, prompt, tokens, max_len)
    p32 = tree_map(lambda t: t.float(), p16)
    del p16
    with record_routing() as r32:
        l32 = forced_logits(torch, p32, cut32, prompt, tokens, max_len)
    bf16_vs_f32 = dict(logit_gap(l16, l32),
                       routing_pairs_differing=routing_diff(torch, r16, r32),
                       routing_pairs=sum(r["pairs"] for r in r16))
    del l16, l32, r16, r32

    small = {"tokens": prompt["tokens"][:MOE_CPU_B, :MOE_CPU_S]}
    toks = tokens[:MOE_CPU_B, :MOE_CPU_NEW]
    max_len = MOE_CPU_S + MOE_CPU_NEW
    with record_routing() as rc:
        card = forced_logits(torch, p32, cut32, small, toks, max_len).cpu()
    host_params = tree_map(lambda t: t.cpu(), p32)
    del p32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with record_routing() as rh:
        host = forced_logits(torch, host_params, cut32,
                             {"tokens": small["tokens"].cpu()}, toks.cpu(),
                             max_len)
    host_s = time.perf_counter() - t0
    del host_params
    d = (card - host).abs()
    within = bool((d <= MOE_CPU_TOL + MOE_CPU_TOL * host.abs()).all())
    differing = routing_diff(torch, rc, rh)
    ok = within and differing == 0 and bool(torch.isfinite(card).all())
    emit(dict(phase="moe_cut", model=cut.name, n_layers=cut.n_layers,
              params=param_count(cut),
              bf16_vs_f32=dict(bf16_vs_f32, batch=SERVE_B, prompt=SERVE_S,
                               steps=MOE_CUT_NEW),
              card_vs_cpu_f32=dict(max_abs=float(d.max()),
                                   tolerance=f"{MOE_CPU_TOL} + "
                                   f"{MOE_CPU_TOL}*|cpu|",
                                   within_tol=within,
                                   routing_pairs_differing=differing,
                                   routing_pairs=sum(r["pairs"] for r in rh),
                                   batch=MOE_CPU_B, prompt=MOE_CPU_S,
                                   steps=MOE_CPU_NEW, cpu_s=host_s),
              ok=ok))
    if not ok:
        raise SystemExit("chip_smoke: deepseek's depth cut on the card "
                         "disagrees with the CPU in f32")


def serve_family(torch, arch: str, phase: str) -> dict:
    """``arch`` at full width through Engine.generate on the kernel path
    (serve_run): K7 launched n_layers x (1 + ZOO_NEW) times, split into
    prefill and decode as phase_launches counts them, and the kernel path
    within the plain path's bf16 noise (serve_e2e).  Returns its K7
    launches."""
    eng, prompt, tokens, line = serve_run(torch, arch)
    per_phase = phase_launches(torch, eng, prompt, ZOO_T)
    want = {"flash_attention": eng.cfg.n_layers * (1 + ZOO_NEW),
            "ssd_scan": 0}
    emit(dict(phase=phase, **line, expected_launches=want,
              launches_by_phase=per_phase))
    if line["launches"] != want:
        raise SystemExit(f"chip_smoke: {arch} launches {line['launches']} "
                         f"!= {want}")
    split = per_phase["flash_attention"]
    if split["prefill"] + ZOO_NEW * split["decode_step"] != \
            want["flash_attention"]:
        raise SystemExit(f"chip_smoke: {arch}'s K7 launches per prefill and "
                         f"decode step {split} do not make up the total")
    if phase == "qwen_serve" and not line["repeat_tokens_identical"]:
        raise SystemExit(f"chip_smoke: {arch}'s repeat run gave other tokens")
    serve_e2e(torch, eng, prompt, tokens, ZOO_T, phase=f"{phase}_e2e")
    del eng, prompt, tokens
    torch.cuda.empty_cache()
    return dict(launches=line["launches"]["flash_attention"],
                launches_per_prefill=split["prefill"],
                launches_per_decode_step=split["decode_step"])


def zoo_serve(torch) -> dict:
    """internvl2-1b (256 patch embeddings + 1792 tokens) and
    musicgen-medium (2048 frames) at full width (serve_family).  Returns
    each model's K7 launches."""
    return {arch: serve_family(torch, arch, "zoo_serve")
            for arch in ("internvl2-1b", "musicgen-medium")}


def qwen_serve(torch) -> dict:
    """qwen2-1.5b, the serve CLI's default arch, at full width
    (serve_family): K7 at head_dim 128, G 6, 28 x 9 launches, its param
    count the JAX package's, tokens in range and repeat-identical."""
    return serve_family(torch, "qwen2-1.5b", "qwen_serve")


# --- training the MoE, VLM and audio zoo ------------------------------------

@functools.lru_cache(maxsize=1)
def moe_setup():
    """deepseek-v2-lite-16b + lora:8 at full width and depth (27 layers,
    d_model 2048, MLA, 64 routed experts top-6 + 2 shared, vocab 102400,
    bf16, random weights from the seed) and its federated token data:
    ``make_synthetic_tokenlm(n_clients=16, seq_len=128,
    n_seq_per_client=32, vocab=102400, beta=0.5)``, made on the host
    (seconds returned)."""
    from repro_torch.data.synthetic import make_synthetic_tokenlm
    cfg = moe_setup_config()
    t0 = time.perf_counter()
    data = make_synthetic_tokenlm(n_clients=16, seq_len=128,
                                  n_seq_per_client=32, vocab=cfg.vocab_size,
                                  beta=0.5, seed=SEED)
    return cfg, data, time.perf_counter() - t0


def moe_spec(**kw):
    """moe_train's PodFLSpec; ``kw`` overrides its fields."""
    from repro_torch.launch.train import PodFLSpec
    return PodFLSpec(**dict(dict(peft=MOE_PEFT, trainable_filter=MOE_FILTER,
                                 local_steps=2, batch_size=8, lr=0.03,
                                 update_impl="fused"), **kw))


def slice_moves(torch, before, after, mask, paths) -> dict:
    """Per trainable leaf, whether it moved, and for a stacked leaf
    (``blocks/...``: one row per layer) whether every layer's row did;
    whether every frozen leaf stayed bitwise."""
    from repro_torch.utils.tree_math import tree_leaves
    moved, frozen_ok = {}, True
    for path, a, b, m in zip(paths, tree_leaves(before), tree_leaves(after),
                             mask):
        if not m:
            frozen_ok &= bool(torch.equal(a, b))
            continue
        ne = a != b
        rows = ne.reshape(a.shape[0], -1).any(1) if \
            path.startswith("blocks/") else ne.reshape(1, -1).any(1)
        moved[path] = int(rows.sum()), int(rows.numel())
    return dict(frozen_bitwise=frozen_ok, moved_rows=moved,
                all_moved=all(k == n for k, n in moved.values()))


class Deterministic:
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for
    the block (the MoE backward's index writes then sort instead of
    adding with atomics); records the ops that have no deterministic CUDA
    version (their warnings) in ``nondeterministic``.  The script sets
    CUBLAS_WORKSPACE_CONFIG before any cuBLAS call, so cuBLAS raises no
    warning here."""

    def __init__(self, torch):
        self.torch, self.nondeterministic = torch, []

    def __enter__(self):
        import warnings
        self._warn = warnings.catch_warnings(record=True)
        self._log = self._warn.__enter__()
        warnings.simplefilter("always")
        self.torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(False)
        self._warn.__exit__(*exc)
        self.nondeterministic = sorted({
            str(w.message).split(" does not have")[0][:120]
            for w in self._log if "deterministic" in str(w.message)})
        return False


def moe_train(torch, fu, mesh) -> dict:
    """Phase moe_train: federated fine-tuning of deepseek-v2-lite-16b +
    lora:8 (``moe_setup``) through ``launch.train.run_pod_training`` on
    the one-rank NCCL mesh, P2 only: 2 rounds x 4 clients x 2 steps of
    batch 8, lr 0.03, the trainable slice the regex
    ``/(lora_a|lora_b)$|/router/w$`` (two buckets: the f32 routers,
    3,407,872, and the bf16 adapters, 311,808), the per-sequence loss as
    the eval metric every round (batch 16).  The init tree (31.4 GB) and
    the engine's frozen bucket (31.4 GB) are the base held twice.
    Asserted: K1 32, K6 16, K3 4 (one launch a bucket), K2 0, no upload
    kernel; every frozen leaf bitwise its init, every trainable leaf
    moved, each of the 26 routers; the ledger's upload per client the
    slice's bytes (14,255,104); the eval loss finite and P2's last below
    the init's.  Reported: init seconds, run seconds, peak memory, and a
    profiled warm P2 round of 2 clients (ms and device ops per step, busy
    share).  Then the 3-layer cut (moe_cut_train)."""
    from repro_torch.configs import param_count
    from repro_torch.fl.pod import PodFLConfig, run_pod_rounds
    from repro_torch.fl.task import lm_task
    from repro_torch.launch.train import (run_pod_training,
                                          sequence_loss_metric)
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import rules
    from repro_torch.utils.flatten import FlatView
    from repro_torch.utils.tree_math import tree_paths
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    cfg, data, data_s = moe_setup()
    task = lm_task(cfg)
    shapes = task.shapes()
    mask = rules.trainable_mask(shapes, MOE_FILTER)
    paths = tree_paths(shapes)
    view = FlatView.of(shapes, filter=mask)
    n_params = param_count(cfg)
    if (n_params, view.buffer_sizes) != (MOE_LORA_PARAMS, MOE_SLICE):
        raise SystemExit(f"chip_smoke: deepseek-v2-lite-16b + lora:8 has "
                         f"{n_params} params, slice {view.buffer_sizes}")
    del shapes
    metric = sequence_loss_metric(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init = init_lm(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_loss = stream_mean(torch, metric, init, data)
    fu.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_pod_training(cfg, data, cyclic_rounds=0, fl_rounds=2,
                           clients_per_round=MOE_K, spec=moe_spec(),
                           mesh=mesh, seed=SEED, eval_fn=metric,
                           eval_batch=16, init_params=init)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches(fu)
    nb = len(MOE_SLICE)         # one launch a bucket
    want = dict(dict.fromkeys(launches, 0), local_step=2 * MOE_K * 2 * nb,
                delta_accum=2 * MOE_K * nb, server_update=2 * nb)
    moves = slice_moves(torch, init, res.params, mask, paths)
    routers = moves["moved_rows"].get("blocks/moe/router/w")
    del init
    led = res.schedule.ledger
    per_client = led.p2_upload_bytes // (2 * MOE_K)
    closed = sum(n * getattr(torch, k).itemsize for k, n in MOE_SLICE.items())
    evals = [h["eval"] for h in res.history]

    # a profiled warm P2 round of 2 clients from the trained params
    c = PodFLConfig(mesh, rounds=1, clients_per_round=2, seed=SEED + 17,
                    spec=moe_spec())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pod_rounds(task, data, c, init_params=res.params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_ops, top = device_activity(prof, n_top=12)
    del prof
    steps = 2 * 2
    emit(dict(phase="moe_train", model=f"{cfg.name} + {MOE_PEFT}",
              params=n_params, trainable_filter=MOE_FILTER,
              slice=MOE_SLICE,
              slice_buckets={k: padded(n) for k, n in MOE_SLICE.items()},
              dtype="bfloat16", dataset="make_synthetic_tokenlm(16 clients, "
              "32 x 128, vocab 102400, beta 0.5)", data_s=data_s,
              init_s=init_s, history=res.history, init_eval_loss=init_loss,
              run_s=run_s, launches=launches, expected_launches=want,
              **moves, upload_bytes_per_client=per_client,
              upload_closed_form=closed, ledger=led.summary(),
              peak_memory_bytes=peak,
              profiled_p2_round=dict(
                  clients=2, sgd_steps=steps, wall_ms=wall_us / 1e3,
                  ms_per_step=wall_us / 1e3 / steps,
                  device_busy_ms=busy / 1e3,
                  device_busy_share=busy / wall_us if n_ops else None,
                  device_ops=n_ops, device_ops_per_step=n_ops / steps,
                  top_device_ops=top),
              phase_s=time.perf_counter() - t_phase))
    if launches != want:
        raise SystemExit(f"chip_smoke: moe_train launches {launches}")
    if not (moves["frozen_bitwise"] and moves["all_moved"]) or \
            routers != (26, 26):
        raise SystemExit(f"chip_smoke: moe_train's frozen leaves changed or "
                         f"a trainable leaf did not move: {moves}")
    if per_client != closed or \
            led.p2_upload_bytes != 2 * MOE_K * per_client:
        raise SystemExit(f"chip_smoke: moe_train upload bytes {per_client} "
                         f"!= the slice's {closed}")
    if not (all(math.isfinite(e) for e in evals) and evals[-1] < init_loss):
        raise SystemExit(f"chip_smoke: moe_train eval loss {evals} did not "
                         f"fall below the init's {init_loss}")
    if not n_ops:
        raise SystemExit("chip_smoke: the profiler saw no device op")
    del res
    torch.cuda.empty_cache()
    cut = moe_cut_train(torch, fu, mesh, cfg, data)
    return dict(full=launches, **cut)


def moe_cut_train(torch, fu, mesh, cfg, data) -> dict:
    """The 3-layer full-width cut of moe_train (its slice: the adapters
    and 2 routers: 311,808 bf16 and 262,144 f32): P1 1 round x 4 x 2
    relaying the whole model (K1 16 over the two buckets of every leaf,
    every leaf moved), then P2 1 round (K1 16, K6 8, K3 2; K2 and K3 2
    each in the host engine's round).  Under deterministic algorithms
    (``Deterministic``): one P2 round under "fused" bitwise the same
    round under "fused_interpret" and bitwise a repeat of itself; one P2
    FedAvgM round of the host engine (AggregateStrategy: K2 and K3's
    aggregate form) against the pod's from P1's params, losses bitwise
    and params within 2 bf16 ulps (as llm_lora).  An op with no
    deterministic CUDA version is named, and the bitwise gates then hold
    within 2 bf16 ulps."""
    import dataclasses
    from repro_torch.fl.engine import (AggregateStrategy, RoundSchedule,
                                       run_rounds)
    from repro_torch.fl.local import LocalSpec
    from repro_torch.fl.pod import PodFLConfig, run_pod_rounds
    from repro_torch.fl.task import lm_task
    from repro_torch.launch.train import (run_pod_training,
                                          sequence_loss_metric)
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import rules
    from repro_torch.utils.flatten import FlatView
    from repro_torch.utils.tree_math import tree_leaves, tree_paths

    t_phase = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=MOE_CUT_LAYERS)
    task = lm_task(cut)
    shapes = task.shapes()
    mask = rules.trainable_mask(shapes, MOE_FILTER)
    p1_sizes = FlatView.of(shapes).buffer_sizes
    p2_sizes = FlatView.of(shapes, filter=mask).buffer_sizes
    if (p1_sizes, p2_sizes) != (moe_cut_p1_buckets(), MOE_CUT_SLICE):
        raise SystemExit(f"chip_smoke: the cut's buckets {p1_sizes} / "
                         f"{p2_sizes}")
    metric = sequence_loss_metric(cut)
    p1_launches = {}

    def eval_fn(params, bx, by):
        # P1's one round evaluates before P2 starts: its launches so far
        if not p1_launches:
            p1_launches.update(all_launches(fu))
        return metric(params, bx, by)

    init = init_lm(cut, SEED, "cuda")
    fu.reset_launch_counts()
    res = run_pod_training(cut, data, cyclic_rounds=1, fl_rounds=1,
                           clients_per_round=MOE_K, spec=moe_spec(),
                           mesh=mesh, seed=SEED, eval_fn=eval_fn,
                           eval_batch=16, init_params=init)
    launches = all_launches(fu)
    p2_launches = {k: launches[k] - p1_launches[k] for k in launches}
    zero = dict.fromkeys(launches, 0)
    nb = len(MOE_CUT_SLICE)     # one launch a bucket, in P1 and in P2
    want_p1 = dict(zero, local_step=MOE_K * 2 * nb)
    want_p2 = dict(zero, local_step=MOE_K * 2 * nb, delta_accum=MOE_K * nb,
                   server_update=nb)
    p1 = res.schedule.phases[0].result.params
    p1_still = [path for path, a, b in zip(tree_paths(shapes),
                                           tree_leaves(init),
                                           tree_leaves(p1))
                if torch.equal(a, b)]
    n_leaves = len(mask)
    del init

    def p2_round(impl, **kw):
        c = PodFLConfig(mesh, rounds=1, clients_per_round=MOE_K,
                        seed=SEED + 17, spec=moe_spec(update_impl=impl, **kw))
        return run_pod_rounds(task, data, c, init_params=p1)

    with Deterministic(torch) as det:
        fu.reset_launch_counts()
        fused = p2_round("fused")
        plain = p2_round("fused_interpret")
        again = p2_round("fused")
        fu.reset_launch_counts()
        pod_m = p2_round("fused", server_opt="momentum")
        pod_launches = all_launches(fu)
        fu.reset_launch_counts()
        host = run_rounds(task, data, AggregateStrategy(
            spec=LocalSpec(n_steps=2, batch_size=8, lr=0.03,
                           update_impl="fused", peft=MOE_PEFT,
                           trainable_filter=MOE_FILTER),
            participation=MOE_K / data.n_clients, server_opt="momentum"),
            RoundSchedule(rounds=1, lr_decay=1.0, eval_every=0,
                          seed=SEED + 17, chunk_size=4), init_params=p1)
        host_launches = all_launches(fu)
    exact = not det.nondeterministic

    def agree(a, b):
        return same_leaves(torch, a, b) if exact else ulp_close(torch, a, b)
    fused_plain = agree(fused.params, plain.params)
    repeat = agree(fused.params, again.params) and \
        [h["local_loss"] for h in fused.history] == \
        [h["local_loss"] for h in again.history]
    host_loss_bitwise = [h["local_loss"] for h in host.history] == \
        [h["local_loss"] for h in pod_m.history]
    host_ok = ulp_close(torch, host.params, pod_m.params)
    host_gap = max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(tree_leaves(host.params), tree_leaves(pod_m.params)))
    emit(dict(phase="moe_cut_train", model=cut.name, n_layers=cut.n_layers,
              p1_buckets=p1_sizes, p2_slice=MOE_CUT_SLICE,
              history=res.history, launches_p1=p1_launches,
              expected_p1=want_p1, launches_p2=p2_launches,
              expected_p2=want_p2, p1_leaves_moved=n_leaves - len(p1_still),
              leaves=n_leaves, p1_leaves_unmoved=p1_still, deterministic=dict(
                  nondeterministic_ops=det.nondeterministic,
                  gates="bitwise" if exact else "2 bf16 ulps"),
              fused_equals_plain=fused_plain, repeat_equal=repeat,
              host_vs_pod=dict(server_opt="momentum", rounds=1,
                               tol="2 bf16 ulps", within_tol=host_ok,
                               max_abs_diff=host_gap,
                               losses_bitwise=host_loss_bitwise,
                               host_launches=host_launches,
                               pod_launches=pod_launches),
              phase_s=time.perf_counter() - t_phase))
    if p1_launches != want_p1 or p2_launches != want_p2:
        raise SystemExit(f"chip_smoke: moe_cut_train launches P1 "
                         f"{p1_launches} P2 {p2_launches}")
    if any("norm" not in path for path in p1_still):
        raise SystemExit(f"chip_smoke: the cut's P1 left leaves other than "
                         f"norm scales bitwise their init: {p1_still}")
    if not (fused_plain and repeat):
        raise SystemExit("chip_smoke: moe_cut_train's kernels and plain path "
                         "or its repeat runs disagree")
    if not (host_ok and host_loss_bitwise):
        raise SystemExit("chip_smoke: moe_cut_train's host engine and pod "
                         "disagree")
    if host_launches["weighted_delta"] != nb or \
            host_launches["server_update"] != nb:
        raise SystemExit(f"chip_smoke: the host engine's P2 round launched "
                         f"{host_launches}")
    del res, p1, fused, plain, again, pod_m, host
    torch.cuda.empty_cache()
    return dict(cut_p1=p1_launches, cut_p2=p2_launches, host=host_launches)


def train_batch(torch, cfg, S: int, gen) -> dict:
    """A batch of ZOO_TRAIN_B rows with labels on the card: S tokens
    (with the config's n_prefix_tokens patch embeddings before them in
    vlm mode), or S frame embeddings and n_codebooks labels a frame."""
    B, dev = ZOO_TRAIN_B, "cuda"

    def ids(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    if cfg.input_mode == "tokens":
        return {"tokens": ids(B, S), "labels": ids(B, S)}
    if cfg.input_mode == "vlm":
        return {"patch_embeds": normal(B, cfg.n_prefix_tokens, cfg.d_model),
                "tokens": ids(B, S), "labels": ids(B, S)}
    return {"frame_embeds": normal(B, S, cfg.d_model),
            "labels": ids(B, S, cfg.n_codebooks)}


def micro_gaps(torch, a, b) -> dict:
    """Per leaf max|a - b| / (max|a| + 1e-6), as
    tests/test_smoke_archs.py measures n_micro 2 against 1, by path."""
    from repro_torch.utils.tree_math import tree_leaves, tree_paths
    return {path: float((x.float() - y.float()).abs().max()
                        / (x.float().abs().max() + 1e-6))
            for path, x, y in zip(tree_paths(a), tree_leaves(a),
                                  tree_leaves(b))}


def worst_gaps(gaps: dict, n: int = 4) -> list:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def micro_gaps_f32(torch, cfg, batch) -> dict:
    """n_micro 2 against 1 as tests/test_smoke_archs.py holds them, in
    its dtype (the reduced configs are f32): one step from the seed's
    f32 params at full width on the same batch.  In bf16 the measure is
    ill-posed on zero-init leaves whose gradient is rounding noise: a key
    bias's is 0 in exact arithmetic (softmax is shift-invariant), so
    there max|diff| / max|p| compares noise with noise (zoo_train
    reports the bf16 gaps beside)."""
    import dataclasses
    from repro_torch.launch.steps import (TrainSpec, init_momentum,
                                          make_train_step)
    from repro_torch.models.transformer import init_lm
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    params = init_lm(cfg32, SEED, "cuda")
    mom = init_momentum(params)
    b32 = {k: v.float() if v.is_floating_point() else v
           for k, v in batch.items()}
    one, _, _ = make_train_step(cfg32, TrainSpec(lr=ZOO_TRAIN_LR))(
        params, mom, b32)
    two, _, _ = make_train_step(cfg32, TrainSpec(
        lr=ZOO_TRAIN_LR, n_micro=2))(params, mom, b32)
    gaps = micro_gaps(torch, one, two)
    del params, mom, one, two
    torch.cuda.empty_cache()
    return gaps


def checkpoint_round_trip(torch, tree) -> dict:
    """CheckpointManager(keep=2) under a temporary directory: save
    ``tree`` (copied to the host once per leaf), restore it to the card,
    every leaf bitwise, dtypes included; seconds and bytes."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, load_metadata
    from repro_torch.utils.tree_math import tree_leaves
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(d, keep=2)
        t0 = time.perf_counter()
        path = mgr.save(ZOO_TRAIN_STEPS, tree, metadata={"arch": "zoo"})
        save_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = mgr.restore(device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ok = all(x.dtype == y.dtype and x.device == y.device and
                 bool(torch.equal(x, y))
                 for x, y in zip(tree_leaves(tree), tree_leaves(back)))
        meta = load_metadata(path)
        del back
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return dict(bitwise=ok, file_bytes=n_bytes, save_s=save_s, load_s=load_s,
                metadata=meta,
                dtypes=sorted({str(t.dtype)[6:] for t in tree_leaves(tree)}))


def zoo_train(torch) -> dict:
    """Phase zoo_train: ``launch.steps.make_train_step`` at full width,
    bf16 params and f32 momentum (TrainSpec lr ZOO_TRAIN_LR, momentum
    0.9), batch ZOO_TRAIN_B: internvl2-1b (256 patch embeddings + 256
    tokens), musicgen-medium (512 frames, 4 codebooks) and the 3-layer
    cut of deepseek-v2-lite-16b (256 tokens).  Gates: 4 steps on one
    batch lower its loss; one n_micro 2 step equals the n_micro 1 step
    within ZOO_MICRO_TOL (tests/test_smoke_archs.py's measure, in its
    f32: micro_gaps_f32; the bf16 gaps reported beside); a
    CheckpointManager(keep=2) round trip of internvl2-1b's params and
    momentum after its steps bitwise on every leaf.  Reported: ms a
    step, peak memory, the checkpoint's seconds and bytes."""
    import dataclasses
    from repro_torch.configs import get_config, param_count
    from repro_torch.launch.steps import (TrainSpec, init_momentum,
                                          make_train_step)
    from repro_torch.models.transformer import init_lm, lm_loss

    out = {}
    for arch, n_layers, S in ZOO_TRAIN:
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_lm(cfg, SEED, "cuda")
        mom = init_momentum(params)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch = train_batch(torch, cfg, S, gen)
        step = make_train_step(cfg, TrainSpec(lr=ZOO_TRAIN_LR))
        losses, ms = [], []
        p, m = params, mom
        for i in range(ZOO_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, m, met = step(p, m, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
            if i == 0:
                first = p
        with torch.no_grad():
            final = float(lm_loss(p, cfg, batch)[0])
        p2, _, met2 = make_train_step(cfg, TrainSpec(
            lr=ZOO_TRAIN_LR, n_micro=2))(params, mom, batch)
        tol = ZOO_MICRO_TOL["moe" if cfg.is_moe else "other"]
        bf16_gaps = worst_gaps(micro_gaps(torch, first, p2))
        peak = torch.cuda.max_memory_allocated()
        del params, mom, first, p2
        ckpt = checkpoint_round_trip(torch, {"params": p, "momentum": m}) \
            if arch == "internvl2-1b" else None
        del p, m
        torch.cuda.empty_cache()
        f32_gaps = micro_gaps_f32(torch, cfg, batch)
        gap = max(f32_gaps.values())
        ok = all(math.isfinite(x) for x in losses + [final]) and \
            final < losses[0] and gap < tol and \
            (ckpt is None or ckpt["bitwise"])
        emit(dict(phase="zoo_train", model=cfg.name, n_layers=cfg.n_layers,
                  params=param_count(cfg), dtype=str(cfg.dtype)[6:],
                  momentum_dtype="float32", batch=ZOO_TRAIN_B,
                  positions=S + (cfg.n_prefix_tokens if cfg.input_mode ==
                                 "vlm" else 0), lr=ZOO_TRAIN_LR,
                  losses=losses, loss_after=final, ms_per_step=ms,
                  n_micro_2_loss=float(met2["loss"]),
                  n_micro_2_vs_1=dict(
                      dtype="float32", max_rel_gap=gap, tol=tol,
                      worst_leaves=worst_gaps(f32_gaps),
                      bf16_worst_leaves=bf16_gaps),
                  checkpoint=ckpt, peak_memory_bytes=peak, ok=ok,
                  phase_s=time.perf_counter() - t_phase))
        if not ok:
            raise SystemExit(f"chip_smoke: zoo_train {arch} failed its gates")
        out[arch] = dict(ms_per_step=ms[1:], loss=[losses[0], final])
        del batch
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the compile analysis (dryrun, dryrun_check), the pre-sampled pod rounds
# (pod_aot) and ResNet-8's forward (resnet8)
# ---------------------------------------------------------------------------

# (arch, shapes, multi_pod): one dry-run subprocess each
DRYRUN_JOBS = tuple(
    [(a, ("train_4k",) + {"qwen2-1.5b": ("prefill_32k",),
                          "deepseek-v2-lite-16b": ("decode_32k",),
                          "hymba-1.5b": ("long_500k",)}.get(a, ()), False)
     for a in ("qwen3-32b", "qwen1.5-0.5b", "deepseek-v2-lite-16b",
               "internvl2-1b", "qwen2-1.5b", "hymba-1.5b",
               "deepseek-v3-671b", "mamba2-1.3b", "musicgen-medium",
               "tinyllama-1.1b")]
    + [("tinyllama-1.1b", ("train_4k",), True),
       ("deepseek-v3-671b", ("train_4k",), True)])
DRYRUN_PARALLEL = 5
CHECK_ARCH, CHECK_B, CHECK_S = "tinyllama-1.1b", 8, 512
AOT_K, AOT_STEPS, AOT_B, AOT_S, AOT_TOL = 2, 2, 8, 128, 3e-5
RESNET8_B, RESNET8_CLASSES, RESNET8_TOL = 64, 20, 1e-4


def _subprocess_env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")


def start_captures(out: str):
    """The dry-run jobs and dryrun_check's lower_pod_round, started in
    subprocesses (DRYRUN_PARALLEL at a time, on the host's cores), so
    they run while the card runs the phases from llm_lora on.
    Returns the futures: (job, rc, start, end, stderr) each."""
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=DRYRUN_PARALLEL)

    def run(job):
        if job == "lower":
            cmd = [sys.executable, str(ROOT / "chip_smoke.py"),
                   "--lower-pod-round", out]
        else:
            arch, shapes, multi = job
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", *shapes, "--out", out,
                   "--no-correct-scan"] + (["--multi-pod"] if multi else [])
        t0 = time.perf_counter()
        p = subprocess.run(cmd, env=_subprocess_env(), capture_output=True,
                           text=True, timeout=600)
        return job, p.returncode, t0, time.perf_counter(), p.stderr[-3000:]
    futures = [pool.submit(run, job) for job in ("lower",) + DRYRUN_JOBS]
    pool.shutdown(wait=False)
    return futures


def lower_pod_round_worker(out: str) -> int:
    """``chip_smoke.py --lower-pod-round OUT``: lower_pod_round of
    pod_sharded's configuration, of pod_sharded_moe's cut and of
    pod_sharded_zoo's hymba-1.5b + lora:8 on a fake (2, 2) mesh under
    fsdp_tp, the cyclic and the fl round each, into
    ``OUT/lowered.json``."""
    import dataclasses
    from repro_torch.configs import get_config, with_peft
    from repro_torch.launch.mesh import destroy, make_fake_mesh
    from repro_torch.launch.train import PodFLSpec, lower_pod_round
    mesh = make_fake_mesh(SHARDED_MESH, ("data", "model"))
    runs = {"pod_sharded": (llm_setup_config(), PodFLSpec(
        local_steps=SHARDED_STEPS, batch_size=SHARDED_BATCH, lr=0.03,
        update_impl="fused", peft=LLM_PEFT)),
        "pod_sharded_moe": (dataclasses.replace(
            moe_setup_config(), n_layers=MOE_CUT_LAYERS), moe_spec(
            local_steps=SHARDED_STEPS, batch_size=SHARDED_BATCH)),
        "pod_sharded_zoo": (with_peft(get_config(ZOO_ARCH), ZOO_PEFT),
                            PodFLSpec(local_steps=ZOO_STEPS,
                                      batch_size=SHARDED_BATCH, lr=0.03,
                                      update_impl="fused", peft=ZOO_PEFT))}
    res = {}
    for name, (cfg, spec) in runs.items():
        for kind in ("cyclic", "fl"):
            t0 = time.perf_counter()
            c = lower_pod_round(cfg, mesh, kind=kind, spec=spec,
                                K=SHARDED_K, batch=SHARDED_BATCH, seq=128,
                                layout="fsdp_tp", seed=SEED)
            res.setdefault(name, {})[kind] = dict(
                collectives=c.collectives,
                collective_bytes=c.collective_bytes, flops=c.flops,
                bytes=c.bytes, kernels=c.kernels,
                capture_s=time.perf_counter() - t0)
    destroy()
    Path(out, "lowered.json").write_text(json.dumps(res))
    return 0


def finish_dryrun(futures, out: str, smi: str) -> dict:
    """Phase dryrun: one line a pair, gated on every pair ok; returns
    the lower_pod_round result for dryrun_check (b).  ``wall_s`` is the
    subprocesses' span, ``phase_s`` the wait for them here."""
    t_phase = time.perf_counter()
    failed, job_s, span = [], {}, []
    for f in futures:
        job, rc, t0, t1, err = f.result()
        job_s[job if job == "lower" else
              f"{job[0]} {'2x16x16' if job[2] else '16x16'}"] = t1 - t0
        span += [t0, t1]
        if rc != 0:
            failed.append(f"{job}: exit {rc}: {err}")
    rows = [json.loads(p.read_text()) for p in sorted(Path(out).glob(
        "*_16x16.json")) + sorted(Path(out).glob("*_2x16x16.json"))]
    keys = ("arch", "shape", "mesh", "ok", "hlo_flops_per_chip",
            "hlo_bytes_per_chip", "collective_bytes_per_chip",
            "collective_detail", "collective_counts", "t_compute_s",
            "t_memory_s", "t_collective_s", "bottleneck", "model_flops",
            "useful_flops_ratio", "tp_compute", "t_capture_s", "kernels",
            "error")
    for row in rows:
        emit(dict(phase="dryrun", card=smi,
                  **{k: row[k] for k in keys if k in row}))
    want = sum(len(shapes) for _, shapes, _ in DRYRUN_JOBS)
    bad = [f"{r['arch']} {r['shape']} {r['mesh']}" for r in rows
           if not r["ok"]]
    emit(dict(phase="dryrun", summary=True, pairs=len(rows), want=want,
              ok=len(rows) - len(bad), processes=DRYRUN_PARALLEL,
              process_s=job_s, wall_s=max(span) - min(span),
              phase_s=time.perf_counter() - t_phase, card=smi))
    if failed or bad or len(rows) != want:
        raise SystemExit(f"chip_smoke: dryrun: {len(rows)}/{want} rows, "
                         f"not ok: {bad}; {failed}")
    return json.loads(Path(out, "lowered.json").read_text())


def dryrun_check_step(torch, smi: str) -> dict:
    """Phase dryrun_check (a): tinyllama-1.1b's train step at CHECK_B x
    CHECK_S captured on fake tensors, then run on the card under the same
    counter; FLOPs and bytes must agree exactly.  The warm step is timed
    with CUDA events (median of 5) beside its roofline terms."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config, param_count, params_specs
    from repro_torch.launch.hlo_analysis import StepCounter, analyze_captured
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.launch.steps import (TrainSpec, init_momentum,
                                          make_train_step)
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils import tree_math as tm
    t_phase = time.perf_counter()
    cfg = get_config(CHECK_ARCH)
    step = make_train_step(cfg, TrainSpec())
    B, S = CHECK_B, CHECK_S
    with FakeTensorMode():
        params = tm.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                             params_specs(cfg))
        mom = init_momentum(params)
        batch = {k: torch.empty((B, S), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        with StepCounter() as cap:
            step(params, mom, batch)
    capture_s = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, SEED, "cuda")
    mom = init_momentum(params)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    with StepCounter() as card:
        _, _, met = step(params, mom, batch)
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step(params, mom, batch)
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    step_ms = statistics.median(ms)
    n = param_count(cfg)
    model_flops = 6.0 * n * B * S
    terms = analyze_captured(cap, arch=CHECK_ARCH, shape=f"train {B}x{S}",
                             mesh_name="1 card", n_chips=1,
                             model_flops=model_flops)
    ok = (cap.flops, cap.bytes) == (card.flops, card.bytes) and \
        math.isfinite(float(met["loss"]))
    out = dict(phase="dryrun_check", part="capture_vs_card",
               model=CHECK_ARCH, batch=B, seq=S, dtype=str(cfg.dtype)[6:],
               capture=dict(flops=cap.flops, bytes=cap.bytes),
               card_run=dict(flops=card.flops, bytes=card.bytes),
               equal=ok, capture_s=capture_s, step_ms=step_ms,
               step_ms_all=ms, t_compute_s=terms.t_compute,
               t_memory_s=terms.t_memory, bottleneck=terms.bottleneck,
               model_flops=model_flops,
               model_flops_share=model_flops / (step_ms * 1e-3
                                                * PEAK_FLOPS_BF16),
               counted_flops_share=cap.flops / (step_ms * 1e-3
                                                * PEAK_FLOPS_BF16),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               card=smi, phase_s=time.perf_counter() - t_phase)
    emit(out)
    del params, mom, batch
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"chip_smoke: dryrun_check: the capture counts "
                         f"{cap.flops} FLOPs / {cap.bytes} B, the card run "
                         f"{card.flops} / {card.bytes}")
    return out


def dryrun_check_collectives(lowered: dict, ranks: list, moe_ranks: list,
                              zoo_ranks: list, smi: str) -> None:
    """Phase dryrun_check (b): lower_pod_round's cyclic + fl collectives
    and bytes, by kind, against what each pod_sharded rank, each
    pod_sharded_moe rank (the cut's run) and each pod_sharded_zoo rank
    (hymba-1.5b's P1 + P2) counted under fsdp_tp in this run, the "tp"
    and "moe" kinds included."""
    bad = []
    for name, rks in (("pod_sharded", ranks), ("pod_sharded_moe", moe_ranks),
                      ("pod_sharded_zoo", zoo_ranks)):
        low = lowered[name]
        got = {key: {k: low["cyclic"][key][k] + low["fl"][key][k]
                     for k in low["fl"][key]}
               for key in ("collectives", "collective_bytes")}
        off = [rk["rank"] for rk in rks
               if rk["fsdp_tp"]["collectives"] != got["collectives"]
               or rk["fsdp_tp"]["collective_bytes"] !=
               got["collective_bytes"]]
        emit(dict(phase="dryrun_check", part=f"lower_pod_round_vs_{name}",
                  lowered=got, lowered_rounds=low,
                  rank0=dict(collectives=rks[0]["fsdp_tp"]["collectives"],
                             collective_bytes=rks[0]["fsdp_tp"][
                                 "collective_bytes"]),
                  ranks_equal=[rk["rank"] for rk in rks
                               if rk["rank"] not in off], card=smi))
        if off:
            bad.append(f"{name}: lower_pod_round's {got} differ from ranks "
                       f"{off}")
    if bad:
        raise SystemExit("chip_smoke: dryrun_check: " + "; ".join(bad))


def pod_aot(torch, smi: str) -> dict:
    """Phase pod_aot: the pre-sampled rounds at full width (f32, so the
    P2 check compares f32 sums, not bf16 roundings of them)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils import tree_math as tm
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(LLM_ARCH), dtype=torch.float32,
                              param_dtype=torch.float32)
    spec = train.PodFLSpec(local_steps=AOT_STEPS, batch_size=AOT_B, lr=0.03)
    params = init_lm(cfg, SEED, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (AOT_K, AOT_STEPS, AOT_B,
                                             AOT_S + 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    batches = {"tokens": toks[..., :-1].contiguous(),
               "labels": toks[..., 1:].contiguous()}
    weights = torch.tensor([3.0, 5.0], device="cuda")
    lr = torch.tensor(1.0, device="cuda")
    local = train._local_sgd(cfg, spec)

    def client(i):
        return {k: v[i] for k, v in batches.items()}
    with Deterministic(torch) as det:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p1, m1 = train.make_pod_cyclic_round(cfg, spec)(params, batches, lr)
        torch.cuda.synchronize()
        p1_ms = (time.perf_counter() - t0) * 1e3
        chain = params
        for i in range(AOT_K):
            chain, _ = local(chain, client(i), lr, None)
        p1_bitwise = all(torch.equal(a, b) for a, b in zip(
            tm.tree_leaves(p1), tm.tree_leaves(chain)))
    del p1, chain
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, m2 = train.make_pod_fl_round(cfg, spec)(params, batches, weights, lr)
    torch.cuda.synchronize()
    p2_ms = (time.perf_counter() - t0) * 1e3
    want = None
    for i in range(AOT_K):
        end, _ = local(params, client(i), lr, None)
        c = weights[i] / weights.sum()
        want = tm.tree_map(lambda e: c * e, end) if want is None else \
            tm.tree_map(lambda a, e: a + c * e, want, end)
        del end
    err, ok = 0.0, True
    for a, b in zip(tm.tree_leaves(p2), tm.tree_leaves(want)):
        gap = (a - b).abs()
        err = max(err, float(gap.max()))
        ok &= bool((gap <= AOT_TOL + AOT_TOL * b.abs()).all())
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(
        tm.tree_leaves(p2), tm.tree_leaves(params)))
    losses = [float(m1["local_loss"]), float(m2["local_loss"])]
    out = dict(phase="pod_aot", model=f"{LLM_ARCH} (f32)", K=AOT_K,
               local_steps=AOT_STEPS, batch=AOT_B, seq=AOT_S,
               p1_bitwise=p1_bitwise, nondeterministic=det.nondeterministic,
               p2_max_abs_err=err, p2_tol=AOT_TOL, p2_within_tol=ok,
               leaves_moved=moved, losses=losses, p1_ms=p1_ms, p2_ms=p2_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi,
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    del params, p2, want, batches
    torch.cuda.empty_cache()
    if not (p1_bitwise and ok and moved > 0 and
            all(math.isfinite(x) for x in losses)):
        raise SystemExit(f"chip_smoke: pod_aot failed its gates: {out}")
    return out


def resnet8_phase(torch, smi: str) -> dict:
    """Phase resnet8: the forward on the card against the CPU, TF32 off."""
    from repro_torch.models.paper_models import resnet8_apply, resnet8_init
    from repro_torch.utils import tree_math as tm
    t_phase = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, bad = {}, []
    try:
        for norm in ("batch", "group"):
            gen = torch.Generator().manual_seed(SEED)
            params = resnet8_init(gen, n_classes=RESNET8_CLASSES, norm=norm)
            x = torch.randn(RESNET8_B, 32, 32, 3, generator=gen)
            want = resnet8_apply(params, x)
            pc = tm.tree_map(lambda t: t.cuda() if isinstance(
                t, torch.Tensor) else t, params)
            xc = x.cuda()
            got = resnet8_apply(pc, xc).cpu()
            err = float((got - want).abs().max())
            ok = bool(((got - want).abs() <= RESNET8_TOL
                       + RESNET8_TOL * want.abs()).all())
            ms = time_ms(torch, lambda: resnet8_apply(pc, xc))
            rows[norm] = dict(max_abs_err=err, within_tol=ok, ms=ms,
                              logits_shape=list(got.shape))
            if not ok:
                bad.append(norm)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    out = dict(phase="resnet8", batch=RESNET8_B, image="32x32x3",
               classes=RESNET8_CLASSES, tf32=False, tol=RESNET8_TOL,
               norms=rows, card=smi, phase_s=time.perf_counter() - t_phase)
    emit(out)
    if bad:
        raise SystemExit(f"chip_smoke: resnet8 disagrees with the CPU "
                         f"under {bad}: {rows}")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port "
                                 "on one NVIDIA GPU (see the module doc).")
    # one rank of pod_sharded, pod_sharded_moe or pod_sharded_zoo, spawned
    # by that phase
    ap.add_argument("--pod-sharded-rank", nargs=3, default=None,
                    metavar=("RANK", "STORE", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--pod-sharded-moe-rank", nargs=3, default=None,
                    metavar=("RANK", "STORE", "OUT"), help=argparse.SUPPRESS)
    # pod_sharded_moe alone, with its control run (a planted fault that
    # the params gate must refuse): how the gate was placed
    ap.add_argument("--pod-sharded-moe-control", action="store_true",
                    help="run the pod_sharded_moe phase alone, with its "
                    "control")
    ap.add_argument("--pod-sharded-zoo-rank", nargs=3, default=None,
                    metavar=("RANK", "STORE", "OUT"), help=argparse.SUPPRESS)
    # dryrun_check's lower_pod_round, spawned by the dryrun phase
    ap.add_argument("--lower-pod-round", default=None, metavar="OUT",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.lower_pod_round is not None:
        return lower_pod_round_worker(args.lower_pod_round)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.pod_sharded_rank is not None:
        rank, store, out = args.pod_sharded_rank
        return pod_sharded_worker(int(rank), store, out)
    if args.pod_sharded_moe_rank is not None:
        rank, store, out = args.pod_sharded_moe_rank
        return pod_sharded_moe_worker(int(rank), store, out)
    if args.pod_sharded_zoo_rank is not None:
        rank, store, out = args.pod_sharded_zoo_rank
        return pod_sharded_zoo_worker(int(rank), store, out)
    if args.pod_sharded_moe_control:
        from repro_torch.kernels import library
        library.build_library()
        pod_sharded_moe(torch, control=True)
        return 0
    from repro_torch.kernels import fused_update as fu

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    from repro_torch.kernels import library
    lib_path, build_s = library.build_library()
    emit(dict(phase="env", nvidia_smi=smi, device=name,
              torch=torch.__version__, cuda=torch.version.cuda,
              kernel_sources=[src.name for src in library.sources()],
              kernel_build_s=build_s))
    sass = sass_features(lib_path)
    emit(sass)
    if sass["cuobjdump"] and not (sass["prefill_hgmma"] and
                                  sass["prefill_tma"]):
        raise SystemExit("chip_smoke: K7's prefill kernel issues no HGMMA "
                         "or no UTMALDG")
    if sass["cuobjdump"] and not sass["ssd_bf16_hmma"]:
        raise SystemExit("chip_smoke: a bf16 kernel of K8 issues no HMMA")
    if sass["cuobjdump"] and not (sass["topk_cluster_barrier"] and
                                  sass["topk_dsmem"]):
        raise SystemExit("chip_smoke: the cluster threshold has no cluster "
                         "barrier or no st.async into distributed shared "
                         "memory")
    if sass["cuobjdump"] and not sass["local_step_pdl_wait"]:
        raise SystemExit("chip_smoke: K1 does not wait on griddepcontrol")
    # 2 alignments x (the threshold alone + bits 8/16/32 x residual)
    if sass["cuobjdump"] and not (sass["topk_fused_cluster"] and
                                  sass["topk_fused_instances"] == 12 and
                                  sass["topk_instances"] == 14):
        raise SystemExit("chip_smoke: the fused top-k compressed upload's "
                         "instances lack the cluster barrier or st.async")
    if sass["cuobjdump"] and not sass["delta_accum_pdl_wait"]:
        raise SystemExit("chip_smoke: K6 does not wait on griddepcontrol")
    if sass["cuobjdump"] and not sass["compress_delta_pdl_wait"]:
        raise SystemExit("chip_smoke: K4 does not wait on griddepcontrol")
    if sass["cuobjdump"] and not (sass["server_update_pdl_wait"] and
                                  sass["dp_clip_noise_pdl_wait"] and
                                  sass["pdl_instances"] == SASS_INSTANCES):
        raise SystemExit("chip_smoke: an instance of K3 or K5 does not wait "
                         "on griddepcontrol, or one is missing: "
                         f"{sass['pdl_instances']}")
    bench = KernelBench(torch, fu, card_peaks(name))
    main_shapes = check_kernels(torch, fu, bench)
    local_step_vs_add(torch, fu, bench)
    upload_shapes = check_upload_kernels(torch, bench)
    pod_shapes = check_pod_kernels(torch, bench)
    charlm_shapes = check_charlm_kernels(torch, bench)
    llm_shapes = check_llm_kernels(torch, bench)
    moe_shapes = check_moe_kernels(torch, bench)
    sharded_shapes = check_sharded_kernels(torch, bench)
    sharded_moe_shapes = check_sharded_moe_kernels(torch, bench)
    attn_shapes = check_attention_kernels(torch, bench)
    launches, p1_params, main_res = main_path(torch, fu)
    algo_c_launches = p2_algorithms(torch, fu, p1_params)
    fused_vs_plain(torch)
    configs = upload_configs()
    comp_launches, _ = upload_phase(torch, fu, "p2_compressed",
                                    configs["p2_compressed"])
    _, private = upload_phase(torch, fu, "p2_private", configs["p2_private"])
    dp_launches = dp_upload(torch, fu, private.federated.params,
                            configs["p2_private"])
    int8_launches, _ = upload_phase(torch, fu, "p2_int8", configs["p2_int8"])
    p2_rounds(torch, private.cyclic.params)
    charlm_launches, charlm_p1 = charlm_path(torch, fu)
    charlm_comp_launches = charlm_compressed(torch, fu, charlm_p1)
    fashion_launches = fashion_path(torch, fu)
    from repro_torch.launch.mesh import destroy, make_host_mesh
    mesh = make_host_mesh()
    pod_launches, pod_p1 = pod_path(torch, fu, mesh)
    pod_hierarchical(torch, fu, mesh, pod_p1)
    pod_comp_launches = pod_compressed(torch, fu, mesh, pod_p1)
    pod_vs_host(torch, mesh)
    pod_c_launches = pod_algorithms(torch, fu, mesh)
    pod_rounds(torch, mesh, pod_p1)
    client_store(torch, fu, p1_params, mesh)
    landscape(torch, fig7_states(torch, main_res))
    del main_res
    # the dry run's captures run on the host's cores beside the phases
    # that time whole steps, never beside the kernel phase's rows
    import tempfile
    dry_out = tempfile.mkdtemp(prefix="dryrun_")
    captures = start_captures(dry_out)
    llm_launches = llm_lora(torch, fu, mesh)
    eng, prompt, tokens, serve_launches, per_phase = serve(torch)
    serve_e2e(torch, eng, prompt, tokens[:, :E2E_STEPS])
    k8_kernels = serve_profile(torch, eng, prompt)
    del eng, prompt, tokens
    moe_launches = moe_serve(torch)
    zoo_launches = zoo_serve(torch)
    qwen_launches = qwen_serve(torch)
    moe_train_launches = moe_train(torch, fu, mesh)
    zoo_train(torch)
    sharded_launches, sharded_ranks = pod_sharded(torch)
    sharded_moe_launches, sharded_moe_ranks = pod_sharded_moe(torch)
    zoo_ranks = pod_sharded_zoo(torch)
    lowered = finish_dryrun(captures, dry_out, smi)
    dryrun_check_collectives(lowered, sharded_ranks, sharded_moe_ranks,
                             zoo_ranks, smi)
    dryrun_check_step(torch, smi)
    pod_aot(torch, smi)
    resnet8_phase(torch, smi)

    source = "src/repro_torch/kernels/csrc/fused_update.cu"
    replaces = {"local_step": "src/repro/kernels/fused_update.py:131",
                "weighted_delta": "src/repro/kernels/fused_update.py:199",
                "server_update": "src/repro/kernels/fused_update.py:475"}
    kernels = []
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "library_note", "max_abs_err")
    for kname, r in main_shapes.items():
        if r["max_abs_err"] > KERNEL_TOL or not r.get("bitwise", True):
            raise SystemExit(f"chip_smoke: {kname} disagrees: {r}")
        if kname not in replaces:
            continue
        kernels.append(dict(name=kname, route="cuda", source=source,
                            replaces=replaces[kname],
                            launches=launches[kname],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            **({"pdl": True} if kname != "weighted_delta"
                               else {})))
    # K1-K3 at CharLSTM-256's bucket (charlm_path), with their launches
    # there and on fashion_path
    for k in kernels:
        r = charlm_shapes[k["name"]]
        k["charlm"] = dict({key: r[key] for key in timing}, n=N_CHARLM,
                           l2=r["l2"], cold_floor_ms=r["cold_floor_ms"],
                           launches=charlm_launches[k["name"]],
                           path="charlm_path")
        k["fashion_path_launches"] = fashion_launches[k["name"]]
    # K1 with SCAFFOLD's correction c (a row view of the round's (K, N)
    # c - c_i stack) on p2_algorithms and pod_algorithms
    rc = main_shapes["local_step_c"]
    next(k for k in kernels if k["name"] == "local_step").update(
        c_form=dict({k: rc[k] for k in timing},
                    launches={"p2_algorithms": algo_c_launches["scaffold"],
                              "pod_algorithms": pod_c_launches}))
    # K3 on the main path is the aggregate form under FedAvgM (no PyTorch
    # call forms avg - p and applies momentum: library_ms null); the delta
    # form, the pod's apply ("none") and FedAdam's aggregate form beside it
    k3 = next(k for k in kernels if k["name"] == "server_update")
    k3.update(form="avg", opt="momentum",
              chain_ms=main_shapes["server_update"]["chain_ms"],
              library_note=main_shapes["server_update"]["library_note"],
              pod_path_launches=pod_launches["server_update"],
              **{tag: {k: main_shapes[f"server_update_{tag}"][k]
                       for k in timing}
                 for tag in ("delta", "none", "adam")})
    # the upload kernels, each with the launches of the path it is on:
    # the top-k upload is one fused launch on the main compressed path (K4
    # and the threshold in one); above the cut, on charlm_compressed, the
    # threshold's four radix launches and K4 alone with top-k and the
    # residual; K4 alone without top-k on the int8 dense path
    upload_src = "src/repro_torch/kernels/csrc/upload.cu"
    threshold_cluster = upload_shapes["topk_threshold"]
    upload_shapes["topk_threshold"] = charlm_shapes["topk_threshold"]
    for kname, replaces, n_launch, path in (
            ("compress_delta", "src/repro/kernels/fused_update.py:283",
             int8_launches["compress_delta"], "p2_int8"),
            ("topk_threshold", "jnp src/repro/fl/compression.py:156",
             charlm_comp_launches["topk_threshold"], "charlm_compressed"),
            ("dp_clip_noise", "src/repro/kernels/fused_update.py:351",
             dp_launches["dp_clip_noise"], "dp_upload"),
            ("topk_compress", "src/repro/kernels/fused_update.py:283 + "
             "jnp src/repro/fl/compression.py:156",
             comp_launches["topk_compress"], "p2_compressed")):
        r = upload_shapes[kname]
        if not r["bitwise"]:
            raise SystemExit(f"chip_smoke: {kname} disagrees: {r}")
        shape = {key: r[key] for key in (
            "n", "K", "form", "bits", "topk", "residual", "kernel_path",
            "n_ctas", "dynamic_smem_per_cta", "launches_per_call",
            "chain_ms", "threshold_ms", "l2", "cold_floor_ms") if key in r}
        kernels.append(dict(name=kname, route="cuda", source=upload_src,
                            replaces=replaces, launches=n_launch,
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"], path=path, **shape))
    kernels[-1]["pod_compressed_launches"] = pod_comp_launches["topk_compress"]
    # K5 on dp_upload is the rows form (one launch for the round's 10
    # clients); the per-client form, with and without noise, beside it
    next(k for k in kernels if k["name"] == "dp_clip_noise").update(
        pdl=True, **{tag: {k: upload_shapes[f"dp_clip_noise_{tag}"][k]
                           for k in timing}
                     for tag in ("per_client", "no_noise")})
    # the threshold's row is its radix route at N 814,080 (charlm_compressed);
    # at the main path's bucket it is the cluster kernel, fused into
    # topk_compress on p2_compressed
    if threshold_cluster["launches_per_call"] != 1:
        raise SystemExit(f"chip_smoke: the threshold at N {N_SMALL} did not "
                         f"take its one-launch cluster route: "
                         f"{threshold_cluster}")
    next(k for k in kernels if k["name"] == "topk_threshold").update(
        fused_into="topk_compress", fused_into_on="p2_compressed",
        cluster_form=dict({k: threshold_cluster[k] for k in timing + (
            "n", "kernel_path", "launches_per_call")},
                          launches=comp_launches["topk_threshold"],
                          path="p2_compressed"))
    # K4 with top-k and the residual, alone above the cut (charlm_compressed)
    rk = charlm_shapes["compress_delta"]
    next(k for k in kernels if k["name"] == "compress_delta").update(
        topk_residual_form=dict({k: rk[k] for k in timing}, n=N_CHARLM,
                                l2=rk["l2"],
                                cold_floor_ms=rk["cold_floor_ms"],
                                launches=charlm_comp_launches[
                                    "compress_delta"],
                                path="charlm_compressed"))
    # K6 on the pod path: the f32 form with p (the sequential
    # aggregate), its accum-only form (pod_compressed) beside it
    r, ra = pod_shapes["delta_accum"], pod_shapes["delta_accum_accum_only"]
    if not (r["bitwise"] and ra["bitwise"]):
        raise SystemExit(f"chip_smoke: delta_accum disagrees: {r} {ra}")
    kernels.append(dict(
        name="delta_accum", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_update.cu",
        replaces="src/repro/kernels/fused_update.py:405",
        launches=pod_launches["delta_accum"],
        accum_only_launches=pod_comp_launches["delta_accum"],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], library_note=r["library_note"],
        accum_only={k: ra[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_note")},
        shape="N 137,216 f32, with p", path="pod_path", pdl=True))
    # the bf16 instances of K1, K2, K3 and K6 at llm_lora's buckets, with
    # their launches there: K1 over the whole model in P1 and over the
    # adapters in P2, K6 and K3's apply in the pod's P2, K2 and K3's
    # aggregate form in the host engine's FedAvgM round
    bf16_rows = {
        "local_step": ("local_step", llm_launches["all"]["local_step"],
                       "run_pod_training P1 + P2, N 6,307,840 (P2) and "
                       "1,106,356,224 (P1)"),
        "weighted_delta": ("weighted_delta",
                           llm_launches["host"]["weighted_delta"],
                           "the host engine's P2 round (K 4)"),
        "server_update": ("server_update", llm_launches["host"][
            "server_update"], "the host engine's FedAvgM aggregate form"),
        "delta_accum": ("delta_accum", llm_launches["all"]["delta_accum"],
                        "run_pod_training P2, with p, f32 d"),
    }
    for k in kernels:
        if k["name"] in bf16_rows:
            key, n_launch, where = bf16_rows[k["name"]]
            r = llm_shapes[key]
            k["bf16_form"] = dict({t: r[t] for t in timing}, n=r["n"],
                                  launches=n_launch, path="llm_lora",
                                  where=where)
    k1 = next(k for k in kernels if k["name"] == "local_step")
    r = llm_shapes["local_step_full"]
    k1["bf16_form"]["full_model"] = dict({t: r[t] for t in timing},
                                         n=r["n"],
                                         launches=llm_launches["p1"][
                                             "local_step"])
    k3 = next(k for k in kernels if k["name"] == "server_update")
    r = llm_shapes["server_update_none"]
    k3["bf16_form"]["none"] = dict({t: r[t] for t in timing}, n=r["n"],
                                   launches=llm_launches["all"][
                                       "server_update"])
    # the instances at moe_train's buckets (f32 routers, bf16 adapters),
    # with their launches there: K1, K6 and K3's apply over the
    # full-width slice on the pod; K1 over the 3-layer cut's whole bf16
    # model in its P1; K2 and K3's aggregate form in the cut's
    # host-engine FedAvgM round (launches: both buckets together)
    full, host = moe_train_launches["full"], moe_train_launches["host"]
    moe_rows = {"local_step": ("local_step", full, "run_pod_training P2 "
                               "at full width"),
                "delta_accum": ("delta_accum", full, "run_pod_training P2 "
                                "at full width, with p, f32 d"),
                "server_update": ("server_update_none", full,
                                  "the pod's apply at full width"),
                "weighted_delta": ("weighted_delta", host, "the 3-layer "
                                   "cut's host engine P2 round (K 4)")}
    for k in kernels:
        if k["name"] in moe_rows:
            key, counts, where = moe_rows[k["name"]]
            k["moe_form"] = dict(
                launches=counts[k["name"]], path="moe_train", where=where,
                buckets={dt: dict({t: moe_shapes[f"{key}_{dt}"][t]
                                   for t in timing},
                                  n=moe_shapes[f"{key}_{dt}"]["n"])
                         for dt in MOE_SLICE})
    r = moe_shapes["local_step_cut_p1"]
    next(k for k in kernels if k["name"] == "local_step")["moe_form"][
        "cut_p1"] = dict({t: r[t] for t in timing}, n=r["n"],
                         launches=moe_train_launches["cut_p1"]["local_step"])
    next(k for k in kernels if k["name"] == "server_update")["moe_form"][
        "cut_aggregate"] = dict(
            launches=host["server_update"],
            buckets={dt: dict({t: moe_shapes[f"server_update_{dt}"][t]
                               for t in timing},
                              n=moe_shapes[f"server_update_{dt}"]["n"])
                     for dt in MOE_CUT_SLICE})
    # K1, K6 and K3 at pod_sharded's per-shard rows under fsdp_tp, with
    # rank 0's launches there (P1's row of the base and P2's adapter rows)
    sharded_rows = {"local_step": "local_step", "delta_accum": "delta_accum",
                    "server_update": "server_update"}
    for k in kernels:
        if k["name"] in sharded_rows:
            r = sharded_shapes[sharded_rows[k["name"]]]
            k["sharded_form"] = dict(
                {t: r[t] for t in timing}, n=r["n"], path="pod_sharded",
                launches=sharded_launches[k["name"]],
                where="run_pod_training on a (2, 2) mesh of four gloo "
                      "ranks, fsdp_tp: a rank's row of each bucket")
    r = sharded_shapes["local_step_p1"]
    next(k for k in kernels if k["name"] == "local_step")["sharded_form"][
        "p1_row"] = dict({t: r[t] for t in timing}, n=r["n"])
    # K1, K6 and K3 at pod_sharded_moe's per-shard rows of the cut under
    # fsdp_tp (P2's three rows; K1 also at P1's largest), with rank 0's
    # launches there (P1 + P2)
    for k in kernels:
        if k["name"] in sharded_rows:
            k["sharded_moe_form"] = dict(
                path="pod_sharded_moe",
                launches=sharded_moe_launches[k["name"]],
                where="run_pod_training of deepseek-v2-lite-16b's 3-layer "
                      "cut on a (2, 2) mesh of four gloo ranks, fsdp_tp",
                rows={key[len(k["name"]) + 1:]: dict(
                    {t: r[t] for t in timing}, n=r["n"])
                    for key, r in sharded_moe_shapes.items()
                    if key.startswith(k["name"] + "_")})
    # K7 at its main-path shapes: the row is a sliding-window prefill
    # layer (29 of 32 layers); the global prefill and decode shapes ride
    # along under "shapes"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    fa_main = attn_shapes["prefill_swa"]
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:81",
        launches=serve_launches["flash_attention"],
        **{k: fa_main[k] for k in keys}, tol=fa_main["tol"],
        shape="q (8,2048,25,64) bf16 vs k/v (8,2112,5,64), window 1024",
        shapes={lbl: {k: r[k] for k in keys}
                for lbl, r in attn_shapes.items()
                if lbl not in ("ssd_scan", "mamba2_tp4")},
        launches_per_prefill=per_phase["flash_attention"]["prefill"],
        launches_per_decode_step=per_phase["flash_attention"]["decode_step"],
        zoo_serve_launches=zoo_launches, qwen_serve_launches=qwen_launches,
        moe_serve_launches=moe_launches["flash_attention"]))
    sm = attn_shapes["ssd_scan"]
    kernels.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:81",
        launches=serve_launches["ssd_scan"], **{k: sm[k] for k in keys},
        tol=sm["tol"],
        shape="x (8,2048,50,64) bf16, B/C (8,2048,1,16), chunk 128",
        launches_per_prefill=per_phase["ssd_scan"]["prefill"],
        launches_per_decode_step=per_phase["ssd_scan"]["decode_step"],
        device_kernels_per_prefill=k8_kernels["prefill"],
        device_kernels_per_call=k8_kernels["prefill"]
        / max(1, per_phase["ssd_scan"]["prefill"])))
    # K8 on a rank's 16 SSM heads of mamba2-1.3b served tensor-parallel on
    # (1, 4) (pod_sharded_zoo (b)), with rank 0's launches there
    tp8 = attn_shapes["mamba2_tp4"]
    kernels[-1]["tp_form"] = dict(
        {k: tp8[k] for k in keys}, tol=tp8["tol"],
        shape="x (2,1024,16,64) f32, B/C (2,1024,1,128), chunk 128",
        path="pod_sharded_zoo",
        launches=zoo_ranks[0]["serve"]["ssd_launches"],
        launches_per_prefill=zoo_ranks[0]["serve"][
            "ssd_launches_per_prefill"])
    for k in kernels:
        if k["launches"] <= 0:
            raise SystemExit(f"chip_smoke: {k['name']} never launched on "
                             "its main path")
    emit({"kernels": kernels})
    destroy()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
