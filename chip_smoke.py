#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ee_semantic_segmentation_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. environment: torch/CUDA/nvcc versions, the card's name and power limit
   and its maximum SM clock (the SFU term of kernel B's bound);
2. build: compile the CUDA kernels from ``csrc/`` with nvcc;
3. kernel vs plain version on the card (TF32 off), at the flagship eval
   shape (N=16, 64x64 -> 512x512, C=21), a ragged one and the eval's padded
   last batch (count 4 of 12): argmax maps of kernels B and C, confusion
   counts and entropies must agree, and C's maps equal B's; kernel, plain
   and library times are medians of 20 runs timed with CUDA events, and
   one call of A and one of C split per CUDA kernel; kernels A and C also
   on a trained model's logits and labels (``trained_conf_law``: mostly
   background, ~89 % right, 5 % void), A's time within TOL_A_TRAINED_RATIO
   and C's within TOL_C_TRAINED_RATIO of the uniform law's; then kernels
   B, A and C at their edge cases (40 classes, bf16 logits, H not a
   multiple of the band, W not a multiple of 4, no resize, column tiles),
   and C where no band fits shared memory (20000 classes: it must raise);
   A, B and C also at the 2-exit MobileNetV3's shape (``MNV3_SHAPE``: N=12,
   32x32 -> 512x512, a 16x upsample; f32 timed, bf16 checked), with the
   flagship's checks and kernel, plain, library and bound times;
3b. the sort kernel D vs its plain version (TF32 off) at the flagship's
   Lovász row shapes (63 rows of 2^22, 1008 of 2^18), one and two tiles,
   1024, a ragged row, heavy ties, +-0/+-NaN/+-inf/+-1e30 keys, int32 keys
   with 2^31 - 1 in a ragged row, rows of 3, and permutation keys with a
   float32 payload (the backward's case, also at both flagship shapes):
   keys and payloads must equal ``torch.sort(stable=True)`` + ``gather``'s
   bit for bit (with NaN keys, the CPU's: on CUDA, ``torch.sort`` puts a
   NaN whose sign bit is set first), and at the permutation cases (also
   at the unsort's bucket edges: rows of W - 1, W, W + 1 and 2W + 3 for
   its window W, ragged 2*67*101, rows of 3, and rows past its two-pass
   limit) the unsort must equal ``scatter_``'s and the sort's payload;
   kernel, plain, library and bound times of D and of the unsort at both
   flagship shapes, and one call of each split per CUDA kernel with
   ``torch.profiler``; then the multi-exit Lovász loss and its gradient
   with D and the unsort vs with their plain versions on flagship-shaped
   logits (3, 16, 512, 512, 21), equal;
3c. the histogram kernels E and F vs their plain versions (TF32 off) at the
   flagship's ``-G 1024`` row shapes (63 rows of 2^22, 1008 of 2^18) on
   uniform errors and on two Lovász-like error laws (``LOVASZ_LAWS``: a
   random-init and a trained model's errors, crowded in a few buckets), a
   ragged row with 128, 8192, 16384, 32768 and 65536 bins, the three laws
   at 63 rows of 2^22 with 16384 and 65536 bins (above the 8192 buckets one
   block of E keeps), an all-void and an all-tied row: E's counts must
   equal the plain version's exactly,
   its error sums agree within TOL_HIST_SUM_RTOL with the same sums in
   float64, F's output must equal the plain version's bit for bit; kernel,
   plain, library and bound times and one E and one F call split per CUDA
   kernel at every case of the flagship's row shapes (1024 bins on the
   three laws at both shapes; 16384 and 65536 bins on the three laws at 63
   rows of 2^22); then
   the ``-G 1024`` and ``-G 16384`` multi-exit Lovász values and gradients
   with the kernels vs with the plain versions on flagship-shaped logits
   (3, 16, 512, 512, 21);
4. eval main path: the flagship branchy DeepLabV3-ResNet50 at 512² with
   seeded random weights, saved as a checkpoint and evaluated through the
   CLIs ``eval_miou``, ``eval_br_ent`` and ``eval_br_sim`` (ssim and nmi)
   with the kernel head (launch counts checked) and with the plain head
   (results must agree), and once through ``eval_br_images``; the entropy
   and similarity gates also at a tau that splits the images; then the
   eval throughput of the evaluators over the same pre-loaded batches,
   and one batch of each kernel head under ``torch.profiler``: the device
   time of kernels A, B and C inside the batch and their share of it;
4c. early-exit engines on the same checkpoint (16 synthetic images at 512²,
   micro-batches of 12, the last with count 4): ``ee_dnn_op_ne`` (ent) with
   the sequential engine, the masked engine's plain head and its kernel
   head (``--pallas_head``: kernel B at each gated branch, C at the final
   classifier) at a tau in the widest gap of the first exit's entropies,
   also at taus above and below every entropy, and ``-m max -p 2
   --pallas_head`` (the plain head); ``ee_dnn_op -i`` with ssim and nmi
   (sequential) and nmi (masked): the JAX CLIs' CSV columns, exits summing
   to 16, equal exits and FLOPs across engines and heads (mIoU within
   TOL_MIOU_ABS), B's and C's launches exactly what each micro-batch's
   exits imply and none by a plain head; ``eval_flops -s 512`` against
   ``flops_table(512)``; ``eval_image`` on a 512x384 PNG (one palette PNG an
   exit, its indices the exit's argmax); then images/s of both engines over
   pre-loaded batches, and one masked micro-batch at the split tau and at a
   tau above every entropy under ``torch.profiler``: B's and C's device
   time, their share of the batch, and the device's idle time;
4e. the batched early-exit server (``ee/serving.py``) on the same
   checkpoint: 48 pre-loaded images (the 16 test images three times) at
   micro-batch 12 and phase 4c's split tau: exits equal the masked
   engine's plain head on the same micro-batches, maps agree on
   TOL_MAP_AGREE of the pixels; ``stats()`` and images/s;
4f. the serving artifacts (``ee/aot.py``): ``export_gated(batch_size=12,
   pallas_head=True)`` at the split tau, saved, loaded and run on the two
   test micro-batches: labels and exits equal the eager masked kernel
   head's, kernels B and C launched (as PyTorch custom operators inside
   the program) as the exits imply, and its images/s; then
   ``export_eval_forward(batch_size=12)``: logits within TOL_EXPORT_REL of
   the live model with TF32 off;
4d. the 2-exit MobileNetV3 (``build_branchy_deeplabv3(n=2, img_dim=512,
   backbone="mobilenet_v3_large")``, seeded random weights): its placement
   (one branch after block 11, 112 channels) and FLOPs table;
   ``eval_miou``, ``eval_br_ent`` and ``eval_br_sim`` (ssim) with both heads
   (rows equal, A, B and C launched once an exit and a batch) and the
   evaluators' images/s; one epoch of ``main_bradeepv3 -t mobilenet -n 2``
   at batch 16 (3 exits; one sort and one unsort a step, finite loss);
4b. training main path: the flagship trained through the CLIs
   ``main_bradeepv3`` (per-batch and per-image ``-P`` Lovász, and the
   histogram Lovász ``-G 1024``) and ``main_bradeepv3_ce`` for one epoch of
   the synthetic set (4 steps of batch 16 at 512²): kernel launches counted
   (one sort and one unsort per step for the sorted Lovász, one E and one
   F per step and no sort for ``-G``, none for CE), finite losses, the JAX package's CSV
   layouts, and each checkpoint evaluated by ``eval_miou``; then training
   images/s over pre-loaded batches (``-G 16384`` too), the loss kernels'
   launches counted over those steps (one call each a step), and one more
   step of each Lovász loss under ``torch.profiler``: the device time of
   the loss's kernels inside the step and their share of it;
4g. the data-parallel path (``parallel/mesh.py``) at world 1 over NCCL,
   launched by ``python -m torch.distributed.run --nproc_per_node=1
   chip_smoke.py --dp-worker <plan>``: ``eval_miou``, ``eval_br_ent`` and
   ``eval_br_sim`` with ``--pallas_head``, ``ee_dnn_op_ne --engine masked
   --pallas_head`` and one epoch of ``main_bradeepv3`` (sorted and ``-G
   1024``) on a flagship checkpoint: CSV rows equal to the same CLI runs in
   one process, training epoch losses within the spread of two one-process
   runs (a smoke check), kernel launches as each path implies, every
   collective of each path issued; the first train step against one
   process (in float64 its state and update, in float32 its loss), and the
   global BatchNorm's fused CUDA branch against its plain branch; then the images/s of the
   train step and of the kernel-head eval, one-process and data-parallel
   in turns, and one traced step of each; with two or more GPUs the
   same at world 2, held to world 1 (else one line says it was not run);
5. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "ee_semantic_segmentation_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 rate and
# float32 outside the tensor cores — the kernels use FP32 FFMA only.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# exp and log run on the special-function units: 16 results a clock per SM
# (Hopper white paper), 132 SMs, at the card's maximum SM clock as
# nvidia-smi reports it (set in main; 1980 MHz on an H100 SXM)
SFU_PER_CLOCK = 16 * 132
SFU_OPS_PER_S = SFU_PER_CLOCK * 1.98e9
C = 21
TOL_MAP_AGREE = 0.99999    # share of argmax pixels that must agree
TOL_ENT_RTOL = 1e-4        # entropy: float association and expf vs softmax+log
TOL_MIOU_ABS = 1e-4        # kernel head vs plain head, per-exit mIoU
TOL_A_TRAINED_RATIO = 1.2  # kernel A's time on a trained model's logits and
#                            labels over its time on the uniform law
TOL_C_TRAINED_RATIO = 1.2  # kernel C's time on a trained model's logits over
#                            its time on the uniform law
TOL_HIST_SUM_RTOL = 1e-4   # E's error sums vs the same sums in float64
#                            (hist_sums_f64): E adds most errors exactly as
#                            integers (rounding <= 2^-17 an error), the rest
#                            as float32 in two levels of atomics
TOL_HIST_LOVASZ_RTOL = 1e-5  # -G loss, kernels vs plain versions: the same
#                              tables (exact counts), error sums as above
TRAIN_ACCUM = 1            # --accum_steps of the training runs at batch 16
# kernel D's row shapes on the flagship's training path (512², batch 16,
# 3 exits x 21 classes): per-batch Lovász (the default) and per-image (-P)
SORT_MAIN_SHAPE = "flagship per-batch 63x2^22"
SORT_PER_IMAGE_SHAPE = "flagship per-image 1008x2^18"
NAN_CASE = "+-0, +-NaN, +-inf, +-1e30 8x(2*67*101)"
HIST_BINS = 1024  # -G of the training runs
# the 2-exit MobileNetV3 at 512²: both exits' low-res logits are 32x32 (output
# stride 16), so kernels A, B and C upsample 16x; its eval batch is 12
MNV3_SHAPE = "mobilenet_v3 12x32x32->512x512"
HIST_WIDE_BINS = (16384, 65536)  # above the 8192 buckets one block of kernel E keeps


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each between two
    CUDA events.  A sleep kernel queued first lets the host enqueue all
    runs ahead, so host launch overhead does not enter the device times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, ops, sfu_ops=0):
    """(least ms, what bounds it): max(bytes / HBM rate, ops / f32 rate,
    exp and log / SFU rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, sfu_ops / SFU_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bounds_ms(N, h, w, H, W, count, esize):
    """Least time the card could take for each upsample kernel's work at
    these inputs: max(bytes / HBM rate, float32 operations / f32 rate, exp
    and log / SFU rate).

    Bytes: each input read once, each output written once.  Operations
    (float32, one per add, multiply or compare; an FMA is two) of the
    separable upsample: each row-interpolated value (H*w*C per image) and
    each output value (H*W*C) takes one multiply and one FMA (3), then one
    compare per output value for the argmax.  B adds per output value a
    subtract, an add and an FMA (4) and an exp, and per pixel a divide and a
    subtract (2) and a log; the exps and logs run on the SFU, 16 a clock
    per SM, not at the float32 rate.  Kernel A only touches the ``count``
    valid rows; C is B without the entropy."""
    up = H * w * C * 3 + H * W * C * 3 + H * W * C
    maps_bytes = N * (h * w * C * esize + H * W * 4) + (H + W) * 16
    return {
        "A": bound(count * (h * w * C * esize + H * W * 4) + 3 * C * 4 + (H + W) * 16,
                   count * up),
        "B": bound(maps_bytes + N * 4, N * (up + H * W * C * 4 + H * W * 2),
                   N * (H * W * C + H * W)),
        "C": bound(maps_bytes, N * up),
    }


def trained_conf_law(N, h, w, H, W, nc, seed):
    """(N, h, w, nc) float32 logits and (N, H, W) int32 labels of a trained
    model's eval batch, from a numpy seed: a low-res class map of background
    (class 0) with rectangles of the other classes on ~23 % of each image;
    logits N(0, 1) plus 6 on the map's class; labels the map at full
    resolution (nearest), then 6 % of pixels a random class and 5 % void
    (255).  The upsampled argmax then agrees with the labels on ~89 % of the
    pixels, and ~75 % of it is background: a block's pixels mostly share
    one confusion key (TP of class 0)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    cls = np.zeros((N, h, w), np.int64)
    for n in range(N):
        while (cls[n] > 0).mean() < 0.22:
            rh, rw = rng.randint(max(1, h // 8), max(2, h // 3 + 1), 2)
            y, x = rng.randint(0, h - rh + 1), rng.randint(0, w - rw + 1)
            cls[n, y:y + rh, x:x + rw] = rng.randint(1, nc)
    logits = rng.randn(N, h, w, nc) + 6.0 * np.eye(nc)[cls]
    labels = cls[:, (np.arange(H) * h) // H][:, :, (np.arange(W) * w) // W]
    u = rng.rand(N, H, W)
    labels = np.where(u < 0.06, rng.randint(0, nc, (N, H, W)), labels)
    labels = np.where((u >= 0.06) & (u < 0.11), 255, labels)
    return logits.astype(np.float32), labels.astype(np.int32)


def conf_vs_plain(U, torch, tag, logits, labels, count, out_hw, maps_k=None):
    """Kernel A against its plain version: counts within 3 per pixel whose
    argmax flips.  A takes the argmax walk of kernel B (``pixels_argmax``):
    the flipped pixels are those where B's map, given as ``maps_k`` or made
    here, differs from the plain map, in the rows n < count."""
    conf_k = U.upsample_argmax_confusion(logits, labels, count, out_hw)
    conf_p = U.upsample_argmax_confusion_plain(logits, labels, count, out_hw)
    maps_p = U.upsample_argmax_plain(logits, out_hw)
    if maps_k is None:
        maps_k = U.upsample_entropy_argmax(logits, out_hw)[0]
    torch.cuda.synchronize()
    n_flipped = int((maps_k != maps_p)[:count].sum())
    conf_l1 = float((conf_k - conf_p).abs().sum())
    valid = (labels[:count] >= 0) & (labels[:count] < logits.shape[-1])
    agree = float(((maps_p[:count] == labels[:count]) & valid).sum()) / labels[:count].numel()
    print(f"[kernel-vs-plain] A {tag}: N={logits.shape[0]} {tuple(logits.shape[1:3])}->{out_hw} "
          f"C={logits.shape[-1]} {logits.dtype} count={count}: confusion sum|d| {conf_l1:g} "
          f"(max {float((conf_k - conf_p).abs().max()):g}), {n_flipped} flipped pixels; "
          f"argmax background {float((maps_p[:count] == 0).float().mean()):.3f}, void labels "
          f"{float((~valid).float().mean()):.3f}, argmax == label {agree:.3f} of the pixels")
    check(conf_l1 <= 3 * n_flipped,
          f"A {tag}: confusion counts differ by {conf_l1} > 3 x {n_flipped} flipped pixels")
    return float((conf_k - conf_p).abs().max())


def kernel_vs_plain(U, torch):
    """Phase 3.  Returns per-kernel measurements at the flagship shape."""
    import numpy as np
    import torch.nn.functional as Fn

    results = {}
    cases = [("flagship", (16, 64, 64), (512, 512), 16), ("ragged", (3, 9, 13), (67, 101), 2),
             ("padded batch", (12, 64, 64), (512, 512), 4),  # eval's last batch: count 4 of 12
             (MNV3_SHAPE, (12, 32, 32), (512, 512), 12)]  # MobileNetV3's exits, 16x
    for tag, (N, h, w), (H, W), count in cases:
        rng = np.random.RandomState(0)
        logits = torch.from_numpy((2 * rng.randn(N, h, w, C)).astype(np.float32)).cuda()
        labels = torch.from_numpy(rng.randint(0, C + 1, (N, H, W)).astype(np.int32)).cuda()

        conf_k = U.upsample_argmax_confusion(logits, labels, count, (H, W))
        conf_p = U.upsample_argmax_confusion_plain(logits, labels, count, (H, W))
        maps_k, ent_k = U.upsample_entropy_argmax(logits, (H, W))
        maps_p, ent_p = U.upsample_entropy_argmax_plain(logits, (H, W))
        maps_c = U.upsample_argmax(logits, (H, W))
        torch.cuda.synchronize()

        differ = maps_k != maps_p
        agree = 1.0 - differ.float().mean().item()
        agree_c = 1.0 - (maps_c != maps_p).float().mean().item()
        n_differ_valid = int(differ[:count].sum())
        conf_err = float((conf_k - conf_p).abs().max())
        conf_l1 = float((conf_k - conf_p).abs().sum())
        ent_err = float((ent_k - ent_p).abs().max())
        ent_rel = float(((ent_k - ent_p).abs() / ent_p.abs()).max())
        print(f"[kernel-vs-plain] {tag}: N={N} {h}x{w}->{H}x{W} C={C} count={count}: "
              f"argmax agree {agree:.7f} (B), {agree_c:.7f} (C), differing pixels "
              f"{int(differ.sum())} (B), {int((maps_c != maps_p).sum())} (C); "
              f"confusion sum|d| {conf_l1:g} (max {conf_err:g}); entropy max|d| {ent_err:.3g} "
              f"(rel {ent_rel:.3g})")
        check(agree >= TOL_MAP_AGREE, f"{tag}: argmax maps agree on {agree:.7f} < {TOL_MAP_AGREE}")
        check(agree_c >= TOL_MAP_AGREE,
              f"{tag}: kernel C's maps agree on {agree_c:.7f} < {TOL_MAP_AGREE}")
        check(bool(torch.equal(maps_c, maps_k)), f"{tag}: kernel C's maps differ from B's")
        check(conf_l1 <= 3 * n_differ_valid,
              f"{tag}: confusion counts differ by {conf_l1} > 3 x {n_differ_valid} flipped pixels")
        check(ent_rel <= TOL_ENT_RTOL, f"{tag}: entropy rel err {ent_rel:.3g} > {TOL_ENT_RTOL}")
        if tag not in ("flagship", MNV3_SHAPE):
            continue

        def library():  # yardstick: upsample + argmax only, no counts
            x = logits.permute(0, 3, 1, 2)
            return Fn.interpolate(x, size=(H, W), mode="bilinear", align_corners=False).argmax(1)

        lib_ms = median_ms(library)
        bounds = bounds_ms(N, h, w, H, W, count, logits.element_size())
        for key, fn, plain, err in (
            ("A", lambda: U.upsample_argmax_confusion(logits, labels, count, (H, W)),
             lambda: U.upsample_argmax_confusion_plain(logits, labels, count, (H, W)), conf_err),
            ("B", lambda: U.upsample_entropy_argmax(logits, (H, W)),
             lambda: U.upsample_entropy_argmax_plain(logits, (H, W)), ent_err),
            ("C", lambda: U.upsample_argmax(logits, (H, W)),
             lambda: U.upsample_argmax_plain(logits, (H, W)),
             float((maps_c - maps_p).abs().max())),
        ):
            res = dict(ms=median_ms(fn), plain_ms=median_ms(plain), library_ms=lib_ms,
                       bound_ms=bounds[key][0], bound_by=bounds[key][1], max_abs_err=err)
            results[key if tag == "flagship" else (key, tag)] = res
            print(f"[kernel-vs-plain] {key} at {tag}: kernel {res['ms']:.4f} ms, "
                  f"plain {res['plain_ms']:.4f} ms, library (interpolate+argmax) "
                  f"{lib_ms:.4f} ms, bound {bounds[key][0]:.4f} ms ({bounds[key][1]})")
        if tag != "flagship":
            continue
        print(f"[kernel-vs-plain] A at {tag}, one call per CUDA kernel [launches, ms]: "
              f"{per_kernel_ms(lambda: U.upsample_argmax_confusion(logits, labels, count, (H, W)), torch, {'up_argmax_conf_kernel': 1})}")
        # kernel A on a trained model's logits and labels: most of a block
        # shares one confusion key; its time within TOL_A_TRAINED_RATIO of
        # the uniform law's above
        lt, lab_t = trained_conf_law(N, h, w, H, W, C, seed=5)
        lt, lab_t = torch.from_numpy(lt).cuda(), torch.from_numpy(lab_t).cuda()
        results["A"]["max_abs_err"] = max(results["A"]["max_abs_err"],
                                          conf_vs_plain(U, torch, "trained law", lt, lab_t, count,
                                                        (H, W)))
        ms_t = results["A"]["ms_trained"] = median_ms(
            lambda: U.upsample_argmax_confusion(lt, lab_t, count, (H, W)))
        ratio = ms_t / results["A"]["ms"]
        print(f"[kernel-vs-plain] A at {tag}, trained law: kernel {ms_t:.4f} ms = {ratio:.3f} x "
              f"the uniform law's {results['A']['ms']:.4f} ms; one call per CUDA kernel "
              f"[launches, ms]: {per_kernel_ms(lambda: U.upsample_argmax_confusion(lt, lab_t, count, (H, W)), torch, {'up_argmax_conf_kernel': 1})}")
        check(ratio <= TOL_A_TRAINED_RATIO,
              f"A on the trained law takes {ratio:.3f} x its uniform-law time > {TOL_A_TRAINED_RATIO}")
        # kernel C at the flagship, split per CUDA kernel, and on the
        # trained law's logits: maps checked, time within
        # TOL_C_TRAINED_RATIO of the uniform law's
        print(f"[kernel-vs-plain] C at {tag}, one call per CUDA kernel [launches, ms]: "
              f"{per_kernel_ms(lambda: U.upsample_argmax(logits, (H, W)), torch, {'up_argmax_map_kernel': 1})}")
        maps_t = U.upsample_argmax(lt, (H, W))
        maps_tp = U.upsample_argmax_plain(lt, (H, W))
        agree_t = 1.0 - (maps_t != maps_tp).float().mean().item()
        same_b = bool(torch.equal(maps_t, U.upsample_entropy_argmax(lt, (H, W))[0]))
        results["C"]["max_abs_err"] = max(results["C"]["max_abs_err"],
                                          float((maps_t - maps_tp).abs().max()))
        ms_t = results["C"]["ms_trained"] = median_ms(lambda: U.upsample_argmax(lt, (H, W)))
        ratio = ms_t / results["C"]["ms"]
        print(f"[kernel-vs-plain] C at {tag}, trained law: argmax agree {agree_t:.7f}, equal B's "
              f"{same_b}; kernel {ms_t:.4f} ms = {ratio:.3f} x the uniform law's "
              f"{results['C']['ms']:.4f} ms; one call per CUDA kernel [launches, ms]: "
              f"{per_kernel_ms(lambda: U.upsample_argmax(lt, (H, W)), torch, {'up_argmax_map_kernel': 1})}")
        check(agree_t >= TOL_MAP_AGREE and same_b,
              f"C on the trained law: maps agree on {agree_t:.7f}, equal B's {same_b}")
        check(ratio <= TOL_C_TRAINED_RATIO,
              f"C on the trained law takes {ratio:.3f} x its uniform-law time > {TOL_C_TRAINED_RATIO}")
    # kernels B's, A's and C's edge cases (A's labels 5 % void, 255): more
    # classes than 32, bf16 logits, output rows that do not fill the last
    # band, output columns that do not fill a 16-byte label load or store,
    # no resize, and rows too wide for one tile of shared memory
    b_cases = [
        ("C=40, above 32 classes", (2, 16, 16), 40, (128, 128), torch.float32),
        ("bf16 logits, flagship", (16, 64, 64), C, (512, 512), torch.bfloat16),
        (f"bf16 logits, {MNV3_SHAPE}", (12, 32, 32), C, (512, 512), torch.bfloat16),
        ("H=70, not a multiple of the band", (2, 8, 8), C, (70, 64), torch.float32),
        ("W=66, not a multiple of 4", (2, 8, 8), C, (64, 66), torch.float32),
        ("no resize", (2, 64, 64), C, (64, 64), torch.float32),
        ("column tiles", (2, 8, 1024), 32, (16, 2048), torch.float32),
    ]
    for tag, (N, h, w), nc, (H, W), dtype in b_cases:
        rng = np.random.RandomState(1)
        logits = torch.from_numpy((2 * rng.randn(N, h, w, nc)).astype(np.float32)).to(
            device="cuda", dtype=dtype)
        lab = rng.randint(0, nc + 1, (N, H, W))
        labels = torch.from_numpy(np.where(rng.rand(N, H, W) < 0.05, 255, lab).astype(np.int32))
        maps_k, ent_k = U.upsample_entropy_argmax(logits, (H, W))
        conf_vs_plain(U, torch, tag, logits, labels.cuda(), N, (H, W), maps_k)
        maps_p, ent_p = U.upsample_entropy_argmax_plain(logits, (H, W))
        maps_c = U.upsample_argmax(logits, (H, W))
        torch.cuda.synchronize()
        agree = 1.0 - (maps_k != maps_p).float().mean().item()
        agree_c = 1.0 - (maps_c != maps_p).float().mean().item()
        ent_rel = float(((ent_k - ent_p).abs() / ent_p.abs()).max())
        print(f"[kernel-vs-plain] B {tag}: N={N} {h}x{w}->{H}x{W} C={nc} {dtype}: argmax agree "
              f"{agree:.7f} (differing pixels {int((maps_k != maps_p).sum())}); entropy rel "
              f"{ent_rel:.3g}")
        print(f"[kernel-vs-plain] C {tag}: argmax agree {agree_c:.7f} (differing pixels "
              f"{int((maps_c != maps_p).sum())}), equal B's {bool(torch.equal(maps_c, maps_k))}")
        check(agree >= TOL_MAP_AGREE, f"B {tag}: argmax maps agree on {agree:.7f} < {TOL_MAP_AGREE}")
        check(ent_rel <= TOL_ENT_RTOL, f"B {tag}: entropy rel err {ent_rel:.3g} > {TOL_ENT_RTOL}")
        check(agree_c >= TOL_MAP_AGREE, f"C {tag}: argmax maps agree on {agree_c:.7f} < {TOL_MAP_AGREE}")
        check(bool(torch.equal(maps_c, maps_k)), f"C {tag}: maps differ from B's")
    # kernel C where not even a band of one output row fits a block's shared
    # memory: the wrapper raises before it launches or allocates
    before = U.upsample_argmax.launches
    try:
        U.upsample_argmax(torch.zeros((1, 8, 8, 20000), device="cuda"), (64, 64))
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"[kernel-vs-plain] C with 20000 classes, (8, 8) -> (64, 64): raises {raised!r}")
    check(raised is not None and U.upsample_argmax.launches == before,
          "C with 20000 classes did not raise ValueError before launching")
    return results


# short spin kernels that open each profiler session, and what they show
PROFILER_GUARDS = 16
profiler_tally = {"sessions": 0, "guard records lost": 0, "most lost in one session": 0,
                  "splits not measured": 0}


def per_kernel_ms(fn, torch, want=None):
    """One call of ``fn`` under ``torch.profiler``: {CUDA kernel: [launches,
    device ms]}, or None when the trace stays short of ``want``: {start of a
    kernel's name: launches} that the call makes.  After many profiler
    sessions in one process a session loses the records of its first few
    kernels, whichever they are (up to 7 a session in the runs of PERF.md),
    so a trace of one kernel after a few guards loses that kernel.  Each
    session therefore starts with ``PROFILER_GUARDS`` spin kernels
    (``torch.cuda._sleep``, left out of the result) that take the loss;
    ``profiler_tally`` counts the guard records lost.  A trace still short
    of ``want`` is taken again (up to 5 times); after that the split was not
    measured and None stands for it, never a 0."""
    for _ in range(5):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILER_GUARDS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        lost = PROFILER_GUARDS - sum(e.count for e in events if "spin" in e.key)
        profiler_tally["sessions"] += 1
        profiler_tally["guard records lost"] += lost
        profiler_tally["most lost in one session"] = max(
            lost, profiler_tally["most lost in one session"])
        got = {re.sub(r"^(void )?\(anonymous namespace\)::", "", e.key).split("(")[0]:
               [e.count, round(e.device_time_total / 1e3, 3)]
               for e in events if e.device_time_total > 0 and "spin" not in e.key}
        if all(kernels_of(got, start)[0] >= n for start, n in (want or {}).items()):
            return got
    profiler_tally["splits not measured"] += 1
    print(f"[profiler] five traces short of {want}: not measured")
    return None


def kernels_of(trace, start):
    """(launches, device ms) of the kernels of a ``per_kernel_ms`` trace
    whose names start with ``start`` (a string or a tuple of them)."""
    hits = [v for name, v in trace.items() if name.startswith(start)]
    return sum(n for n, _ in hits), sum(ms for _, ms in hits)


def bits_equal(a, b, torch) -> bool:
    """Equal bit for bit (``torch.equal`` is False on NaN)."""
    view = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return a.dtype == b.dtype and bool(torch.equal(view(a), view(b)))


def special_keys(B, P, g, torch, nans=True):
    """(B, P) float32 keys drawn from +-0.0, +-inf, +-1e30, 0.5 and (with
    ``nans``) NaNs of both signs: ties everywhere, and every case of the
    key map."""
    vals = torch.tensor([0.0, -0.0, math.inf, -math.inf, 1e30, -1e30, 0.5], device="cuda")
    if nans:
        nan = torch.tensor([math.nan], device="cuda")
        vals = torch.cat([vals, nan, -nan])  # -nan: the sign bit set
    return vals[torch.randint(0, len(vals), (B, P), device="cuda", generator=g)]


def int_keys(B, P, g, torch):
    """(B, P) int32 keys over the whole range, a fifth of them 2^31 - 1,
    -2^31, 0 or -1."""
    keys = torch.randint(-2**31, 2**31, (B, P), device="cuda", generator=g, dtype=torch.int64)
    ends = torch.tensor([2**31 - 1, -2**31, 0, -1], device="cuda")
    pick = ends[torch.randint(0, 4, (B, P), device="cuda", generator=g)]
    keys = torch.where(torch.rand(B, P, device="cuda", generator=g) < 0.2, pick, keys)
    return keys.to(torch.int32)


def sort_vs_plain(S, torch):
    """Phase 3b.  Kernel D against ``sort_rows_plain`` at every case, bit
    for bit, and the unsort against ``unsort_rows_plain`` at the
    permutation-key cases; returns {"sort_rows" or "unsort_rows": {flagship
    shape: measurements}}, with one D call split per CUDA kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    arange_pay = lambda B, P: torch.arange(B * P, dtype=torch.int32, device="cuda").view(B, P)
    perm_keys = lambda B, P: torch.argsort(torch.rand(B, P, device="cuda", generator=g),
                                           dim=-1).int()
    ragged = 2 * 67 * 101
    cases = {
        SORT_MAIN_SHAPE: lambda: (torch.randn(63, 1 << 22, device="cuda", generator=g),
                                  arange_pay(63, 1 << 22)),
        SORT_PER_IMAGE_SHAPE: lambda: (torch.randn(1008, 1 << 18, device="cuda", generator=g),
                                       arange_pay(1008, 1 << 18)),
        "one tile 8x2^13": lambda: (torch.randn(8, 1 << 13, device="cuda", generator=g),
                                    arange_pay(8, 1 << 13)),
        "two tiles 8x2^14": lambda: (torch.randn(8, 1 << 14, device="cuda", generator=g),
                                     arange_pay(8, 1 << 14)),
        "8x1024": lambda: (torch.randn(8, 1024, device="cuda", generator=g), arange_pay(8, 1024)),
        "ragged 8x(2*67*101)": lambda: (torch.randn(8, ragged, device="cuda", generator=g),
                                        arange_pay(8, ragged)),
        "16-valued ties 8x2^20": lambda: (
            torch.randint(0, 16, (8, 1 << 20), device="cuda", generator=g).float() - 7.5,
            arange_pay(8, 1 << 20)),
        "+-0, +-inf, +-1e30 8x(2*67*101)": lambda: (special_keys(8, ragged, g, torch, False),
                                                    arange_pay(8, ragged)),
        NAN_CASE: lambda: (special_keys(8, ragged, g, torch), arange_pay(8, ragged)),
        "int32 keys with 2^31-1, ragged 8x(2*67*101+1)": lambda: (
            int_keys(8, ragged + 1, g, torch), arange_pay(8, ragged + 1)),
        "short rows 5x3": lambda: (torch.randn(5, 3, device="cuda", generator=g), arange_pay(5, 3)),
        "permutation keys, f32 payload 16x2^18": lambda: (
            perm_keys(16, 1 << 18), torch.randn(16, 1 << 18, device="cuda", generator=g)),
        # the backward's unsort at the flagship's per-batch and per-image rows
        "permutation keys, f32 payload 63x2^22": lambda: (
            perm_keys(63, 1 << 22), torch.randn(63, 1 << 22, device="cuda", generator=g)),
        "permutation keys, f32 payload 1008x2^18": lambda: (
            perm_keys(1008, 1 << 18), torch.randn(1008, 1 << 18, device="cuda", generator=g)),
    }
    # the unsort's bucket edges: rows of one window less, one, one more and
    # two and a bit (W = the kernel's window), a ragged row, rows of 3, and
    # rows one window past the two-pass limit (the one-pass scatter)
    W = S.unsort_window()
    for B, P, what in ((8, W - 1, "W-1"), (8, W, "W"), (8, W + 1, "W+1"), (8, 2 * W + 3, "2W+3"),
                       (8, ragged, "2*67*101"), (5, 3, "3"), (2, 4097 * W, "4097W")):
        cases[f"permutation keys, f32 payload {B}x{what} (W={W})"] = (
            lambda B=B, P=P: (perm_keys(B, P), torch.randn(B, P, device="cuda", generator=g)))
    results = {"sort_rows": {}, "unsort_rows": {}}
    for tag, make in cases.items():
        key, pay = make()
        ks, ps = S.sort_rows(key, pay)
        torch.cuda.synchronize()
        kp, pp = S.sort_rows_plain(key, pay)
        if tag == NAN_CASE:
            # torch.sort on CUDA orders raw bits through cub's radix sort, so a
            # NaN with the sign bit set sorts first; the CPU's (and numpy's,
            # and the JAX package's) order, which the kernel keeps, puts every
            # NaN last
            kc, pc = (t.cuda() for t in S.sort_rows_plain(key.cpu(), pay.cpu()))
            print(f"[sort-vs-plain] {tag}: torch.sort on CUDA equal to torch.sort on the CPU "
                  f"{bits_equal(kp, kc, torch) and bits_equal(pp, pc, torch)}; the kernel is held "
                  "against the CPU's")
            kp, pp = kc, pc
        keys_equal, pays_equal = bits_equal(ks, kp, torch), bits_equal(ps, pp, torch)
        print(f"[sort-vs-plain] {tag}: keys equal bit for bit {keys_equal}, payloads {pays_equal}")
        if not (keys_equal and pays_equal):  # where the first difference is, before failing
            row, col = (((ks.view(torch.int32) != kp.view(torch.int32)) |
                         (ps.view(torch.int32) != pp.view(torch.int32))).nonzero()[0].tolist())
            near = slice(max(col - 2, 0), col + 3)
            print(f"[sort-vs-plain] {tag}: first difference at row {row}, column {col}: kernel "
                  f"{ks[row, near].tolist()} / {ps[row, near].tolist()}, plain "
                  f"{kp[row, near].tolist()} / {pp[row, near].tolist()}")
        check(keys_equal, f"sort {tag}: sorted keys differ from torch.sort's")
        check(pays_equal, f"sort {tag}: payloads differ from the plain version's")
        B, P = key.shape
        if tag.startswith("permutation keys"):
            uk, up = S.unsort_rows(key, pay), S.unsort_rows_plain(key, pay)
            torch.cuda.synchronize()
            unsort_equal = bits_equal(uk, up, torch) and bits_equal(uk, ps, torch)
            print(f"[sort-vs-plain] {tag}: unsort_rows equal bit for bit to scatter_ and to the "
                  f"sort's payload {unsort_equal}")
            check(unsort_equal, f"unsort {tag}: differs from the plain version's")
            shape = {(63, 1 << 22): SORT_MAIN_SHAPE,
                     (1008, 1 << 18): SORT_PER_IMAGE_SHAPE}.get((B, P))
            if shape:  # the flagship's rows
                idx = key.long()
                r = results["unsort_rows"][shape] = dict(
                    ms=median_ms(lambda: S.unsort_rows(key, pay)),
                    plain_ms=median_ms(lambda: S.unsort_rows_plain(key, pay)),
                    library_ms=median_ms(lambda: torch.empty_like(pay).scatter_(-1, idx, pay)),
                    # perm and values read once, the output written once
                    bound_ms=B * P * 12 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                    max_abs_err=float((uk - up).abs().max()))
                print(f"[sort-vs-plain] unsort at {shape}: kernel {r['ms']:.3f} ms, plain "
                      f"{r['plain_ms']:.3f} ms, library (scatter_ with int64 indices) "
                      f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms (bytes)")
                print(f"[sort-vs-plain] unsort at {shape}, one call per CUDA kernel [launches, "
                      f"ms]: {per_kernel_ms(lambda: S.unsort_rows(key, pay), torch, {'unsort_': 2})}")
                del idx
            del uk, up
        if tag.startswith("flagship"):
            r = results["sort_rows"][tag] = dict(
                ms=median_ms(lambda: S.sort_rows(key, pay)),
                plain_ms=median_ms(lambda: S.sort_rows_plain(key, pay)),
                library_ms=median_ms(lambda: torch.gather(pay, -1, torch.sort(key, dim=-1)[1])),
                # key and payload read once, both written once
                bound_ms=B * P * 16 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                max_abs_err=float((ks.double() - kp.double()).abs().max()))
            print(f"[sort-vs-plain] D at {tag}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"library (torch.sort + gather) {r['library_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.4f} ms (bytes)")
            print(f"[sort-vs-plain] D at {tag}, one call per CUDA kernel [launches, ms]: "
                  f"{per_kernel_ms(lambda: S.sort_rows(key, pay), torch, {'radix_': 16})}")
        del key, pay, ks, ps, kp, pp
        torch.cuda.empty_cache()
    return results


def lovasz_kernel_vs_plain(S, torch):
    """Phase 3b, end: the multi-exit Lovász value and gradient with kernel D
    and the unsort against the same function with their plain versions, on
    flagship-shaped logits with 15% void labels, per-batch and per-image.
    The sort is stable and the unsort a permutation, so both are equal."""
    from ee_semantic_segmentation_tpu_torch.ops.lovasz import _lovasz_exits

    g = torch.Generator(device="cuda").manual_seed(1)
    logits = 3 * torch.randn(3, 16, 512, 512, C, device="cuda", generator=g)
    labels = torch.randint(0, C, (16, 512, 512), device="cuda", generator=g, dtype=torch.int32)
    labels[torch.rand(16, 512, 512, device="cuda", generator=g) < 0.15] = C  # void
    for per_image in (False, True):
        out = {}
        for name, pair in (("kernel", S.KERNELS),
                           ("plain", (S.sort_rows_plain, S.unsort_rows_plain))):
            x = logits.clone().requires_grad_(True)
            loss = _lovasz_exits(x, labels, per_image=per_image, ignore=C, sort_kernels=pair).sum()
            (grad,) = torch.autograd.grad(loss, x)
            out[name] = (loss.item(), grad)
        (lk, gk), (lp, gp) = out["kernel"], out["plain"]
        print(f"[lovasz] flagship logits (3, 16, 512, 512, {C}), per_image={per_image}: loss kernel "
              f"{lk!r} vs plain {lp!r}; gradient equal {bool(torch.equal(gk, gp))}, max|grad| "
              f"{float(gp.abs().max()):.3g}")
        check(math.isfinite(lk) and lk == lp, f"Lovász loss with the kernels {lk} vs the plain "
                                              f"versions {lp}")
        check(bool(torch.equal(gk, gp)), "Lovász gradient with the kernels differs from the plain "
                                         f"versions' by max {float((gk - gp).abs().max()):.3g}")
        del out, gk, gp
    del logits, labels
    torch.cuda.empty_cache()


# the error laws of phase 3c: name -> (logit offset, logit scale) of the
# foreground probability p = sigmoid(offset + scale * z), z ~ N(0, 1); a
# background pixel's error is p, a foreground pixel's 1 - p
LOVASZ_LAWS = {"Lovász-like, random init": (-3.0, 0.5), "Lovász-like, trained": (-9.0, 1.0)}


def hist_rows(R, P, g, torch, law=None):
    """(R, P) errors with 15 % of them void (-1e30), a bool foreground and
    the valid mask.  With no ``law``: errors uniform in [0, 1.5), fg on ~30 %
    of the valid pixels.  With a ``LOVASZ_LAWS`` name: fg on ~10 % of the
    valid pixels and the errors of a -G step, |fg - p|, which cluster in a
    few buckets (near 0 and 1 for the trained law)."""
    if law is None:  # uniform errors, drawn in the order that earlier runs drew them
        errors = 1.5 * torch.rand(R, P, device="cuda", generator=g)
        valid = torch.rand(R, P, device="cuda", generator=g) >= 0.15
        fg = (torch.rand(R, P, device="cuda", generator=g) < 0.3) & valid
    else:
        offset, scale = LOVASZ_LAWS[law]
        valid = torch.rand(R, P, device="cuda", generator=g) >= 0.15
        fg = (torch.rand(R, P, device="cuda", generator=g) < 0.1) & valid
        p = torch.sigmoid(offset + scale * torch.randn(R, P, device="cuda", generator=g))
        errors = torch.where(fg, 1 - p, p)
    return torch.where(valid, errors, -1e30), fg, valid


def hist_sums_f64(errors, fg, emax, inv_w, bins, torch):
    """(R, 2, bins) [S, Sf]: the plain version's error sums, over its own
    bucket ids, added up in float64.  E's sums are held against these: a
    float32 sum of a bucket of millions of errors (a clustered row) drifts
    by ~1e-4 of itself, the plain version's included."""
    valid = errors > -1e29
    idx = ((emax[:, None] - errors) * inv_w[:, None]).clamp(0, bins - 1).long()
    e64 = torch.where(valid, errors.double(), 0.0)
    out = torch.zeros(errors.shape[0], 2, bins, dtype=torch.float64, device=errors.device)
    out[:, 0].scatter_add_(1, idx, e64)
    out[:, 1].scatter_add_(1, idx, torch.where(fg, e64, 0.0))
    return out


def max_rel(got, want, torch):
    """max |got - want| / |want| over the nonzero wants (a zero want must be
    got exactly)."""
    d = (got.double() - want).abs()
    rel = torch.where(want != 0, d / want.abs(), torch.where(d > 0, math.inf, 0.0))
    return float(rel.max())


def hist_vs_plain(Hk, torch):
    """Phase 3c.  Kernels E and F against their plain versions at every
    case; returns their measurements at the two flagship -G row shapes."""
    from ee_semantic_segmentation_tpu_torch.ops.lovasz import _hist_prepass, _hist_tables

    g = torch.Generator(device="cuda").manual_seed(2)
    P_ragged, range_bins = 2 * 67 * 101, Hk.range_bins()
    cases = {  # tag: (rows, P, bins, error law)
        SORT_MAIN_SHAPE: (63, 1 << 22, HIST_BINS, None),
        SORT_PER_IMAGE_SHAPE: (1008, 1 << 18, HIST_BINS, None),
        **{f"{shape}, {law}": (R, P, HIST_BINS, law) for law in LOVASZ_LAWS
           for shape, (R, P) in ((SORT_MAIN_SHAPE, (63, 1 << 22)),
                                 (SORT_PER_IMAGE_SHAPE, (1008, 1 << 18)))},
        "ragged 8x(2*67*101), 128 bins": (8, P_ragged, 128, None),
        # E's one-block limit and the bucket ranges above it; F stages its
        # table up to 16384 bins and reads it from L2 above
        **{f"ragged 8x(2*67*101), {b} bins": (8, P_ragged, b, None)
           for b in (range_bins, 2 * range_bins, 4 * range_bins, *HIST_WIDE_BINS)},
        # -G above the range at the flagship's per-batch rows, every error law
        **{f"{SORT_MAIN_SHAPE}, {law or 'uniform'}, {b} bins": (63, 1 << 22, b, law)
           for b in HIST_WIDE_BINS for law in (None, *LOVASZ_LAWS)},
        "4x2^20 with an all-void and an all-tied row": (4, 1 << 20, HIST_BINS, None),
    }
    results = {}
    for tag, (R, P, bins, law) in cases.items():
        errors, fg, valid = hist_rows(R, P, g, torch, law)
        if R == 4:
            errors[1], fg[1], valid[1] = -1e30, False, False  # all void
            errors[2], valid[2] = 0.25, True  # all tied (one bucket; sums exact)
            fg[2] = torch.rand(P, device="cuda", generator=g) < 0.5
        emax, inv_w = _hist_prepass(errors, valid, bins)
        hk = Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=bins)
        hp = Hk.hist2d_weighted_plain(errors, fg, emax, inv_w, bins=bins)
        _, tables = _hist_tables(hk)
        tables = tables.contiguous()
        wk = Hk.table_lookup(errors, fg, emax, inv_w, tables, bins=bins)
        wp = Hk.table_lookup_plain(errors, fg, emax, inv_w, tables, bins=bins)
        torch.cuda.synchronize()
        counts_equal = bool(torch.equal(hk[:, :2], hp[:, :2]))
        s64 = hist_sums_f64(errors, fg, emax, inv_w, bins, torch)
        sum_rel, plain_rel = max_rel(hk[:, 2:], s64, torch), max_rel(hp[:, 2:], s64, torch)
        sum_err = float((hk[:, 2:].double() - s64).abs().max())
        lookup_equal = bool(torch.equal(wk.view(torch.int32), wp.view(torch.int32)))
        fullest = float((hp[:, 0].amax(-1) / hp[:, 0].sum(-1).clamp_min(1)).mean())
        print(f"[hist-vs-plain] {tag}: counts equal {counts_equal} (total {int(hk[:, 0].sum())}"
              f" of {R * P} pixels valid; fullest bucket {fullest:.3f} of a row), error sums vs "
              f"their float64 sum max|d| {sum_err:.3g} (rel {sum_rel:.3g}; the float32 plain "
              f"version's rel {plain_rel:.3g}, E vs it rel "
              f"{max_rel(hk[:, 2:], hp[:, 2:].double(), torch):.3g}); lookup equal bit for bit "
              f"{lookup_equal}")
        check(counts_equal, f"hist {tag}: E's counts differ from the plain version's")
        check(sum_rel <= TOL_HIST_SUM_RTOL,
              f"hist {tag}: E's error sums differ from their float64 sum by rel {sum_rel:.3g} > "
              f"{TOL_HIST_SUM_RTOL}")
        check(lookup_equal, f"hist {tag}: F's output differs from the plain version's")
        if R == 4:
            check(not hk[1].any() and not wk[1].any(), "the all-void row is not all zero")
            check(int(hk[2, 0, 0]) == P and not hk[2, 0, 1:].any(),
                  "the all-tied row is not in one bucket")
        if tag.startswith("flagship"):
            idx = ((emax[:, None] - errors) * inv_w[:, None]).clamp(0, bins - 1).long()
            fgv = fg & valid
            idx4 = (idx[:, None, :] + bins * torch.arange(4, device="cuda")[None, :, None])
            idx4 = idx4.reshape(R, 4 * P)
            src4 = torch.stack([valid.float(), fgv.float(), errors * valid, errors * fgv], 1)
            src4 = src4.reshape(R, 4 * P)
            idx2 = idx + bins * (~fg).long()
            tab2 = tables.view(R, 2 * bins)
            e_bytes = R * P * 5 + R * 8 + R * 4 * bins * 4
            f_bytes = R * P * 9 + R * 8 + R * 2 * bins * 4
            # operations per pixel: E compares, subtracts, multiplies, clamps
            # twice, converts and adds to two or four buckets (8); F does the
            # same bucket id and a select and a multiply (7)
            for key, fn, plain, lib, nbytes, ops, err in (
                ("E", lambda: Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=bins),
                 lambda: Hk.hist2d_weighted_plain(errors, fg, emax, inv_w, bins=bins),
                 lambda: torch.zeros(R, 4 * bins, device="cuda").scatter_add_(1, idx4, src4),
                 e_bytes, 8 * R * P, sum_err),
                ("F", lambda: Hk.table_lookup(errors, fg, emax, inv_w, tables, bins=bins),
                 lambda: Hk.table_lookup_plain(errors, fg, emax, inv_w, tables, bins=bins),
                 lambda: torch.gather(tab2, 1, idx2), f_bytes, 7 * R * P,
                 float((wk - wp).abs().max())),
            ):
                bound_ms, bound_by = bound(nbytes, ops)
                slow = 5 if key == "E" else 20  # E's scatter_add_ versions are slow
                r = results[key, tag] = dict(
                    ms=median_ms(fn), plain_ms=median_ms(plain, slow, 1),
                    library_ms=median_ms(lib, slow, 1), bound_ms=bound_ms, bound_by=bound_by,
                    max_abs_err=err)
                where = tag if "bins" in tag else f"{tag}, {bins} bins"
                print(f"[hist-vs-plain] {key} at {where}: kernel {r['ms']:.3f} ms, "
                      f"plain {r['plain_ms']:.3f} ms, library "
                      f"({'scatter_add_' if key == 'E' else 'gather'} over precomputed bucket "
                      f"ids) {r['library_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            e_split = per_kernel_ms(lambda: Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=bins),
                                    torch, {"hist_kernel": 1, "hist_finalize_kernel": 1})
            print(f"[hist-vs-plain] E at {tag}, one call per CUDA kernel [launches, ms]: {e_split}")
            f_split = per_kernel_ms(
                lambda: Hk.table_lookup(errors, fg, emax, inv_w, tables, bins=bins), torch,
                {"lookup_": 1})
            print(f"[hist-vs-plain] F at {tag}, one call per CUDA kernel [launches, ms]: {f_split}")
            del idx, fgv, idx4, src4, idx2, tab2
        del errors, fg, valid, hk, hp, wk, wp, tables, s64
        torch.cuda.empty_cache()
    for key in ("E", "F"):
        for b in HIST_WIDE_BINS:
            uniform = results[key, f"{SORT_MAIN_SHAPE}, uniform, {b} bins"]["ms"]
            print(f"[hist-vs-plain] {key} at {b} bins, 63x2^22: " + ", ".join(
                f"{law} / uniform "
                f"{results[key, f'{SORT_MAIN_SHAPE}, {law}, {b} bins']['ms'] / uniform:.3f}"
                for law in LOVASZ_LAWS))
    return results


def hist_lovasz_kernel_vs_plain(Hk, torch):
    """Phase 3c, end: the -G 1024 and -G 16384 multi-exit Lovász value and
    gradient with kernels E and F against the same function with their
    plain versions, on flagship-shaped logits with 15 % void labels,
    per-batch and per-image.  The gradient depends on the exact counts
    only: equal."""
    from ee_semantic_segmentation_tpu_torch.ops.lovasz import _lovasz_exits

    g = torch.Generator(device="cuda").manual_seed(1)
    logits = 3 * torch.randn(3, 16, 512, 512, C, device="cuda", generator=g)
    labels = torch.randint(0, C, (16, 512, 512), device="cuda", generator=g, dtype=torch.int32)
    labels[torch.rand(16, 512, 512, device="cuda", generator=g) < 0.15] = C  # void
    for bins, per_image in ((b, p) for b in (HIST_BINS, HIST_WIDE_BINS[0]) for p in (False, True)):
        out = {}
        for name, pair in (("kernel", Hk.KERNELS),
                           ("plain", (Hk.hist2d_weighted_plain, Hk.table_lookup_plain))):
            x = logits.clone().requires_grad_(True)
            loss = _lovasz_exits(x, labels, per_image=per_image, ignore=C, hist_bins=bins,
                                 hist_kernels=pair).sum()
            (grad,) = torch.autograd.grad(loss, x)
            out[name] = (loss.item(), grad)
        (lk, gk), (lp, gp) = out["kernel"], out["plain"]
        print(f"[hist-lovasz] -G {bins} on flagship logits (3, 16, 512, 512, {C}), "
              f"per_image={per_image}: loss kernel {lk!r} vs plain {lp!r} (rel "
              f"{abs(lk - lp) / abs(lp):.3g}); gradient equal {bool(torch.equal(gk, gp))}, "
              f"max|grad| {float(gp.abs().max()):.3g}")
        check(math.isfinite(lk) and abs(lk - lp) <= TOL_HIST_LOVASZ_RTOL * abs(lp),
              f"-G Lovász loss with the kernels {lk} vs the plain versions {lp}")
        check(bool(torch.equal(gk, gp)), "-G Lovász gradient with the kernels differs from the "
              f"plain versions' by max {float((gk - gp).abs().max()):.3g}")
        del out, gk, gp
    del logits, labels
    torch.cuda.empty_cache()


TR_SCHEMA = ["train_loss", "val_mIoU_b1_mIoU", "val_mIoU_b2_mIoU", "val_mIoU_mIoU", "lr"]


def training_path(S, Hk, kernels, torch):
    """Phase 4b.  Trains the flagship through the CLIs, each run with every
    kernel's count set to 0 just before it; returns the sort's and the
    unsort's launches on the default (per-batch Lovász) run and E's and F's
    on the -G run, and each run's epoch loss."""
    from ee_semantic_segmentation_tpu_torch.cli import eval_miou, main_bradeepv3, main_bradeepv3_ce
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import load_config

    n_train, bs, steps = 64, 16, 4  # synthetic train split: 4 steps of batch 16
    base = ["-t", "resnet50", "-n", "2", "-D", "512", "-b", str(bs), "-e", "1", "-d", "synthetic",
            "-l", "0.01", "--accum_steps", str(TRAIN_ACCUM)]
    runs = (("lovasz", main_bradeepv3, []), ("lovasz_per_image", main_bradeepv3, ["-P"]),
            ("hist_lovasz", main_bradeepv3, ["-G", str(HIST_BINS)]),
            ("ce", main_bradeepv3_ce, []))
    launches, epoch_loss = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for i, (name, cli, extra) in enumerate(runs):
                for k in kernels:
                    k.launches = 0
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                ckpt = cli.main(base + extra + ["-N", name])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = {k.__name__: k.launches for k in kernels}
                print(f"[train-path] {cli.__name__.rsplit('.', 1)[1]} {' '.join(extra)}: "
                      f"{wall:.2f} s wall (build + 1 epoch + validation + test), launches {counts}, "
                      f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                want = {k: steps * TRAIN_ACCUM if name.startswith("lovasz") else 0
                        for k in S.KERNELS}
                for k in Hk.KERNELS:
                    want[k] = steps * TRAIN_ACCUM if name == "hist_lovasz" else 0
                for k, n in want.items():
                    check(k.launches == n, f"{name}: {k.__name__} launched {k.launches} times, "
                                           f"want {n}")
                if name == "lovasz":
                    launches.update({k.__name__: k.launches for k in S.KERNELS})
                if name == "hist_lovasz":
                    launches.update({k.__name__: k.launches for k in Hk.KERNELS})
                cfg = load_config(ckpt)
                check(cfg.segment_ends == (12, 15) and cfg.n_exits == 3,
                      f"{name}: trained model is not the flagship: {cfg}")
                tr = read_csv(os.path.join(tmp, "synthetic_results", name, f"{name}_tr.csv"))
                check(len(tr) == 1 and list(tr[0]) == TR_SCHEMA,
                      f"{name}_tr.csv: {tr} (want one row of {TR_SCHEMA})")
                check(all(math.isfinite(float(r["train_loss"])) for r in tr),
                      f"{name}: epoch loss not finite: {tr}")
                res = read_csv("mIoU_2_branches_results.csv")
                check(len(res) == i + 1 and list(res[0]) == MIOU_SCHEMA,
                      f"mIoU_2_branches_results.csv: {res}")
                epoch_loss[name] = float(tr[0]["train_loss"])
                print(f"[train-path] {name}: epoch loss {tr[0]['train_loss']}, val "
                      f"{[tr[0][c] for c in TR_SCHEMA[1:4]]}, test row {dict(res[-1])}")
                eval_miou.main(["-M", ckpt, "-c", str(C), "-D", "512", "512", "-d", "synthetic",
                                "-b", "16", "-s", f"eval_{name}"])
                ev = read_csv(f"eval_{name}.csv")
                check(len(ev) == 1 and list(ev[0]) == MIOU_SCHEMA,
                      f"eval_miou of the {name} checkpoint: {ev}")
        finally:
            os.chdir(cwd)
        torch.cuda.empty_cache()
    return launches, epoch_loss


# each loss kernel's CUDA kernels, by the start of their names in a trace
LOSS_CUDA_KERNELS = {"sort_rows": ("radix_",), "unsort_rows": ("unsort_",),
                     "hist2d_weighted": ("hist_kernel", "hist_finalize_kernel"),
                     "table_lookup": ("lookup_",)}


def training_throughput(torch):
    """Phase 4b, end: train-step images/s of the flagship over pre-loaded
    batches (the first step warms up; 4 more timed with CUDA events), then
    one more step of each Lovász loss under ``torch.profiler``: the device
    time of each loss kernel inside the step (a sort and an unsort, or one E
    and one F) and their share of the step.  Returns (images/s, share,
    {loss: {kernel: in-step ms}})."""
    from ee_semantic_segmentation_tpu_torch.cli.common import resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.ops.branchy import LovaszSoftmax
    from ee_semantic_segmentation_tpu_torch.ops.kernels import hist as Hk
    from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as S
    from ee_semantic_segmentation_tpu_torch.ops.xentropy import BrXEntropyLoss
    from ee_semantic_segmentation_tpu_torch.parallel.train_step import make_train_step
    from ee_semantic_segmentation_tpu_torch.train.optim import (
        branchy_lr_multipliers,
        make_optimizer,
    )

    bs = 16
    batches = [tuple(torch.from_numpy(b[k]).cuda() for k in ("image", "label"))
               for b in DataLoader(resolve_test_set("synthetic", 512), bs)]
    losses = {
        "lovasz": LovaszSoftmax(ignore=C, n_branches=2),
        "lovasz_per_image": LovaszSoftmax(ignore=C, n_branches=2, per_image=True),
        "hist_lovasz": LovaszSoftmax(ignore=C, n_branches=2, hist_bins=HIST_BINS),
        "hist_lovasz_per_image": LovaszSoftmax(ignore=C, n_branches=2, per_image=True,
                                               hist_bins=HIST_BINS),
        # -G above the 8192 buckets one block of kernel E keeps
        f"hist_lovasz_{HIST_WIDE_BINS[0]}": LovaszSoftmax(ignore=C, n_branches=2,
                                                          hist_bins=HIST_WIDE_BINS[0]),
        "ce": BrXEntropyLoss(ignore_index=C, b_reduction="sum", n_exits=3),
    }
    ips, share, in_step = {}, {}, {}
    for name, loss_fn in losses.items():
        torch.manual_seed(0)
        model = build_branchy_deeplabv3(depth=50, n=2, img_dim=512, count_branches=False)
        model = model.cuda().to(memory_format=torch.channels_last)
        opt = make_optimizer(model, branchy_lr_multipliers(2, 0.01))
        step = make_train_step(model, loss_fn, opt, accum_steps=TRAIN_ACCUM)
        step(*batches[0], 0.01)  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        for k in S.KERNELS + Hk.KERNELS:
            k.launches = 0
        times = []
        for i in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(*batches[i % len(batches)], 0.01)
            end.record()
            torch.cuda.synchronize()
            check(math.isfinite(float(loss)), f"{name}: train-step loss {float(loss)}")
            times.append(start.elapsed_time(end))
        kind = "lovasz" if name.startswith("lovasz") else "hist" if name.startswith("hist") else ""
        for k in S.KERNELS + Hk.KERNELS:  # one call of the loss's kernels a step
            want = 4 if k in {"lovasz": S.KERNELS, "hist": Hk.KERNELS}.get(kind, ()) else 0
            check(k.launches == want, f"{name}: {k.__name__} launched {k.launches} times in 4 "
                                      f"steps, want {want}")
        step_ms = statistics.mean(times)
        ips[f"train {name}"] = bs / (step_ms / 1e3)
        print(f"[train-throughput] {name}: step {step_ms:.1f} ms (steps {[round(t, 1) for t in times]}), "
              f"{ips[f'train {name}']:.2f} images/s at 512x512 batch {bs}")
        if name != "ce":
            want = ({"radix_": 16, "unsort_": 2} if name.startswith("lovasz")
                    else {"hist_kernel": 1, "hist_finalize_kernel": 1, "lookup_": 1})
            trace = per_kernel_ms(lambda: step(*batches[0], 0.01), torch, want)
            if trace is None:  # no reading: null in the kernels line
                in_step[name] = dict.fromkeys(LOSS_CUDA_KERNELS)
                share[name] = None
                print(f"[train-profile] {name}: the loss kernels' device ms not measured")
            else:
                found = {k: kernels_of(trace, starts) for k, starts in LOSS_CUDA_KERNELS.items()}
                in_step[name] = {k: ms for k, (_, ms) in found.items()}
                launches = {k: n for k, (n, _) in found.items()}
                kernel_ms = sum(in_step[name].values())
                share[name] = kernel_ms / step_ms
                cuda = {k: v for k, v in trace.items()
                        if k.startswith(sum(LOSS_CUDA_KERNELS.values(), ()))}
                print(f"[train-profile] {name}: one step under torch.profiler, the loss kernels' "
                      f"device ms {json.dumps({k: round(v, 3) for k, v in in_step[name].items()})} "
                      f"(CUDA launches {launches}; per CUDA kernel [launches, ms] {cuda}): "
                      f"{kernel_ms:.2f} ms = {100 * share[name]:.2f} % of the {step_ms:.1f} ms "
                      "step")
        del model, opt, step, loss
        torch.cuda.empty_cache()
    return ips, share, in_step


def read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def as_float(v: str) -> float:
    return float(v) if v != "" else float("nan")


MIOU_SCHEMA = ["net_id", "b1_mIoU", "b2_mIoU", "mIoU"]
ENT_SCHEMA = ["net_id", "b1_mIoU", "b1_count", "b2_mIoU", "b2_count", "mIoU_out",
              "count_out", "mIoU_gl", "out_gl", "t", "pool", "pool_size"]
SIM_SCHEMA = ENT_SCHEMA[:-2] + ["metric"]


def check_same_row(what, a_row, b_row):
    """Two evaluator results (dicts of CSV cells or of values): counts and
    strings equal, mIoU within TOL_MIOU_ABS (or NaN on both sides)."""
    for col, a in a_row.items():
        b = b_row[col]
        if col.endswith("count") or col in ("count_out", "out_gl", "net_id", "metric", "pool"):
            check(str(a) == str(b), f"{what} {col}: {a} vs {b}")
        else:
            a, b = (as_float(v) if isinstance(v, str) else v for v in (a, b))
            check((math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL_MIOU_ABS,
                  f"{what} {col}: {a} vs {b}")


def flagship_checkpoint(tmp, torch):
    """The flagship with seeded random weights, saved in ``tmp`` as the
    checkpoint that phases 4 and 4c evaluate; returns its path."""
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    torch.manual_seed(0)
    model = build_branchy_deeplabv3(depth=50, n=2, img_dim=512, count_branches=False)
    cfg = model.config
    check(cfg.segment_ends == (12, 15), f"flagship segment_ends {cfg.segment_ends} != (12, 15)")
    return save_checkpoint(tmp, "flagship", model, cfg)


def main_path(U, torch, tmp, ckpt):
    """Phase 4, in ``tmp`` on the flagship checkpoint ``ckpt``.  Returns each
    kernel's launches on its main-path run and the evaluators' images/s."""
    from ee_semantic_segmentation_tpu_torch.cli import (
        eval_br_ent,
        eval_br_images,
        eval_br_sim,
        eval_miou,
    )
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.batch_eval import (
        br_evaluator_entropy_fused,
        br_evaluator_similarity_fused,
        make_kernel_miou_step_fn,
        mIoU_evaluator_fused,
    )
    from ee_semantic_segmentation_tpu_torch.ops.gating import batched_similarity

    n_img, bs, tau = 16, 12, 0.5  # synthetic test split: 16 images, 2nd batch count=4
    launches, rows, ips, in_step = {}, {}, {}, {}
    cwd = os.getcwd()
    args = ["-M", ckpt, "-c", str(C), "-D", "512", "512", "-d", "synthetic", "-b", str(bs)]
    os.chdir(tmp)
    try:
        for key, kernel, cli, extra in (
            ("miou", U.upsample_argmax_confusion, eval_miou, []),
            ("ent", U.upsample_entropy_argmax, eval_br_ent, ["-t", str(tau)]),
            ("sim_ssim", U.upsample_argmax, eval_br_sim, ["-m", "ssim", "-t", str(tau)]),
            ("sim_nmi", U.upsample_argmax, eval_br_sim, ["-m", "nmi", "-t", str(tau)]),
            ("images_nmi", None, eval_br_images, ["-m", "nmi", "-t", str(tau)]),
        ):
            for head in ("kernel", "plain") if kernel else ("plain",):
                for k in U.KERNELS:
                    k.launches = 0
                t0 = time.perf_counter()
                cli.main(args + extra + ["-s", f"{key}_{head}"]
                         + (["--pallas_head"] if head == "kernel" else []))
                torch.cuda.synchronize()
                counts = {k.__name__: k.launches for k in U.KERNELS}
                print(f"[main-path] {cli.__name__.rsplit('.', 1)[1]} {head} head: "
                      f"{time.perf_counter() - t0:.2f} s wall (load + data + eval), "
                      f"launches {counts}")
                if head == "kernel":
                    launches[kernel.__name__] = kernel.launches
                    check(kernel.launches == 3 * 2,
                          f"{kernel.__name__} launched {kernel.launches} times, "
                          "want 3 exits x 2 batches")
                else:
                    check(not any(counts.values()), "the plain head launched a kernel")
                rows[key, head] = read_csv(f"{key}_{head}.csv")
                check(len(rows[key, head]) == 1, f"{key}_{head}.csv: want one row")

        # eval throughput over the same batches, loaded once up front
        model = load_model(ckpt, torch.device("cuda"))
        batches = list(DataLoader(resolve_test_set("synthetic", 512), bs))
        runs = {
            "eval_miou kernel head": lambda: mIoU_evaluator_fused(
                model, 3, C, batches, step=make_kernel_miou_step_fn(model, C)),
            "eval_miou plain head": lambda: mIoU_evaluator_fused(model, 3, C, batches),
            "eval_br_ent kernel head": lambda: br_evaluator_entropy_fused(
                model, 3, C, batches, tau, pallas_head=True),
            "eval_br_ent plain head": lambda: br_evaluator_entropy_fused(
                model, 3, C, batches, tau),
            "eval_br_sim kernel head": lambda: br_evaluator_similarity_fused(
                model, 3, C, batches, "ssim", tau, ignore=(C - 1,), pallas_head=True),
            "eval_br_sim plain head": lambda: br_evaluator_similarity_fused(
                model, 3, C, batches, "ssim", tau, ignore=(C - 1,)),
        }
        for name, fn in runs.items():
            fn()  # warm-up (cuDNN algorithm choice, allocator)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ips[name] = n_img / (time.perf_counter() - t0)
            print(f"[main-path] {name}: {ips[name]:.2f} images/s "
                  f"({n_img} images at 512x512, batch {bs}, evaluator over pre-loaded batches)")

        # each head kernel inside one batch of its evaluator (torch.profiler;
        # 3 exits, so 3 launches), beside the batch's time (CUDA events)
        one = batches[:1]
        for key, name, fn, starts in (
            ("A", "eval_miou", lambda: mIoU_evaluator_fused(
                model, 3, C, one, step=make_kernel_miou_step_fn(model, C)),
             ("up_argmax_conf_kernel",)),
            ("B", "eval_br_ent", lambda: br_evaluator_entropy_fused(
                model, 3, C, one, tau, pallas_head=True),
             ("up_ent_argmax_kernel", "ent_finalize_kernel")),
            ("C", "eval_br_sim", lambda: br_evaluator_similarity_fused(
                model, 3, C, one, "ssim", tau, ignore=(C - 1,), pallas_head=True),
             ("up_argmax_map_kernel",)),
        ):
            batch_ms = median_ms(fn, 5, 1)
            trace = per_kernel_ms(fn, torch, {starts[0]: 3})
            if trace is None:  # no reading: null in the kernels line
                in_step[key] = None
                print(f"[eval-profile] {name} kernel head: kernel {key}'s device ms not "
                      "measured")
                continue
            n, ms = kernels_of(trace, starts)
            in_step[key] = ms
            print(f"[eval-profile] {name} kernel head, one batch of {bs} at 512x512: kernel "
                  f"{key} ({', '.join(starts)}: {n} CUDA launches) {ms:.4f} ms of device time "
                  f"= {100 * ms / batch_ms:.3f} % of the {batch_ms:.2f} ms batch")

        # tau 0.5 sends every image of the random model to the final
        # head; a tau in the widest gap between two first-exit entropies
        # splits the images, so the gated buckets get checked too
        with torch.inference_mode():
            ent1 = torch.cat([
                U.upsample_entropy_argmax(
                    model.lowres_logits(torch.from_numpy(b["image"]).cuda())[0],
                    (512, 512))[1][:b["count"]]
                for b in batches]).sort().values.tolist()
        gap, i = max((ent1[j + 1] - ent1[j], j) for j in range(len(ent1) - 1))
        check(gap > 1e-5, f"first-exit entropies too close to split: {ent1}")
        tau_split = (ent1[i] + ent1[i + 1]) / 2
        split_k = br_evaluator_entropy_fused(model, 3, C, batches, tau_split, pallas_head=True)
        split_p = br_evaluator_entropy_fused(model, 3, C, batches, tau_split)
        print(f"[main-path] first-exit entropies {[round(e, 6) for e in ent1]}; "
              f"tau {tau_split:.6f}: kernel head {split_k}, plain head {split_p}")
        check(split_k["b1_count"] == i + 1, f"tau split: b1_count {split_k['b1_count']} != {i + 1}")
        check_same_row("tau split, kernel head vs plain head:", split_k, split_p)

        # the same for the similarity gate: a tau in the widest gap
        # between the exit-0/exit-1 similarities sends the images above
        # it to exit 2 (b2); exit 1 (b1) is never a gate position with
        # two branches
        for metric in ("ssim", "nmi"):
            with torch.inference_mode():
                sims = torch.cat([
                    batched_similarity(torch.stack([
                        U.upsample_argmax(l, (512, 512))
                        for l in model.lowres_logits(torch.from_numpy(b["image"]).cuda())[:2]
                    ]), metric, C, (C - 1,))[0, :b["count"]]
                    for b in batches]).sort().values.tolist()
            gap, i = max((sims[j + 1] - sims[j], j) for j in range(len(sims) - 1))
            check(gap > 1e-5, f"exit-0/exit-1 {metric} too close to split: {sims}")
            tau_split = (sims[i] + sims[i + 1]) / 2
            split_k = br_evaluator_similarity_fused(model, 3, C, batches, metric, tau_split,
                                                    ignore=(C - 1,), pallas_head=True)
            split_p = br_evaluator_similarity_fused(model, 3, C, batches, metric, tau_split,
                                                    ignore=(C - 1,))
            print(f"[main-path] exit-0/exit-1 {metric} {[round(v, 6) for v in sims]}; "
                  f"tau {tau_split:.6f}: kernel head {split_k}, plain head {split_p}")
            want_b2 = len(sims) - (i + 1)
            check(split_k["b1_count"] == 0 and split_k["b2_count"] == want_b2,
                  f"{metric} tau split: b1_count {split_k['b1_count']}, b2_count "
                  f"{split_k['b2_count']} (want 0 and {want_b2})")
            check_same_row(f"{metric} tau split, kernel head vs plain head:", split_k, split_p)
    finally:
        os.chdir(cwd)

    for (key, head), row in rows.items():
        schema = {"miou": MIOU_SCHEMA, "ent": ENT_SCHEMA}.get(key, SIM_SCHEMA)
        check(list(row[0]) == schema, f"{key} {head} CSV schema {list(row[0])} != {schema}")
    for col in ("b1_mIoU", "b2_mIoU", "mIoU"):
        a, b = as_float(rows["miou", "kernel"][0][col]), as_float(rows["miou", "plain"][0][col])
        print(f"[main-path] eval_miou {col}: kernel head {a!r}, plain head {b!r}")
        check((math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL_MIOU_ABS,
              f"eval_miou {col}: kernel head {a} vs plain head {b}")
    for key in ("ent", "sim_ssim", "sim_nmi", "images_nmi"):
        for head in ("kernel", "plain"):
            if (key, head) not in rows:
                continue
            g = rows[key, head][0]
            print(f"[main-path] {key} {head} head row {dict(g)}")
            exits = int(g["b1_count"]) + int(g["b2_count"]) + int(g["count_out"])
            check(exits == n_img and int(g["out_gl"]) == n_img,
                  f"{key}: exit counts sum to {exits} (out_gl {g['out_gl']}), want {n_img}")
        if (key, "kernel") in rows:
            check_same_row(f"{key}, kernel head vs plain head:", rows[key, "kernel"][0],
                           rows[key, "plain"][0])
    return launches, ips, in_step


# the JAX CLIs' ee_dnn_op columns (ee_dnn_op.py:229-255, sorted, net_id first)
EE_ENT_SCHEMA = ["net_id", "avg_flops", "e_1", "e_2", "edge_flops", "mIoU", "metric", "n_imgs",
                 "out", "t", "x", "y"]
EE_SIM_SCHEMA = ["net_id", "avg_flops", "avg_flops_2", "e_1", "e_2", "edge_flops",
                 "edge_flops_2", "ig_bk", "mIoU", "metric", "n_imgs", "out", "t", "x", "y"]
EE_EXITS = ("e_1", "e_2", "out")


def split_tau(first, every, what):
    """A tau between two of the first gated exit's values (so the images
    split), the one farthest from every gate value the engines compare;
    it must be more than 1e-5 from each, so that the kernel head's and the
    plain head's float32 roundings cannot move an image across it."""
    first = sorted(first)
    mids = [(a + b) / 2 for a, b in zip(first, first[1:])]
    tau = max(mids, key=lambda t: min(abs(t - v) for v in every))
    margin = min(abs(tau - v) for v in every)
    check(margin > 1e-5, f"{what}: no tau splits the images by 1e-5: {sorted(every)}")
    return tau


def implied_launches(exits, n):
    """(kernel B, kernel C) launches of the masked engine's kernel head on
    one micro-batch whose rows exit at ``exits`` (1-based, n + 1 = the final
    head): gated stage k runs while a row has exit > k, the final head while
    a row has exit n + 1."""
    top = max(exits)
    return min(top, n), int(top == n + 1)


def ee_path(U, torch, ckpt):
    """Phase 4c: the early-exit engines on the flagship checkpoint ``ckpt``.
    Returns the masked path's B and C launches, the engines' images/s and
    B's and C's device ms inside one masked micro-batch."""
    import numpy as np
    from PIL import Image

    from ee_semantic_segmentation_tpu_torch.cli import ee_dnn_op, ee_dnn_op_ne, eval_flops, eval_image
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from ee_semantic_segmentation_tpu_torch.ee.masked import make_masked_gated_apply
    from ee_semantic_segmentation_tpu_torch.ee.sequential import EarlyExitRunner
    from ee_semantic_segmentation_tpu_torch.ops.gating import batched_norm_entropy, batched_similarity

    n_img, bs, n = 16, 12, 2
    B, Ck = U.upsample_entropy_argmax, U.upsample_argmax
    model = load_model(ckpt, torch.device("cuda"))
    batches = list(DataLoader(resolve_test_set("synthetic", 512), bs))
    check([b["count"] for b in batches] == [12, 4], "phase 4c wants micro-batches of 12 and 4")
    xs = [torch.from_numpy(b["image"]).cuda() for b in batches]

    # gate values with the plain head, valid rows only: each branch's
    # entropy, the exit-0/exit-1 similarity (the only similarity gate of
    # two branches: the first gated exit seeds)
    ents, sims = [], {"ssim": [], "nmi": []}
    with torch.inference_mode():
        for x, b in zip(xs, batches):
            out = model(x)[:, :b["count"]]
            ents.append(batched_norm_entropy(out[:-1], C))
            maps = out[:2].argmax(dim=-1)
            for m in sims:
                sims[m].append(batched_similarity(maps, m, C, (0, C - 1))[0])
            del out, maps
    ent = torch.cat(ents, dim=1).tolist()  # (n, 16)
    sims = {m: torch.cat(v).tolist() for m, v in sims.items()}
    tau = split_tau(ent[0], ent[0] + ent[1], "entropy")
    tau_sim = {m: split_tau(v, v, m) for m, v in sims.items()}
    below = sum(e < tau for e in ent[0])
    print(f"[ee-path] first-exit entropies {[round(e, 6) for e in sorted(ent[0])]}: tau "
          f"{tau!r} ({below} below); ssim tau {tau_sim['ssim']!r}, nmi tau {tau_sim['nmi']!r}")

    base = ["-M", ckpt, "-s", "512", "512", "-d", "synthetic", "-n", str(C)]
    masked = ["--engine", "masked", "-b", str(bs)]
    runs = {  # name -> (CLI, argv, CSV it appends to)
        "seq ent": (ee_dnn_op_ne, ["-m", "ent", "-t", repr(tau)], "ee_2_ent_lw_m2_res.csv"),
        "masked ent plain head": (ee_dnn_op_ne, ["-m", "ent", "-t", repr(tau)] + masked,
                                  "ee_2_ent_lw_m2_res.csv"),
        "masked ent kernel head": (ee_dnn_op_ne, ["-m", "ent", "-t", repr(tau), "--pallas_head"]
                                   + masked, "ee_2_ent_lw_m2_res.csv"),
        "masked ent kernel head, tau above every entropy": (
            ee_dnn_op_ne, ["-m", "ent", "-t", "1.01", "--pallas_head"] + masked,
            "ee_2_ent_lw_m2_res.csv"),
        "masked ent kernel head, tau below every entropy": (
            ee_dnn_op_ne, ["-m", "ent", "-t", "0", "--pallas_head"] + masked,
            "ee_2_ent_lw_m2_res.csv"),
        "masked max -p 2, --pallas_head (plain head)": (
            ee_dnn_op_ne, ["-m", "max", "-p", "2", "-t", repr(tau), "--pallas_head"] + masked,
            "ee_2_max_lw_m2_res.csv"),
        "seq ssim -i": (ee_dnn_op, ["-m", "ssim", "-i", "-t", repr(tau_sim["ssim"])],
                        "ee_2_ssim_lw_m2_res.csv"),
        "seq nmi -i": (ee_dnn_op, ["-m", "nmi", "-i", "-t", repr(tau_sim["nmi"])],
                       "ee_2_nmi_lw_m2_res.csv"),
        "masked nmi -i": (ee_dnn_op, ["-m", "nmi", "-i", "-t", repr(tau_sim["nmi"])] + masked,
                          "ee_2_nmi_lw_m2_res.csv"),
    }
    rows, counts = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name, (cli, argv, csv_name) in runs.items():
                for k in U.KERNELS:
                    k.launches = 0
                t0 = time.perf_counter()
                cli.main(base + argv)
                torch.cuda.synchronize()
                counts[name] = {k.__name__: k.launches for k in U.KERNELS}
                got = read_csv(csv_name)
                rows[name] = got[-1]
                schema = EE_ENT_SCHEMA if cli is ee_dnn_op_ne else EE_SIM_SCHEMA
                check(list(got[-1]) == schema, f"{name}: CSV columns {list(got[-1])} != {schema}")
                exits = [int(rows[name][k]) for k in EE_EXITS]
                print(f"[ee-path] {cli.__name__.rsplit('.', 1)[1]} {name}: "
                      f"{time.perf_counter() - t0:.2f} s wall (load + data + engine), exits "
                      f"{dict(zip(EE_EXITS, exits))}, mIoU {rows[name]['mIoU']}, avg_flops "
                      f"{rows[name]['avg_flops']}, launches {counts[name]}")
                check(sum(exits) == int(rows[name]["n_imgs"]) == n_img,
                      f"{name}: exits {exits} do not sum to {n_img}")

            # eval_flops reads only the sidecar; eval_image writes a PNG an exit
            eval_flops.main(["-M", ckpt, "-s", "512"])
            (flops_row,) = read_csv("2_branches_model_flops.csv")
            want_cols = ["net_id", "x", "y", "b1_flops", "b2_flops", "b3_flops"]
            check(list(flops_row) == want_cols, f"eval_flops columns {list(flops_row)}")
            cum = model.flops_table(512)["cumulative_exits"]
            got_flops = [int(flops_row[f"b{i + 1}_flops"]) for i in range(3)]
            print(f"[ee-path] eval_flops -s 512: {got_flops} (flops_table(512): {cum})")
            check(got_flops == cum, "eval_flops b{i}_flops != flops_table(512)")
            g = torch.Generator().manual_seed(4)
            rgb = (torch.rand((384, 512, 3), generator=g) * 255).to(torch.uint8).numpy()
            Image.fromarray(rgb).save("probe.png")
            t0 = time.perf_counter()
            eval_image.main(["-M", ckpt, "-i", "probe.png"])
            torch.cuda.synchronize()
            x = (rgb.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            with torch.inference_mode():
                want = model(torch.from_numpy(x[None]).cuda()).argmax(dim=-1)[:, 0].cpu().numpy()
            for i in range(3):
                png = Image.open(f"flagship_images/probe_b{i + 1}.png")
                agree = float((want[i] == np.asarray(png)).mean())
                check(png.mode == "P" and png.size == (512, 384) and agree >= TOL_MAP_AGREE,
                      f"eval_image probe_b{i + 1}.png: mode {png.mode}, size {png.size}, "
                      f"{agree} of its pixels the exit's argmax")
            print(f"[ee-path] eval_image 512x384 probe: 3 palette PNGs, their indices the exits' "
                  f"argmax, {time.perf_counter() - t0:.2f} s wall")
        finally:
            os.chdir(cwd)

    seq, plain, kern = (rows[k] for k in ("seq ent", "masked ent plain head",
                                          "masked ent kernel head"))
    check(int(seq["e_1"]) == below, f"seq ent e_1 {seq['e_1']} != {below} below tau")
    for name in ("masked ent plain head", "masked ent kernel head"):
        for col in EE_EXITS:
            check(rows[name][col] == seq[col], f"{name} {col} {rows[name][col]} != seq's {seq[col]}")
        for col in ("avg_flops", "edge_flops"):
            check(math.isclose(float(rows[name][col]), float(seq[col]), rel_tol=1e-12),
                  f"{name} {col} {rows[name][col]} != seq's {seq[col]}")
    for col in ("avg_flops", "edge_flops"):
        check(kern[col] == plain[col], f"kernel head {col} {kern[col]} != plain head's {plain[col]}")
    check(abs(float(kern["mIoU"]) - float(plain["mIoU"])) <= TOL_MIOU_ABS,
          f"masked ent mIoU: kernel head {kern['mIoU']} vs plain head {plain['mIoU']}")
    for m, name in (("ssim", "seq ssim -i"), ("nmi", "seq nmi -i")):
        above = sum(v > tau_sim[m] for v in sims[m])  # ssim and nmi fire on sim > tau
        check((rows[name]["e_1"], rows[name]["e_2"]) == ("0", str(above)),
              f"{name}: e_1 {rows[name]['e_1']}, e_2 {rows[name]['e_2']} (want 0 and {above})")
    for col in EE_EXITS + ("avg_flops", "avg_flops_2", "edge_flops", "edge_flops_2"):
        a, b = rows["masked nmi -i"][col], rows["seq nmi -i"][col]
        check(math.isclose(float(a), float(b), rel_tol=1e-12), f"nmi {col}: masked {a}, seq {b}")
    check(abs(float(rows["masked nmi -i"]["mIoU"]) - float(rows["seq nmi -i"]["mIoU"]))
          <= TOL_MIOU_ABS, "nmi mIoU: masked vs seq")

    # the kernel head's launches, exactly: from each micro-batch's exits
    # (padded rows included) of the same engine called directly
    fn_k = make_masked_gated_apply(model, tau=tau, n_classes=C, pallas_head=True)
    fn_p = make_masked_gated_apply(model, tau=tau, n_classes=C)
    check(fn_k.kernel_head and not fn_p.kernel_head, "the masked engine picked the wrong head")
    row_exits = [fn_k(x)[1].tolist() for x in xs]
    hist = [e for r, b in zip(row_exits, batches) for e in r[:b["count"]]]
    check([hist.count(e) for e in (1, 2, 3)] == [int(kern[c]) for c in EE_EXITS],
          f"direct masked exits {hist} != the CLI's histogram")
    implied = [implied_launches(r, n) for r in row_exits]
    want = {"split tau": tuple(map(sum, zip(*implied))), "above": (2, 0), "below": (4, 2)}
    for key, name in (("split tau", "masked ent kernel head"),
                      ("above", "masked ent kernel head, tau above every entropy"),
                      ("below", "masked ent kernel head, tau below every entropy")):
        got = (counts[name][B.__name__], counts[name][Ck.__name__])
        print(f"[ee-path] {name}: B, C launched {got}, the exits imply {want[key]}")
        check(got == want[key], f"{name}: B, C launched {got}, want {want[key]}")
        check(counts[name][U.upsample_argmax_confusion.__name__] == 0, f"{name} launched A")
    for name in ("seq ent", "masked ent plain head", "masked max -p 2, --pallas_head (plain head)",
                 "seq ssim -i", "seq nmi -i", "masked nmi -i"):
        check(not any(counts[name].values()), f"{name}: a plain head launched {counts[name]}")

    # images/s over the pre-loaded micro-batches (and single images for the
    # sequential engine): the median of 3 passes after one warm-up pass
    singles = [x[i:i + 1] for x, b in zip(xs, batches) for i in range(b["count"])]
    runner = EarlyExitRunner(model, metric="ent", threshold=tau, n_classes=C, img_dim=512)
    fn_above = make_masked_gated_apply(model, tau=1.01, n_classes=C, pallas_head=True)
    seq_exits = []
    ips = {}
    for name, fn in (("masked kernel head", lambda: [fn_k(x) for x in xs]),
                     ("masked plain head", lambda: [fn_p(x) for x in xs]),
                     ("seq", lambda: seq_exits.append([runner(x)["n"] for x in singles])),
                     ("masked kernel head, tau above every entropy",
                      lambda: [fn_above(x) for x in xs])):
        fn()
        passes = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
        ips[name] = n_img / statistics.median(passes)
        how = "one at a time" if name == "seq" else f"micro-batches of {bs}"
        print(f"[ee-path] ee_dnn_op_ne {name}, ent tau {1.01 if 'above' in name else tau:.6f}: "
              f"{ips[name]:.2f} images/s ({n_img} images at 512x512, {how}, pre-loaded; "
              f"passes {[round(p * 1e3, 2) for p in passes]} ms)")
    check(sorted(seq_exits[-1]) == sorted(hist), "sequential engine exits != masked engine's")

    # B and C inside one masked micro-batch of 12 (torch.profiler), beside
    # the batch's time (CUDA events, host reads included); device busy time
    # from every kernel in the trace, the rest idle
    in_batch = {}
    for label, t in (("split tau", tau), ("tau above every entropy", 1.01)):
        fn = make_masked_gated_apply(model, tau=t, n_classes=C, pallas_head=True)
        nb, nc = implied_launches(fn(xs[0])[1].tolist(), n)
        batch_ms = median_ms(lambda: fn(xs[0]), 5, 1)
        want_k = {"up_ent_argmax_kernel": nb, **({"up_argmax_map_kernel": nc} if nc else {})}
        trace = per_kernel_ms(lambda: fn(xs[0]), torch, want_k)
        if trace is None:
            print(f"[ee-profile] masked kernel head, {label}: not measured")
            in_batch[label] = {"B": None, "C": None}
            continue
        b_n, b_ms = kernels_of(trace, ("up_ent_argmax_kernel", "ent_finalize_kernel"))
        c_n, c_ms = kernels_of(trace, ("up_argmax_map_kernel",))
        busy = sum(ms for _, ms in trace.values())
        in_batch[label] = {"B": b_ms, "C": c_ms if nc else None, "batch_ms": batch_ms,
                           "busy_ms": busy}
        print(f"[ee-profile] masked kernel head, {label}, one micro-batch of {bs} at 512x512 "
              f"({nb} gated stages, final head {'run' if nc else 'skipped'}): kernel B "
              f"({b_n} CUDA launches) {b_ms:.4f} ms = {100 * b_ms / batch_ms:.3f} %, kernel C "
              f"({c_n}) {c_ms:.4f} ms = {100 * c_ms / batch_ms:.3f} % of the {batch_ms:.2f} ms "
              f"batch; device busy {busy:.2f} ms, idle {batch_ms - busy:.2f} ms "
              f"({100 * (batch_ms - busy) / batch_ms:.1f} %)")
    launches = {B.__name__: counts["masked ent kernel head"][B.__name__],
                Ck.__name__: counts["masked ent kernel head"][Ck.__name__]}
    return launches, ips, in_batch, tau


def mobilenet_path(U, S, torch):
    """Phase 4d: the 2-exit MobileNetV3 branchy DeepLabV3 at 512² (seeded
    random weights): its placement and FLOPs table, ``eval_miou``,
    ``eval_br_ent`` and ``eval_br_sim`` (ssim) with both heads (rows equal,
    A, B and C launched once an exit and a batch), the evaluators' images/s
    over pre-loaded batches, and one epoch of ``main_bradeepv3 -t
    mobilenet`` at batch 16 (one sort and one unsort a step).  Returns the
    kernels' launches on the eval paths and the images/s."""
    from ee_semantic_segmentation_tpu_torch.cli import eval_br_ent, eval_br_sim, eval_miou
    from ee_semantic_segmentation_tpu_torch.cli import main_bradeepv3
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.batch_eval import (
        br_evaluator_entropy_fused,
        br_evaluator_similarity_fused,
        make_kernel_miou_step_fn,
        mIoU_evaluator_fused,
    )
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import load_config, save_checkpoint

    n_img, bs, tau = 16, 12, 0.5
    torch.manual_seed(0)
    model = build_branchy_deeplabv3(n=2, img_dim=512, backbone="mobilenet_v3_large")
    cfg = model.config
    table = model.flops_table()
    print(f"[mnv3-path] build_branchy_deeplabv3(n=2, img_dim=512, backbone='mobilenet_v3_large'): "
          f"segment_ends {cfg.segment_ends}, branch_channels {cfg.branch_channels}, "
          f"{cfg.n_exits} exits; FLOPs table {json.dumps(table)}")
    check(cfg.segment_ends == (11,) and cfg.branch_channels == (112,),
          f"MobileNetV3 placement {cfg.segment_ends}, {cfg.branch_channels} != (11,), (112,)")
    E = cfg.n_exits
    launches, ips = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(tmp, "mnv3", model, cfg)
        del model
        args = ["-M", ckpt, "-c", str(C), "-D", "512", "512", "-d", "synthetic", "-b", str(bs)]
        os.chdir(tmp)
        try:
            for key, kernel, cli, extra in (
                ("miou", U.upsample_argmax_confusion, eval_miou, []),
                ("ent", U.upsample_entropy_argmax, eval_br_ent, ["-t", str(tau)]),
                ("sim_ssim", U.upsample_argmax, eval_br_sim, ["-m", "ssim", "-t", str(tau)]),
            ):
                rows = {}
                for head in ("kernel", "plain"):
                    for k in U.KERNELS:
                        k.launches = 0
                    t0 = time.perf_counter()
                    cli.main(args + extra + ["-s", f"mnv3_{key}_{head}"]
                             + (["--pallas_head"] if head == "kernel" else []))
                    torch.cuda.synchronize()
                    counts = {k.__name__: k.launches for k in U.KERNELS}
                    print(f"[mnv3-path] {cli.__name__.rsplit('.', 1)[1]} {head} head: "
                          f"{time.perf_counter() - t0:.2f} s wall (load + data + eval), "
                          f"launches {counts}")
                    want = {k.__name__: E * 2 if head == "kernel" and k is kernel else 0
                            for k in U.KERNELS}  # an exit a batch, 2 batches
                    check(counts == want, f"mnv3 {key} {head} head launched {counts}, want {want}")
                    if head == "kernel":
                        launches[kernel.__name__] = kernel.launches
                    (rows[head],) = read_csv(f"mnv3_{key}_{head}.csv")
                print(f"[mnv3-path] {key} kernel head row {dict(rows['kernel'])}")
                check_same_row(f"mnv3 {key}, kernel head vs plain head:", rows["kernel"],
                               rows["plain"])
                if key != "miou":
                    exits = sum(int(v) for c, v in rows["kernel"].items()
                                if c.endswith("count") or c == "count_out")
                    check(exits == n_img == int(rows["kernel"]["out_gl"]),
                          f"mnv3 {key}: exit counts sum to {exits}, want {n_img}")

            model = load_model(ckpt, torch.device("cuda"))
            batches = list(DataLoader(resolve_test_set("synthetic", 512), bs))
            runs = {
                "eval_miou kernel head": lambda: mIoU_evaluator_fused(
                    model, E, C, batches, step=make_kernel_miou_step_fn(model, C)),
                "eval_miou plain head": lambda: mIoU_evaluator_fused(model, E, C, batches),
                "eval_br_ent kernel head": lambda: br_evaluator_entropy_fused(
                    model, E, C, batches, tau, pallas_head=True),
                "eval_br_ent plain head": lambda: br_evaluator_entropy_fused(
                    model, E, C, batches, tau),
                "eval_br_sim kernel head": lambda: br_evaluator_similarity_fused(
                    model, E, C, batches, "ssim", tau, ignore=(C - 1,), pallas_head=True),
                "eval_br_sim plain head": lambda: br_evaluator_similarity_fused(
                    model, E, C, batches, "ssim", tau, ignore=(C - 1,)),
            }
            for name, fn in runs.items():
                fn()  # warm-up (cuDNN algorithm choice, allocator)
                passes = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    passes.append(time.perf_counter() - t0)
                ips[f"mnv3 {name}"] = n_img / statistics.median(passes)
                print(f"[mnv3-path] {name}: {ips[f'mnv3 {name}']:.2f} images/s ({n_img} images "
                      f"at 512x512, batch {bs}, evaluator over pre-loaded batches, median of 3 "
                      f"passes {[round(p * 1e3, 2) for p in passes]} ms)")
            del model
            torch.cuda.empty_cache()

            for k in U.KERNELS + S.KERNELS:
                k.launches = 0
            t0 = time.perf_counter()
            ckpt = main_bradeepv3.main(["-t", "mobilenet", "-n", "2", "-D", "512", "-b", "16",
                                        "-e", "1", "-d", "synthetic", "-l", "0.01", "-N",
                                        "mnv3_train"])
            torch.cuda.synchronize()
            counts = {k.__name__: k.launches for k in U.KERNELS + S.KERNELS}
            trained = load_config(ckpt)
            (tr,) = read_csv(os.path.join(tmp, "synthetic_results", "mnv3_train",
                                          "mnv3_train_tr.csv"))
            print(f"[mnv3-path] main_bradeepv3 -t mobilenet -n 2 -b 16: "
                  f"{time.perf_counter() - t0:.2f} s wall (build + 1 epoch + validation + test), "
                  f"{trained.n_exits} exits (segment_ends {trained.segment_ends}), launches "
                  f"{counts}, epoch loss {tr['train_loss']}")
            check(trained.backbone == "mobilenet_v3_large" and trained.n_exits == 3,
                  f"-t mobilenet trained {trained}")
            check(math.isfinite(float(tr["train_loss"])), f"-t mobilenet epoch loss {tr}")
            want = {k.__name__: 4 if k in S.KERNELS else 0 for k in U.KERNELS + S.KERNELS}
            check(counts == want, f"-t mobilenet launched {counts}, want {want} (4 steps)")
        finally:
            os.chdir(cwd)
    return launches, ips


def serving_path(torch, ckpt, tau):
    """Phase 4e: ``BatchedEarlyExitServer`` on the flagship at micro-batch
    12 and phase 4c's split tau, over 48 pre-loaded images (the 16 test
    images three times, so tau keeps its margin from every entropy): exits
    equal the masked engine's plain head on the same micro-batches and
    maps agree on TOL_MAP_AGREE of the pixels; ``stats()`` and images/s
    (median of 3 passes after a warm-up)."""
    import numpy as np

    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.masked import make_masked_gated_apply
    from ee_semantic_segmentation_tpu_torch.ee.serving import BatchedEarlyExitServer

    bs = 12
    model = load_model(ckpt, torch.device("cuda"))
    test = [b["image"][:b["count"]] for b in DataLoader(resolve_test_set("synthetic", 512), 16)]
    images = torch.from_numpy(np.concatenate(test * 3)).cuda()
    check(images.shape[0] == 48, f"serving wants 48 images, got {images.shape[0]}")
    plain = make_masked_gated_apply(model, tau=tau, n_classes=C)
    want_maps, want_exits = (torch.cat(t) for t in zip(*(plain(x) for x in images.split(bs))))
    results, passes, stats = None, [], None
    for i in range(4):  # a warm-up pass, then 3 timed
        server = BatchedEarlyExitServer(model, tau=tau, batch_size=bs, n_classes=C)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uids = server.submit(images)
        results = server.flush()
        torch.cuda.synchronize()
        if i:
            passes.append(time.perf_counter() - t0)
        stats = server.stats()
    exits = [results[u]["n"] for u in uids]
    maps = torch.from_numpy(np.stack([results[u]["label_map"] for u in uids]))
    agree = float((maps == want_maps.cpu()).float().mean())
    ips = 48 / statistics.median(passes)
    print(f"[serving] BatchedEarlyExitServer, flagship, micro-batch {bs}, tau {tau!r}: 48 images "
          f"at 512x512 in {ips:.2f} images/s (passes {[round(p * 1e3, 2) for p in passes]} ms); "
          f"exits {[exits.count(e) for e in (1, 2, 3)]} (masked plain head "
          f"{[want_exits.tolist().count(e) for e in (1, 2, 3)]}); maps agree {agree:.7f} "
          f"({int((maps != want_maps.cpu()).sum())} differing pixels); stats {json.dumps(stats)}")
    check(exits == want_exits.tolist(), "server exits != the masked engine's plain head")
    check(agree >= TOL_MAP_AGREE, f"server maps agree on {agree:.7f} < {TOL_MAP_AGREE}")
    check(len(set(exits)) > 1, f"the split tau did not split the served images: {exits}")
    return {"serving images/s": ips}, stats


TOL_EXPORT_REL = 1e-5  # exported eval forward vs the live model (TF32 off), of the largest logit


def export_path(U, torch, ckpt, tau):
    """Phase 4f: ``export_gated(batch_size=12, pallas_head=True)`` of the
    flagship at phase 4c's split tau, saved, loaded and run on the two
    test micro-batches: labels and exits equal the eager masked kernel
    head's, B and C launched as the exits imply; then
    ``export_eval_forward(batch_size=12)``: logits within TOL_EXPORT_REL of
    the live model with TF32 off.  Returns the exported engine's launches
    and images/s."""
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.aot import (
        export_eval_forward,
        export_gated,
        load_exported,
        manifest_for,
        save_exported,
    )
    from ee_semantic_segmentation_tpu_torch.ee.masked import make_masked_gated_apply

    bs, n = 12, 2
    model = load_model(ckpt, torch.device("cuda"))
    xs = [torch.from_numpy(b["image"]).cuda()
          for b in DataLoader(resolve_test_set("synthetic", 512), bs)]
    ips = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = save_exported(export_gated(model, bs, tau=tau, n_classes=C, pallas_head=True),
                             os.path.join(tmp, "gated"), {"head": "gated"})
        program = load_exported(path).module()
        man = manifest_for(path)
        print(f"[export] export_gated(batch_size={bs}, pallas_head=True), tau {tau!r}: exported, "
              f"saved and loaded in {time.perf_counter() - t0:.2f} s; {man['bytes']} bytes, "
              f"device {man['device']}, in {man['in_avals']}, out {man['out_avals']}")
        live = make_masked_gated_apply(model, tau=tau, n_classes=C, pallas_head=True)
        want = [live(x) for x in xs]
        for k in U.KERNELS:
            k.launches = 0
        with torch.no_grad():
            got = [program(x) for x in xs]
        torch.cuda.synchronize()
        counts = (U.upsample_entropy_argmax.launches, U.upsample_argmax.launches)
        implied = tuple(map(sum, zip(*(implied_launches(e.tolist(), n) for _, e in want))))
        print(f"[export] exported engine on 2 micro-batches: exits "
              f"{[e.tolist() for _, e in got]}; B, C launched {counts}, the exits imply {implied}")
        for (gl, ge), (wl, we) in zip(got, want):
            check(torch.equal(ge, we) and torch.equal(gl, wl),
                  "the exported gated engine differs from the eager masked kernel head")
        check(counts == implied, f"exported engine: B, C launched {counts}, want {implied}")
        check(U.upsample_argmax_confusion.launches == 0, "the exported engine launched A")
        launches = {"exported " + k.__name__: k.launches for k in U.KERNELS[1:]}
        with torch.no_grad():
            program(xs[0])
            passes = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for x in xs:
                    program(x)
                torch.cuda.synchronize()
                passes.append(time.perf_counter() - t0)
        ips["exported gated kernel head images/s"] = 16 / statistics.median(passes)
        print(f"[export] exported gated kernel head: "
              f"{ips['exported gated kernel head images/s']:.2f} images/s (16 images at 512x512 "
              f"in micro-batches of {bs}, passes {[round(p * 1e3, 2) for p in passes]} ms)")
        del program

        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            t0 = time.perf_counter()
            path = save_exported(export_eval_forward(model, bs), os.path.join(tmp, "fwd"),
                                 {"head": "logits"})
            program = load_exported(path).module()
            with torch.no_grad():
                got, want = program(xs[0]), model(xs[0])
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            print(f"[export] export_eval_forward(batch_size={bs}) in "
                  f"{time.perf_counter() - t0:.2f} s: logits {tuple(got.shape)} max|d| {err:.3g} "
                  f"of max|logit| {scale:.3g} (TF32 off)")
            check(err <= TOL_EXPORT_REL * scale,
                  f"exported eval forward: max|d| {err} > {TOL_EXPORT_REL} x {scale}")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    del model
    torch.cuda.empty_cache()
    return launches, ips


# ----------------------------------------------------------------- phase 4g
# The sharp check of the data-parallel training path on the card is its
# first step in float64 from the same weights on the same rows (the first
# DP_F64_ROWS of the batch, cross-entropy, cuDNN deterministic): the
# update of every parameter and BatchNorm running statistic (after -
# before) within DP_F64_RTOL of the largest one-process update of that
# entry, and the state within DP_F64_RTOL of its largest value.  It runs
# the fused CUDA BatchNorm and the gradient all-reduce over NCCL.  In
# float32 the same comparison cannot be sharp: a BatchNorm's bias (or
# scale) gradient is a sum over a million pixels that cancels to a small
# value, a BatchNorm after it removing most of it, so another summation
# order moves it by percents (2.9e-2 of the largest in the worst entry,
# PERF.md); and the per-batch Lovász gradient moves wherever its float32
# errors, tied by the thousands, reorder.  The float32 first steps (TF32
# off, cuDNN deterministic; cross-entropy and the per-batch Lovász loss)
# are held to the one-process loss within DP_STEP1_RTOL, and their state
# differences are printed beside those of two one-process runs.  The
# global BatchNorm's fused CUDA branch (forward and backward, through
# NCCL) is held to its plain branch on the same card tensors within
# DP_BN_RTOL of each output's largest value.  tests/test_torch_dist.py
# holds the path to the one-process step in float64 on the CPU.  The epoch
# loss of a CLI training run against phase 4b's is a smoke check only:
# within DP_LOSS_SPREAD times the difference between two one-process runs
# of the same 4 steps (cuDNN's backward need not be deterministic), and
# never held tighter than DP_LOSS_FLOOR relative, since at random init a
# float32 rounding difference in one step grows by orders of magnitude
# over the next ones.
DP_LOSS_SPREAD = 3.0
DP_LOSS_FLOOR = 5e-2
DP_STEP1_RTOL = 1e-4
DP_F64_RTOL = 1e-6
DP_F64_ROWS = 4
DP_BN_RTOL = 1e-4
DP_BN_SHAPE = (8, 256, 64, 64)  # a flagship layer's channels, channels-last
DP_TRAIN_RUNS = {"lovasz": [], "hist_lovasz": ["-G", str(HIST_BINS)]}


def dp_plan(ckpt, tau, out_dir):
    """The CLI runs of phase 4g: name -> (CLI module, argv), the same argv
    for the one-process and the data-parallel runs."""
    ev = ["-M", ckpt, "-c", str(C), "-D", "512", "512", "-d", "synthetic", "-b", "12",
          "--pallas_head"]
    runs = {
        "eval_miou": ("eval_miou", ev + ["-s", "miou"]),
        "eval_br_ent": ("eval_br_ent", ev + ["-t", repr(tau), "-s", "ent"]),
        "eval_br_sim": ("eval_br_sim", ev + ["-m", "ssim", "-t", "0.5", "-s", "sim"]),
        "ee_dnn_op_ne masked": ("ee_dnn_op_ne", [
            "-M", ckpt, "-m", "ent", "-t", repr(tau), "-s", "512", "512", "-d", "synthetic",
            "-n", str(C), "--engine", "masked", "-b", "12", "--pallas_head"]),
    }
    for name, extra in DP_TRAIN_RUNS.items():
        runs[name] = ("main_bradeepv3", [
            "-t", "resnet50", "-n", "2", "-D", "512", "-b", "16", "-e", "1", "-d", "synthetic",
            "-l", "0.01", "--accum_steps", str(TRAIN_ACCUM), "-N", name] + extra)
    return {"dir": str(out_dir), "ckpt": ckpt, "runs": runs}


DP_CSVS = {"eval_miou": "miou.csv", "eval_br_ent": "ent.csv", "eval_br_sim": "sim.csv",
           "ee_dnn_op_ne masked": "ee_2_ent_lw_m2_res.csv"}


def dp_kernels():
    from ee_semantic_segmentation_tpu_torch.ops.kernels import hist as Hk
    from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as S
    from ee_semantic_segmentation_tpu_torch.ops.kernels import upsample_argmax as U

    return U.KERNELS + S.KERNELS + Hk.KERNELS


def dp_run(torch, module, argv):
    """One CLI run in this process with every kernel's count and every
    collective's count set to 0 just before it: (wall s, launches,
    collectives)."""
    import importlib

    from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

    cli = importlib.import_module(f"{PKG}.cli.{module}")
    for k in dp_kernels():
        k.launches = 0
    pm.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(list(argv))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, {k.__name__: k.launches for k in dp_kernels()},
            dict(pm.COLLECTIVES))


def dp_bn_check(torch, mesh):
    """The global BatchNorm's fused CUDA branch against its plain branch on
    the same card tensors (float32, channels-last ``DP_BN_SHAPE``): y, the
    global mean and variance, and the input, scale and shift gradients.
    Returns {output: max|fused - plain| / max|plain|}."""
    from ee_semantic_segmentation_tpu_torch.models.resnet import _GlobalBatchNorm

    g = torch.Generator(device=mesh.device).manual_seed(3)
    x = (torch.randn(DP_BN_SHAPE, device=mesh.device, generator=g) * 2 + 0.5).to(
        memory_format=torch.channels_last)
    gy = torch.randn(DP_BN_SHAPE, device=mesh.device, generator=g).to(
        memory_format=torch.channels_last)
    w = torch.rand(DP_BN_SHAPE[1], device=mesh.device, generator=g) + 0.5
    b = torch.randn(DP_BN_SHAPE[1], device=mesh.device, generator=g)
    outs = {}
    for fused in (True, False):
        xi, wi, bi = (t.detach().clone().requires_grad_() for t in (x, w, b))
        y, mean, var = _GlobalBatchNorm.apply(xi, wi, bi, 1e-5, mesh, fused)
        y.backward(gy)
        outs[fused] = {"y": y, "mean": mean, "var": var, "dx": xi.grad, "dscale": wi.grad,
                       "dshift": bi.grad}
    return {k: float((outs[True][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
            for k, v in outs[False].items()}


def _state_errors(s0, s1, t0, t1):
    """Worst entry of two runs' states after a step (s1 one process, t1
    data parallel, from s0 and t0): (max over entries of max|t1 - s1| /
    max|s1|, the same of the updates t1 - t0 against s1 - s0, the entry)."""
    worst_state = worst_update = 0.0
    worst_key = None
    for k, a in s1.items():
        b = t1[k]
        if not a.is_floating_point():
            check(bool((a == b).all()), f"first step: {k} {b} vs {a}")
            continue
        worst_state = max(worst_state, float((b - a).abs().max() / a.abs().max().clamp_min(1e-30)))
        da, db = a - s0[k], b - t0[k]
        scale = float(da.abs().max())
        err = float((db - da).abs().max())
        rel = err / scale if scale else (0.0 if err == 0 else math.inf)
        if rel >= worst_update:
            worst_update, worst_key = rel, k
    return worst_state, worst_update, worst_key


def dp_step_trace(torch, pm, step, x, y):
    """A train step's wall ms and collectives, then one more step under the
    profiler: device ms by kernel family (NCCL, BatchNorm, concatenation
    and copies, the rest) and launches; None where the trace stays short."""
    pm.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(x, y, 0.01)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    collectives = dict(pm.COLLECTIVES)
    trace = per_kernel_ms(lambda: step(x, y, 0.01), torch)
    if trace is None:
        return None
    fams = {"nccl": 0.0, "batch_norm": 0.0, "cat_copy": 0.0, "rest": 0.0}
    for name, (_, ms) in trace.items():
        low = name.lower()
        fam = ("nccl" if "nccl" in low else "batch_norm" if "batch_norm" in low
               else "cat_copy" if ("cat" in low or "copy" in low) else "rest")
        fams[fam] += ms
    return {"wall_ms": wall, "device_ms": sum(fams.values()),
            "launches": sum(n for n, _ in trace.values()),
            **{f"{k}_ms": v for k, v in fams.items()}, "collectives": collectives}


def _flagship_step(torch, mesh, loss_kind):
    """A freshly built flagship (weights from seed 0, replicated with a
    mesh), its train step with loss ``loss_kind`` and the model."""
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.ops.branchy import LovaszSoftmax
    from ee_semantic_segmentation_tpu_torch.ops.xentropy import BrXEntropyLoss
    from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm
    from ee_semantic_segmentation_tpu_torch.parallel.train_step import make_train_step
    from ee_semantic_segmentation_tpu_torch.train.optim import (
        branchy_lr_multipliers,
        make_optimizer,
    )

    torch.manual_seed(0)
    model = build_branchy_deeplabv3(depth=50, n=2, img_dim=512, count_branches=False)
    model = model.to(torch.device("cuda")).to(memory_format=torch.channels_last)
    if mesh is not None:
        pm.replicate(model, mesh)
    opt = make_optimizer(model, branchy_lr_multipliers(2, 0.01))
    loss = (BrXEntropyLoss(ignore_index=C, b_reduction="sum", n_exits=3, mesh=mesh)
            if loss_kind == "ce" else LovaszSoftmax(ignore=C, n_branches=2, mesh=mesh))
    return make_train_step(model, loss, opt, accum_steps=TRAIN_ACCUM, mesh=mesh), model


def dp_first_step(torch, mesh, x, y):
    """The first train step from the same weights on the same batch, cuDNN
    deterministic: in float64 with cross-entropy on the first
    ``DP_F64_ROWS`` rows, and in float32 (TF32 off) with cross-entropy and
    with the per-batch Lovász loss on the whole batch; each one process
    twice and data-parallel once.  Returns per run its losses, and the
    worst entry's state and update differences (:func:`_state_errors`) of
    the second one-process run and of the data-parallel run against the
    first one-process run."""
    out = {}
    tf32, det = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    try:
        for run, kind, dtype, rows in (("ce f64", "ce", torch.float64, DP_F64_ROWS),
                                       ("ce", "ce", torch.float32, len(x)),
                                       ("lovasz", "lovasz", torch.float32, len(x))):
            xs, ys = x[:rows].to(dtype), y[:rows]
            ref = None
            for mode in ("plain", "plain again", "data-parallel"):
                step, model = _flagship_step(torch, mesh if mode == "data-parallel" else None,
                                             kind)
                model.to(dtype)
                before = {k: v.detach().clone() for k, v in model.state_dict().items()}
                loss = float(step(xs, ys, 0.01))
                after = {k: v.detach().clone() for k, v in model.state_dict().items()}
                out[f"{run} loss {mode}"] = loss
                if ref is None:
                    ref = (before, after)
                else:
                    check(all(bool((ref[0][k] == before[k]).all()) for k in before),
                          f"{run} {mode}: the runs start from other weights")
                    out[f"{run} {mode}"] = _state_errors(*ref, before, after)
                del step, model, before, after
                torch.cuda.empty_cache()
            del ref
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = tf32, det
    return out


def dp_throughput(torch, mesh, ckpt):
    """Images/s of the flagship's train step (per-batch Lovász, batch 16)
    and of its kernel-head eval (eval_miou's evaluator, batch 12) over
    pre-loaded batches, the one-process path and the data-parallel one in
    turns (plain, data-parallel, plain, data-parallel), both in this
    process; every rank passes the global batch and runs its rows.  Also
    the first-step checks (:func:`dp_first_step`, :func:`dp_bn_check`) and
    one traced step of each path.  Returns (images/s, the first-step,
    BatchNorm and trace numbers)."""
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.batch_eval import (
        make_kernel_miou_step_fn,
        mIoU_evaluator_fused,
    )
    from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

    dev = mesh.device
    test_set = resolve_test_set("synthetic", 512)
    (batch,) = list(DataLoader(test_set, 16))
    x, y = (torch.from_numpy(batch[k]).to(dev) for k in ("image", "label"))
    first = dp_first_step(torch, mesh, x, y)
    bn = dp_bn_check(torch, mesh)
    ims, traces = {}, {}
    for mode in ("plain", "data-parallel") * 2:
        step, model = _flagship_step(torch, mesh if mode == "data-parallel" else None, "lovasz")
        step(x, y, 0.01)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            loss = step(x, y, 0.01)
        check(math.isfinite(float(loss)), f"{mode} train step loss {float(loss)}")
        ims.setdefault(f"train {mode}", []).append(16 * 4 / (time.perf_counter() - t0))
        if mode not in traces:
            traces[mode] = dp_step_trace(torch, pm, step, x, y)
        del model, step, loss
        torch.cuda.empty_cache()
    model = load_model(ckpt, dev)
    batches = list(DataLoader(test_set, 12))
    kstep = make_kernel_miou_step_fn(model, C)
    for mode in ("plain", "data-parallel") * 2:
        m = mesh if mode == "data-parallel" else None
        mIoU_evaluator_fused(model, 3, C, batches, step=kstep, mesh=m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mIoU_evaluator_fused(model, 3, C, batches, step=kstep, mesh=m)
        torch.cuda.synchronize()
        ims.setdefault(f"eval_miou kernel head {mode}", []).append(
            16 / (time.perf_counter() - t0))
    return ims, {"first_step": first, "batchnorm_fused_vs_plain": bn, "trace": traces}


def dp_worker(plan_path):
    """One rank of phase 4g (``torch.distributed.run``): every CLI run of
    the plan in this process, the throughput runs, and rank 0 writes the
    report beside the plan."""
    import torch

    sys.path.insert(0, str(ROOT))
    from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
    from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

    _build.build()
    _build.load_library()
    plan = json.loads(plan_path.read_text())
    os.chdir(plan["dir"])
    report = {"runs": {}}
    for name, (module, argv) in plan["runs"].items():
        wall, launches, coll = dp_run(torch, module, argv)
        report["runs"][name] = {"wall_s": wall, "launches": launches, "collectives": coll}
    mesh = pm.make_mesh()
    report["world"] = mesh.world
    report["images_per_s"], report["step"] = dp_throughput(torch, mesh, plan["ckpt"])
    if mesh.primary:
        (plan_path.parent / f"report_{plan_path.stem}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()
    return 0


def dp_launch(plan, tmp, nproc, timeout):
    """Run the plan under ``python -m torch.distributed.run`` with ``nproc``
    ranks (NCCL, one GPU each); returns rank 0's report."""
    path = pathlib.Path(tmp) / f"plan{nproc}.json"
    path.write_text(json.dumps(plan))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(ROOT / "chip_smoke.py"), "--dp-worker", str(path)]
    t0 = time.perf_counter()
    # a session of its own, so that a timeout stops the launcher and its ranks
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        stdout, stderr = proc.communicate()
    print(f"[dp] torch.distributed.run --nproc_per_node={nproc}: rc {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode:
        print(stdout[-6000:])
        print(stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f"the {nproc}-rank data-parallel run failed")
    return json.loads((path.parent / f"report_{path.stem}.json").read_text())


def check_first_step(rep, world):
    """Phase 4g's first-step checks on a run's report (the constants above
    phase 4g): the fused global BatchNorm within ``DP_BN_RTOL`` of its
    plain branch, each first step's loss within ``DP_STEP1_RTOL`` of one
    process, and the float64 step's state and update within
    ``DP_F64_RTOL``; returns the numbers."""
    first, bn = rep["step"]["first_step"], rep["step"]["batchnorm_fused_vs_plain"]
    print(f"[dp] {world}, global BatchNorm fused CUDA branch vs plain branch at {DP_BN_SHAPE}: "
          f"max|d| / max|plain| {json.dumps(bn)}")
    for run in ("ce f64", "ce", "lovasz"):
        a, b = first[f"{run} loss plain"], first[f"{run} loss data-parallel"]
        print(f"[dp] {world}, first {run} step from the same weights on the same rows (TF32 "
              f"off, cuDNN deterministic): loss one process {a!r} (again "
              f"{first[f'{run} loss plain again']!r}), data-parallel {b!r}; worst entry's "
              f"state max|d| / max|one process|, update max|d| / max|one-process update|: "
              f"one process again {first[f'{run} plain again']}, data-parallel "
              f"{first[f'{run} data-parallel']}")
    for k, v in bn.items():
        check(v <= DP_BN_RTOL, f"{world} global BatchNorm {k}: fused vs plain {v:.3g}")
    for run in ("ce f64", "ce", "lovasz"):
        a, b = first[f"{run} loss plain"], first[f"{run} loss data-parallel"]
        check(abs(a - b) <= DP_STEP1_RTOL * abs(a), f"{world} first {run} loss {b} vs {a}")
    state, update, entry = first["ce f64 data-parallel"]
    check(state <= DP_F64_RTOL and update <= DP_F64_RTOL,
          f"{world} first float64 step: state {state:.3g}, update {update:.3g} ({entry}) "
          f"> {DP_F64_RTOL}")
    return first


def data_parallel_path(U, S, Hk, torch, tau, one_loss, card):
    """Phase 4g.  The data-parallel path at world 1 over NCCL, launched by
    ``torch.distributed.run``, on a flagship checkpoint: ``eval_miou``,
    ``eval_br_ent`` and ``eval_br_sim`` with ``--pallas_head``,
    ``ee_dnn_op_ne --engine masked --pallas_head`` at phase 4c's split tau,
    and one epoch of ``main_bradeepv3`` sorted and ``-G 1024``; the same
    CLI runs in this process give the one-process rows.  Checks: the CSV
    rows equal the one-process rows; the first train step against one
    process and the global BatchNorm's fused branch against its plain one
    (:func:`check_first_step`, :func:`dp_bn_check`);
    each training run's epoch loss within the spread of two one-process
    runs, a smoke check (phase 4b's and one more here,
    ``DP_LOSS_SPREAD``, ``DP_LOSS_FLOOR``); each kernel launched as its
    path implies (the eval heads 3 exits x 2 batches, the masked engine's
    B and C as in the one-process run, 4 sorts and unsorts or 4 E and F
    calls a training epoch); every collective of each path issued.  Then
    the throughput of both paths, and with two or more GPUs the same runs
    at world 2 held to world 1.  Returns the numbers for the kernels line."""
    plan_runs = None
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for sub in ("one", "dp1", "dp2"):
            (tmp / sub).mkdir()
        ckpt = flagship_checkpoint(str(tmp / "dp1"), torch)
        plan = dp_plan(ckpt, tau, tmp / "dp1")
        plan_runs = plan["runs"]
        one = {}
        cwd = os.getcwd()
        os.chdir(tmp / "one")
        try:
            for name, (module, argv) in plan_runs.items():
                one[name] = dp_run(torch, module, argv)
        finally:
            os.chdir(cwd)
        torch.cuda.empty_cache()
        rep = dp_launch(plan, tmp, 1, 900)
        check(rep["world"] == 1, f"world {rep['world']}, want 1")
        for name, (wall, launches, coll) in one.items():
            got = rep["runs"][name]
            print(f"[dp] {name}: one process {wall:.2f} s, launches {launches}; world 1 "
                  f"{got['wall_s']:.2f} s, launches {got['launches']}, collectives "
                  f"{got['collectives']}")
            check(not coll, f"{name}: the one-process run issued collectives {coll}")
            want_coll = {"all_reduce"}
            if name.startswith("ee_dnn_op"):
                want_coll = {"all_gather"}
            elif name in DP_TRAIN_RUNS:
                want_coll = {"all_reduce", "all_gather", "broadcast", "barrier"}
            for kind in want_coll:
                check(got["collectives"].get(kind, 0) > 0, f"{name}: no {kind} issued")
            if name in DP_CSVS:
                check(got["launches"] == launches,
                      f"{name}: launches {got['launches']} at world 1, {launches} in one process")
                a = read_csv(tmp / "one" / DP_CSVS[name])
                b = read_csv(tmp / "dp1" / DP_CSVS[name])
                check(a == b and len(a) == 1, f"{name}: world-1 rows {b} != one-process rows {a}")
        for name, kernel in (("eval_miou", U.upsample_argmax_confusion),
                             ("eval_br_ent", U.upsample_entropy_argmax),
                             ("eval_br_sim", U.upsample_argmax)):
            n = rep["runs"][name]["launches"][kernel.__name__]
            check(n == 3 * 2, f"{name}: {kernel.__name__} launched {n} times, want 3 x 2")
        masked = rep["runs"]["ee_dnn_op_ne masked"]["launches"]
        check(masked[U.upsample_entropy_argmax.__name__] > 0, f"masked engine launches {masked}")
        for name in DP_TRAIN_RUNS:
            got = rep["runs"][name]["launches"]
            ks = S.KERNELS if name == "lovasz" else Hk.KERNELS
            for k in S.KERNELS + Hk.KERNELS:
                want = 4 * TRAIN_ACCUM if k in ks else 0
                check(got[k.__name__] == want,
                      f"{name} at world 1: {k.__name__} launched {got[k.__name__]}, want {want}")
            loss_a = one_loss[name]
            loss_b = float(read_csv(tmp / "one" / "synthetic_results" / name
                                    / f"{name}_tr.csv")[0]["train_loss"])
            loss_dp = float(read_csv(tmp / "dp1" / "synthetic_results" / name
                                     / f"{name}_tr.csv")[0]["train_loss"])
            tol = max(DP_LOSS_SPREAD * abs(loss_a - loss_b), DP_LOSS_FLOOR * abs(loss_a))
            print(f"[dp] {name}: epoch loss one process {loss_a!r} and {loss_b!r}, world 1 "
                  f"{loss_dp!r} (|d| {abs(loss_dp - loss_a):.3g}, allowed {tol:.3g})")
            check(abs(loss_dp - loss_a) <= tol, f"{name}: world-1 epoch loss {loss_dp} vs {loss_a}")
            out[f"{name} epoch loss"] = {"one_process": [loss_a, loss_b], "world_1": loss_dp}
        first = check_first_step(rep, "world 1")
        out["first_step"] = first
        out["batchnorm_fused_vs_plain"] = rep["step"]["batchnorm_fused_vs_plain"]
        out["trace"] = rep["step"]["trace"]
        for mode, t in out["trace"].items():
            print(f"[dp-profile] one train step (per-batch Lovász, batch 16, 512x512), {mode}: "
                  + ("not measured" if t is None else json.dumps(t)) + f" ({card})")
        for key, vals in rep["images_per_s"].items():
            print(f"[dp-throughput] {key}: {[round(v, 2) for v in vals]} images/s at 512x512 "
                  f"({card})")
        out["world_1_images_per_s"] = rep["images_per_s"]
        out["world_1_launches"] = {n: r["launches"] for n, r in rep["runs"].items()}
        out["world_1_collectives"] = {n: r["collectives"] for n, r in rep["runs"].items()}

        if torch.cuda.device_count() < 2:
            print(f"[dp] one GPU ({torch.cuda.device_count()}): the 2-rank case was not run")
            out["world_2"] = None
            return out
        plan2 = dict(plan, dir=str(tmp / "dp2"))
        rep2 = dp_launch(plan2, tmp, 2, 900)
        check(rep2["world"] == 2, f"world {rep2['world']}, want 2")
        for name in DP_CSVS:
            a = read_csv(tmp / "dp1" / DP_CSVS[name])
            b = read_csv(tmp / "dp2" / DP_CSVS[name])
            check(a == b, f"{name}: world-2 rows {b} != world-1 rows {a}")
        for name in DP_TRAIN_RUNS:
            loss_a = out[f"{name} epoch loss"]["one_process"]
            loss_2 = float(read_csv(tmp / "dp2" / "synthetic_results" / name
                                    / f"{name}_tr.csv")[0]["train_loss"])
            tol = max(DP_LOSS_SPREAD * abs(loss_a[0] - loss_a[1]), DP_LOSS_FLOOR * abs(loss_a[0]))
            print(f"[dp] {name}: world 2 epoch loss {loss_2!r}")
            check(abs(loss_2 - loss_a[0]) <= tol, f"{name}: world-2 epoch loss {loss_2}")
        first2 = check_first_step(rep2, "world 2")
        for run in ("ce f64", "ce", "lovasz"):
            a, b = first[f"{run} loss plain"], first2[f"{run} loss data-parallel"]
            check(abs(a - b) <= DP_STEP1_RTOL * abs(a), f"world-2 first {run} loss {b} vs {a}")
        for key, vals in rep2["images_per_s"].items():
            print(f"[dp-throughput] world 2 {key}: {[round(v, 2) for v in vals]} images/s")
        out["world_2"] = {"images_per_s": rep2["images_per_s"],
                          "collectives": {n: r["collectives"] for n, r in rep2["runs"].items()}}
    return out


KERNEL_INFO = (
    ("A", "upsample_argmax_confusion", "ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:441"),
    ("B", "upsample_entropy_argmax", "ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:284"),
    ("C", "upsample_argmax", "ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:131"),
)
HIST_INFO = (
    ("E", "hist2d_weighted", "ee_semantic_segmentation_tpu/ops/pallas/hist_kernel.py:135"),
    ("F", "table_lookup", "ee_semantic_segmentation_tpu/ops/pallas/hist_kernel.py:175"),
)


def main() -> int:
    if sys.argv[1:2] == ["--dp-worker"]:  # a rank of phase 4g, started by torch.distributed.run
        return dp_worker(pathlib.Path(sys.argv[2]))
    # ---------------------------------------------------------------- phase 1
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke: {PKG}/ not found beside {__file__}; run from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
    from ee_semantic_segmentation_tpu_torch.ops.kernels import hist as Hk
    from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as S
    from ee_semantic_segmentation_tpu_torch.ops.kernels import upsample_argmax as U

    nvcc = _build.find_nvcc()
    nvcc_version = run([nvcc, "--version"]).splitlines()[-1] if nvcc else "nvcc not found"
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {nvcc_version}, {torch.cuda.get_device_name(0)}")
    print(card.splitlines()[0])
    global SFU_OPS_PER_S
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    SFU_OPS_PER_S = SFU_PER_CLOCK * mhz * 1e6
    print(f"[env] max SM clock {mhz:g} MHz: {SFU_OPS_PER_S:.4g} exp/log a second on the SFUs")

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")
    log = so.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # ---------------------------------------------------------------- phase 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    measured = kernel_vs_plain(U, torch)

    # --------------------------------------------------------------- phase 3b
    sort_measured = sort_vs_plain(S, torch)
    lovasz_kernel_vs_plain(S, torch)

    # --------------------------------------------------------------- phase 3c
    hist_measured = hist_vs_plain(Hk, torch)
    hist_lovasz_kernel_vs_plain(Hk, torch)
    # the main paths run with PyTorch's defaults, as a user's CLI call does
    torch.backends.cudnn.allow_tf32 = True

    # ------------------------------------------------------------ phases 4, 4c
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = flagship_checkpoint(tmp, torch)
        launches, ips, eval_in_step = main_path(U, torch, tmp, ckpt)
        ee_launches, ee_ips, ee_in_batch, tau_split = ee_path(U, torch, ckpt)
        # --------------------------------------------------------- phases 4e, 4f
        serving_ips, serving_stats = serving_path(torch, ckpt, tau_split)
        export_launches, export_ips = export_path(U, torch, ckpt, tau_split)

    # --------------------------------------------------------------- phase 4d
    mnv3_launches, mnv3_ips = mobilenet_path(U, S, torch)

    # --------------------------------------------------------------- phase 4b
    train_launches, epoch_loss = training_path(S, Hk, U.KERNELS + S.KERNELS + Hk.KERNELS, torch)
    launches.update(train_launches)
    train_ips, kernel_share, in_step = training_throughput(torch)

    # --------------------------------------------------------------- phase 4g
    dp = data_parallel_path(U, S, Hk, torch, tau_split, epoch_loss, card.splitlines()[0])

    # ---------------------------------------------------------------- phase 5
    print(f"[profiler] {PROFILER_GUARDS} guard kernels a session: {json.dumps(profiler_tally)}")
    kernels = []
    for key, name, replaces in KERNEL_INFO:
        m = measured[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/ops/kernels/csrc/upsample_heads.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "kernel_ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "in_step_ms": eval_in_step[key],
            **({"ms_trained_law": m["ms_trained"]} if "ms_trained" in m else {}),
            **({"masked_path_launches": ee_launches[name],
                "masked_in_batch_ms": {label: v[key] for label, v in ee_in_batch.items()},
                "exported_engine_launches": export_launches["exported " + name]}
               if name in ee_launches else {}),
        })
    for key, name, replaces in KERNEL_INFO:
        m = measured[key, MNV3_SHAPE]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/ops/kernels/csrc/upsample_heads.cu",
            "replaces": replaces, "launches": mnv3_launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "kernel_ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": MNV3_SHAPE,
            "path": "eval_mIoU / eval_br_ent / eval_br_sim --pallas_head, 2-exit MobileNetV3",
        })
    for name, by_shape in sort_measured.items():
        m = by_shape[SORT_MAIN_SHAPE]  # the -P row shape, beside the default's
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/ops/kernels/csrc/sort_rows.cu",
            "replaces": "ee_semantic_segmentation_tpu/ops/pallas/sort_kernel.py:293",
            "launches": launches[name], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "kernel_ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": SORT_MAIN_SHAPE,
            "per_image_shape": {k: v for k, v in by_shape[SORT_PER_IMAGE_SHAPE].items()
                                if k.endswith("ms")},
            "in_step_ms": {loss: in_step[loss][name] for loss in ("lovasz", "lovasz_per_image")},
            **({"role": "kernel D's backward call, in place of the JAX package's second sort "
                        "(ee_semantic_segmentation_tpu/ops/lovasz.py:168)"}
               if name == S.unsort_rows.__name__ else {}),
        })
    for key, name, replaces in HIST_INFO:
        m = hist_measured[key, SORT_MAIN_SHAPE]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/ops/kernels/csrc/hist_lovasz.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "kernel_ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": f"{SORT_MAIN_SHAPE}, {HIST_BINS} bins",
            "per_image_shape": {k: v for k, v in hist_measured[key, SORT_PER_IMAGE_SHAPE].items()
                                if k.endswith("ms")},
            "ms_by_error_law": {f"{shape}, {law}": hist_measured[key, f"{shape}, {law}"]["ms"]
                                for law in LOVASZ_LAWS
                                for shape in (SORT_MAIN_SHAPE, SORT_PER_IMAGE_SHAPE)},
            "in_step_ms": {loss: in_step[loss][name]
                           for loss in ("hist_lovasz", "hist_lovasz_per_image",
                                        f"hist_lovasz_{HIST_WIDE_BINS[0]}")},
            "ms_above_range": {f"{b} bins, {law or 'uniform'}":
                               hist_measured[key, f"{SORT_MAIN_SHAPE}, {law or 'uniform'}, {b} bins"]["ms"]
                               for b in HIST_WIDE_BINS for law in (None, *LOVASZ_LAWS)},
            **{f"{b}_bins": {k: v for k, v in
                             hist_measured[key, f"{SORT_MAIN_SHAPE}, uniform, {b} bins"].items()
                             if k.endswith("ms")}
               for b in HIST_WIDE_BINS},
        })
    print(json.dumps({"kernels": kernels, "card": card.splitlines()[0], "eval_images_per_s": ips,
                      "ee_images_per_s": ee_ips, "ee_masked_batch_profile": ee_in_batch,
                      "mnv3_images_per_s": mnv3_ips, "serving_images_per_s": serving_ips,
                      "serving_stats": serving_stats, "export_images_per_s": export_ips,
                      "train_images_per_s": train_ips,
                      "loss_kernel_share_of_train_step": kernel_share,
                      "data_parallel": dp}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
