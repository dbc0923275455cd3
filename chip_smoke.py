#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ee_semantic_segmentation_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. environment: torch/CUDA/nvcc versions and the card's name and power limit;
2. build: compile the CUDA kernels from ``csrc/`` with nvcc;
3. kernel vs plain version on the card (TF32 off), at the flagship eval
   shape (N=16, 64x64 -> 512x512, C=21) and a ragged one: argmax maps of
   kernels B and C, confusion counts and entropies must agree; kernel,
   plain and library times are medians of 20 runs timed with CUDA events;
3b. the sort kernel D vs its plain version (TF32 off) at the flagship's
   Lovász row shapes (63 rows of 2^22, 1008 of 2^18), one and two tiles,
   1024, a ragged row, heavy ties and permutation keys with a float32
   payload (the backward's case, also at 63 rows of 2^22): sorted keys must equal torch.sort's and the (key, payload)
   pairs must agree under lexicographic order; kernel, plain, library and
   bound times at both flagship shapes, and one call split per CUDA kernel
   with ``torch.profiler``; then the multi-exit Lovász loss and
   its gradient with the kernel vs with the plain sort on flagship-shaped
   logits (3, 16, 512, 512, 21);
3c. the histogram kernels E and F vs their plain versions (TF32 off) at the
   flagship's ``-G 1024`` row shapes (63 rows of 2^22, 1008 of 2^18), a
   ragged row with 128 and with the largest supported bins, an all-void
   and an all-tied row: E's counts must equal the plain version's exactly,
   its error sums agree within TOL_HIST_SUM_RTOL, F's output must equal
   the plain version's bit for bit; kernel, plain, library and bound times
   at both flagship shapes; then the ``-G 1024`` multi-exit Lovász value
   and gradient with the kernels vs with the plain versions on
   flagship-shaped logits (3, 16, 512, 512, 21);
4. eval main path: the flagship branchy DeepLabV3-ResNet50 at 512² with
   seeded random weights, saved as a checkpoint and evaluated through the
   CLIs ``eval_miou``, ``eval_br_ent`` and ``eval_br_sim`` (ssim and nmi)
   with the kernel head (launch counts checked) and with the plain head
   (results must agree), and once through ``eval_br_images``; the entropy
   and similarity gates also at a tau that splits the images; then the
   eval throughput of the evaluators over the same pre-loaded batches;
4b. training main path: the flagship trained through the CLIs
   ``main_bradeepv3`` (per-batch and per-image ``-P`` Lovász, and the
   histogram Lovász ``-G 1024``) and ``main_bradeepv3_ce`` for one epoch of
   the synthetic set (4 steps of batch 16 at 512²): kernel launches counted
   (2 sorts per step for the sorted Lovász, one E and one F per step and
   no sort for ``-G``, none for CE), finite losses, the JAX package's CSV
   layouts, and each checkpoint evaluated by ``eval_miou``; then training
   images/s over pre-loaded batches and the share of a step spent in the
   loss's kernels;
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
C = 21
TOL_MAP_AGREE = 0.99999    # share of argmax pixels that must agree
TOL_ENT_RTOL = 1e-4        # entropy: float association and expf vs softmax+log
TOL_MIOU_ABS = 1e-4        # kernel head vs plain head, per-exit mIoU
TOL_LOVASZ_RTOL = 1e-5     # Lovász value, kernel sort vs plain sort: the same
#                            pairs in another order within exact ties, and
#                            another float association of the row sums
TOL_HIST_SUM_RTOL = 1e-4   # E's error sums vs the plain version's: both
#                            are float32 atomic sums in varying order; the
#                            plain version adds each bucket's ~4k terms one
#                            by one (worst-case drift n * 2^-24 ~ 2.4e-4,
#                            expected sqrt(n) * 2^-24 ~ 4e-6), the kernel in
#                            two levels of ~64 terms
TOL_HIST_LOVASZ_RTOL = 1e-5  # -G loss, kernels vs plain versions: the same
#                              tables (exact counts), error sums as above
TOL_LOVASZ_GRAD_REL = 0.05  # Lovász gradient, kernel sort vs plain sort:
#                             max|d| <= 0.05 max|grad| and |d| <= 0.05 |grad|
#                             (norms over all logits).  f32 logits tie often
#                             at 2^22 pixels a row, and a tie's two pixels
#                             may trade adjacent Lovász weights, one weight
#                             step (~1/P) each; a wrong pairing would move a
#                             whole weight.  At this shape max|grad| is
#                             ~3e-7, so this is far inside 1e-6 absolute.
TRAIN_ACCUM = 1            # --accum_steps of the training runs at batch 16
# kernel D's row shapes on the flagship's training path (512², batch 16,
# 3 exits x 21 classes): per-batch Lovász (the default) and per-image (-P)
SORT_MAIN_SHAPE = "flagship per-batch 63x2^22"
SORT_PER_IMAGE_SHAPE = "flagship per-image 1008x2^18"
HIST_BINS = 1024  # -G of the training runs


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


def bound(nbytes, ops):
    """(least ms, what bounds it): max(bytes / HBM rate, ops / f32 rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bounds_ms(N, h, w, H, W, count, esize):
    """Least time the card could take for each upsample kernel's work at
    these inputs: max(bytes / HBM rate, operations / f32 rate).

    Bytes: each input read once, each output written once.  Operations
    (float32, one per add, multiply, compare, exp or log; an FMA is two) of
    the separable upsample: each row-interpolated value (H*w*C per image)
    and each output value (H*W*C) takes one multiply and one FMA (3), then
    one compare per output value for the argmax.  B adds per output value
    a subtract, an exp, an add and an FMA (5) and per pixel a log, a divide
    and a subtract (3).  Kernel A only touches the ``count`` valid rows; C
    is B without the entropy."""
    up = H * w * C * 3 + H * W * C * 3 + H * W * C
    maps_bytes = N * (h * w * C * esize + H * W * 4) + (H + W) * 16
    return {
        "A": bound(count * (h * w * C * esize + H * W * 4) + 3 * C * 4 + (H + W) * 16,
                   count * up),
        "B": bound(maps_bytes + N * 4, N * (up + H * W * C * 5 + H * W * 3)),
        "C": bound(maps_bytes, N * up),
    }


def kernel_vs_plain(U, torch):
    """Phase 3.  Returns per-kernel measurements at the flagship shape."""
    import numpy as np
    import torch.nn.functional as Fn

    results = {}
    cases = [("flagship", (16, 64, 64), (512, 512), 16), ("ragged", (3, 9, 13), (67, 101), 2)]
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
        check(conf_l1 <= 3 * n_differ_valid,
              f"{tag}: confusion counts differ by {conf_l1} > 3 x {n_differ_valid} flipped pixels")
        check(ent_rel <= TOL_ENT_RTOL, f"{tag}: entropy rel err {ent_rel:.3g} > {TOL_ENT_RTOL}")
        if tag != "flagship":
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
            results[key] = dict(ms=median_ms(fn), plain_ms=median_ms(plain), library_ms=lib_ms,
                                bound_ms=bounds[key][0], bound_by=bounds[key][1],
                                max_abs_err=err)
            print(f"[kernel-vs-plain] {key} at {tag}: kernel {results[key]['ms']:.4f} ms, "
                  f"plain {results[key]['plain_ms']:.4f} ms, library (interpolate+argmax) "
                  f"{lib_ms:.4f} ms, bound {bounds[key][0]:.4f} ms ({bounds[key][1]})")
    return results


def lexsorted(key, pay, torch):
    """(B, P) pairs in lexicographic (key, payload) order per row, on the
    device: a stable sort by payload bits, then a stable sort by key."""
    bits = pay.view(torch.int32) if pay.dtype == torch.float32 else pay
    _, order = torch.sort(bits, dim=-1, stable=True)
    key, pay = torch.gather(key, -1, order), torch.gather(pay, -1, order)
    key, order = torch.sort(key, dim=-1, stable=True)
    return key, torch.gather(pay, -1, order)


def per_kernel_ms(fn, torch):
    """One call of ``fn`` under ``torch.profiler``: {CUDA kernel: [launches,
    device ms]}."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {re.sub(r"^(void )?\(anonymous namespace\)::", "", e.key).split("(")[0]:
            [e.count, round(e.device_time_total / 1e3, 3)]
            for e in prof.key_averages() if e.device_time_total > 0}


def sort_vs_plain(S, torch):
    """Phase 3b.  Kernel D against ``sort_rows_plain`` at every case;
    returns D's measurements at the two flagship Lovász row shapes, with
    one call split per CUDA kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    arange_pay = lambda B, P: torch.arange(B * P, dtype=torch.int32, device="cuda").view(B, P)
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
        "ragged 8x(2*67*101)": lambda: (torch.randn(8, 2 * 67 * 101, device="cuda", generator=g),
                                        arange_pay(8, 2 * 67 * 101)),
        "16-valued ties 8x2^20": lambda: (
            torch.randint(0, 16, (8, 1 << 20), device="cuda", generator=g).float() - 7.5,
            arange_pay(8, 1 << 20)),
        "permutation keys, f32 payload 16x2^18": lambda: (
            torch.argsort(torch.rand(16, 1 << 18, device="cuda", generator=g), dim=-1).int(),
            torch.randn(16, 1 << 18, device="cuda", generator=g)),
        # the backward's unsort at the flagship's per-batch rows
        "permutation keys, f32 payload 63x2^22": lambda: (
            torch.argsort(torch.rand(63, 1 << 22, device="cuda", generator=g), dim=-1).int(),
            torch.randn(63, 1 << 22, device="cuda", generator=g)),
    }
    results = {}
    for tag, make in cases.items():
        key, pay = make()
        ks, ps = S.sort_rows(key, pay)
        torch.cuda.synchronize()
        kp, pp = S.sort_rows_plain(key, pay)
        keys_equal = bool(torch.equal(ks, kp))
        key_err = float((ks.double() - kp.double()).abs().max())
        lk, lp = lexsorted(ks, ps, torch)
        wk, wp = lexsorted(kp, pp, torch)
        pairs_equal = bool(torch.equal(lk, wk) and torch.equal(lp, wp))
        print(f"[sort-vs-plain] {tag}: keys equal {keys_equal}, (key, payload) pairs equal "
              f"under lexsort {pairs_equal}")
        check(keys_equal, f"sort {tag}: sorted keys differ from torch.sort's")
        check(pairs_equal, f"sort {tag}: (key, payload) pairs differ from the plain version's")
        if tag.startswith("flagship"):
            B, P = key.shape
            nbytes = B * P * 16  # key and payload read once, both written once
            results[tag] = dict(
                ms=median_ms(lambda: S.sort_rows(key, pay)),
                plain_ms=median_ms(lambda: S.sort_rows_plain(key, pay)),
                library_ms=median_ms(lambda: torch.gather(pay, -1, torch.sort(key, dim=-1)[1])),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", max_abs_err=key_err)
            r = results[tag]
            print(f"[sort-vs-plain] D at {tag}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"library (torch.sort + gather) {r['library_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.4f} ms (bytes)")
            print(f"[sort-vs-plain] D at {tag}, one call per CUDA kernel [launches, ms]: "
                  f"{per_kernel_ms(lambda: S.sort_rows(key, pay), torch)}")
        del key, pay, ks, ps, kp, pp, lk, lp, wk, wp
        torch.cuda.empty_cache()
    return results


def lovasz_kernel_vs_plain(S, torch):
    """Phase 3b, end: the multi-exit Lovász value and gradient with kernel D
    against the same function with the plain sort, on flagship-shaped
    logits with 15% void labels, per-batch and per-image."""
    from ee_semantic_segmentation_tpu_torch.ops.lovasz import _lovasz_exits

    g = torch.Generator(device="cuda").manual_seed(1)
    logits = 3 * torch.randn(3, 16, 512, 512, C, device="cuda", generator=g)
    labels = torch.randint(0, C, (16, 512, 512), device="cuda", generator=g, dtype=torch.int32)
    labels[torch.rand(16, 512, 512, device="cuda", generator=g) < 0.15] = C  # void
    for per_image in (False, True):
        out = {}
        for name, sort in (("kernel", S.sort_rows), ("plain", S.sort_rows_plain)):
            x = logits.clone().requires_grad_(True)
            loss = _lovasz_exits(x, labels, per_image=per_image, ignore=C, sort=sort).sum()
            (grad,) = torch.autograd.grad(loss, x)
            out[name] = (loss.item(), grad)
        (lk, gk), (lp, gp) = out["kernel"], out["plain"]
        gerr = float((gk - gp).abs().max())
        grel = float((gk - gp).double().norm() / gp.double().norm())
        gmax = float(gp.abs().max())
        print(f"[lovasz] flagship logits (3, 16, 512, 512, {C}), per_image={per_image}: loss kernel "
              f"{lk!r} vs plain {lp!r} (rel {abs(lk - lp) / abs(lp):.3g}); grad max|d| {gerr:.3g} "
              f"(max|grad| {gmax:.3g}), |d|/|grad| {grel:.3g}")
        check(math.isfinite(lk) and abs(lk - lp) <= TOL_LOVASZ_RTOL * abs(lp),
              f"Lovász loss with the kernel {lk} vs the plain sort {lp}")
        check(gerr <= TOL_LOVASZ_GRAD_REL * gmax and grel <= TOL_LOVASZ_GRAD_REL,
              f"Lovász gradient differs by max {gerr:.3g} (max|grad| {gmax:.3g}), "
              f"|d|/|grad| {grel:.3g}; limit {TOL_LOVASZ_GRAD_REL} for both")
        del out, gk, gp
    del logits, labels
    torch.cuda.empty_cache()


def hist_rows(R, P, g, torch):
    """(R, P) Lovász-like errors in [0, 1.5) with 15 % of them void (-1e30),
    a bool foreground of ~30 % of the valid pixels, and the valid mask."""
    errors = 1.5 * torch.rand(R, P, device="cuda", generator=g)
    valid = torch.rand(R, P, device="cuda", generator=g) >= 0.15
    errors = torch.where(valid, errors, -1e30)
    fg = (torch.rand(R, P, device="cuda", generator=g) < 0.3) & valid
    return errors, fg, valid


def hist_vs_plain(Hk, torch):
    """Phase 3c.  Kernels E and F against their plain versions at every
    case; returns their measurements at the two flagship -G row shapes."""
    from ee_semantic_segmentation_tpu_torch.ops.lovasz import _hist_prepass, _hist_tables

    g = torch.Generator(device="cuda").manual_seed(2)
    P_ragged, max_bins = 2 * 67 * 101, Hk.max_kernel_bins()
    cases = {  # tag: (rows, P, bins)
        SORT_MAIN_SHAPE: (63, 1 << 22, HIST_BINS),
        SORT_PER_IMAGE_SHAPE: (1008, 1 << 18, HIST_BINS),
        "ragged 8x(2*67*101), 128 bins": (8, P_ragged, 128),
        f"ragged 8x(2*67*101), {max_bins} bins": (8, P_ragged, max_bins),
        "4x2^20 with an all-void and an all-tied row": (4, 1 << 20, HIST_BINS),
    }
    results = {}
    for tag, (R, P, bins) in cases.items():
        errors, fg, valid = hist_rows(R, P, g, torch)
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
        d_sum = (hk[:, 2:] - hp[:, 2:]).abs()
        sum_rel = float((d_sum / hp[:, 2:].abs().clamp_min(1e-30)).max())
        sum_err = float(d_sum.max())
        lookup_equal = bool(torch.equal(wk.view(torch.int32), wp.view(torch.int32)))
        print(f"[hist-vs-plain] {tag}: counts equal {counts_equal} (total {int(hk[:, 0].sum())}"
              f" of {R * P} pixels valid), error sums max|d| {sum_err:.3g} (rel {sum_rel:.3g}); "
              f"lookup equal bit for bit {lookup_equal}")
        check(counts_equal, f"hist {tag}: E's counts differ from the plain version's")
        check(bool(((hk[:, 2:] == hp[:, 2:]) | (d_sum <= TOL_HIST_SUM_RTOL * hp[:, 2:].abs())).all()),
              f"hist {tag}: E's error sums differ by rel {sum_rel:.3g} > {TOL_HIST_SUM_RTOL}")
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
                r = results[key, tag] = dict(
                    ms=median_ms(fn), plain_ms=median_ms(plain), library_ms=median_ms(lib),
                    bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
                print(f"[hist-vs-plain] {key} at {tag}, {bins} bins: kernel {r['ms']:.3f} ms, "
                      f"plain {r['plain_ms']:.3f} ms, library "
                      f"({'scatter_add_' if key == 'E' else 'gather'} over precomputed bucket "
                      f"ids) {r['library_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            del idx, fgv, idx4, src4, idx2, tab2
        del errors, fg, valid, hk, hp, wk, wp, tables
        torch.cuda.empty_cache()
    errors, fg, valid = hist_rows(2, 1000, g, torch)
    try:
        Hk.hist2d_weighted(errors, fg, *_hist_prepass(errors, valid, 2 * max_bins), bins=2 * max_bins)
    except ValueError as err:
        print(f"[hist-vs-plain] {2 * max_bins} bins raise: {err}")
    else:
        check(False, f"hist2d_weighted took {2 * max_bins} bins, above its limit {max_bins}")
    return results


def hist_lovasz_kernel_vs_plain(Hk, torch):
    """Phase 3c, end: the -G 1024 multi-exit Lovász value and gradient with
    kernels E and F against the same function with their plain versions,
    on flagship-shaped logits with 15 % void labels, per-batch and
    per-image.  The gradient depends on the exact counts only: equal."""
    from ee_semantic_segmentation_tpu_torch.ops.lovasz import _lovasz_exits

    g = torch.Generator(device="cuda").manual_seed(1)
    logits = 3 * torch.randn(3, 16, 512, 512, C, device="cuda", generator=g)
    labels = torch.randint(0, C, (16, 512, 512), device="cuda", generator=g, dtype=torch.int32)
    labels[torch.rand(16, 512, 512, device="cuda", generator=g) < 0.15] = C  # void
    for per_image in (False, True):
        out = {}
        for name, pair in (("kernel", Hk.KERNELS),
                           ("plain", (Hk.hist2d_weighted_plain, Hk.table_lookup_plain))):
            x = logits.clone().requires_grad_(True)
            loss = _lovasz_exits(x, labels, per_image=per_image, ignore=C, hist_bins=HIST_BINS,
                                 hist_kernels=pair).sum()
            (grad,) = torch.autograd.grad(loss, x)
            out[name] = (loss.item(), grad)
        (lk, gk), (lp, gp) = out["kernel"], out["plain"]
        print(f"[hist-lovasz] -G {HIST_BINS} on flagship logits (3, 16, 512, 512, {C}), "
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
    kernel's count set to 0 just before it; returns the sort's launches on
    the default (per-batch Lovász) run and E's and F's on the -G run."""
    from ee_semantic_segmentation_tpu_torch.cli import eval_miou, main_bradeepv3, main_bradeepv3_ce
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import load_config

    n_train, bs, steps = 64, 16, 4  # synthetic train split: 4 steps of batch 16
    base = ["-t", "resnet50", "-n", "2", "-D", "512", "-b", str(bs), "-e", "1", "-d", "synthetic",
            "-l", "0.01", "--accum_steps", str(TRAIN_ACCUM)]
    runs = (("lovasz", main_bradeepv3, []), ("lovasz_per_image", main_bradeepv3, ["-P"]),
            ("hist_lovasz", main_bradeepv3, ["-G", str(HIST_BINS)]),
            ("ce", main_bradeepv3_ce, []))
    launches = {}
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
                want = {S.sort_rows: 2 * steps * TRAIN_ACCUM if name.startswith("lovasz") else 0}
                for k in Hk.KERNELS:
                    want[k] = steps * TRAIN_ACCUM if name == "hist_lovasz" else 0
                for k, n in want.items():
                    check(k.launches == n, f"{name}: {k.__name__} launched {k.launches} times, "
                                           f"want {n}")
                if name == "lovasz":
                    launches[S.sort_rows.__name__] = S.sort_rows.launches
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
    return launches


def training_throughput(loss_kernel_ms, torch):
    """Phase 4b, end: train-step images/s of the flagship over pre-loaded
    batches (the first step warms up; 4 more timed with CUDA events), and
    the share of a step that the loss's kernels take (two sorts, or one E
    and one F), from their phase-3b/3c times at the step's row shape."""
    from ee_semantic_segmentation_tpu_torch.cli.common import resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.ops.branchy import LovaszSoftmax
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
        "ce": BrXEntropyLoss(ignore_index=C, b_reduction="sum", n_exits=3),
    }
    ips, share = {}, {}
    for name, loss_fn in losses.items():
        kernel_ms = loss_kernel_ms.get(name, 0.0)
        torch.manual_seed(0)
        model = build_branchy_deeplabv3(depth=50, n=2, img_dim=512, count_branches=False)
        model = model.cuda().to(memory_format=torch.channels_last)
        opt = make_optimizer(model, branchy_lr_multipliers(2, 0.01))
        step = make_train_step(model, loss_fn, opt, accum_steps=TRAIN_ACCUM)
        step(*batches[0], 0.01)  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        times = []
        for i in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(*batches[i % len(batches)], 0.01)
            end.record()
            torch.cuda.synchronize()
            check(math.isfinite(float(loss)), f"{name}: train-step loss {float(loss)}")
            times.append(start.elapsed_time(end))
        step_ms = statistics.mean(times)
        ips[f"train {name}"] = bs / (step_ms / 1e3)
        share[name] = kernel_ms / step_ms
        print(f"[train-throughput] {name}: step {step_ms:.1f} ms (steps {[round(t, 1) for t in times]}), "
              f"{ips[f'train {name}']:.2f} images/s at 512x512 batch {bs}; the loss's kernels "
              f"{kernel_ms:.2f} ms = {100 * share[name]:.1f} % of a step")
        del model, opt, step, loss
        torch.cuda.empty_cache()
    return ips, share


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


def main_path(U, torch):
    """Phase 4.  Returns each kernel's launches on its main-path run and the
    evaluators' images/s."""
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
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.ops.gating import batched_similarity
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    torch.manual_seed(0)
    model = build_branchy_deeplabv3(depth=50, n=2, img_dim=512, count_branches=False)
    cfg = model.config
    check(cfg.segment_ends == (12, 15), f"flagship segment_ends {cfg.segment_ends} != (12, 15)")
    n_img, bs, tau = 16, 12, 0.5  # synthetic test split: 16 images, 2nd batch count=4
    launches, rows, ips = {}, {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(tmp, "flagship", model, cfg)
        del model
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
    return launches, ips


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

    # ---------------------------------------------------------------- phase 4
    launches, ips = main_path(U, torch)

    # --------------------------------------------------------------- phase 4b
    launches.update(training_path(S, Hk, U.KERNELS + S.KERNELS + Hk.KERNELS, torch))
    loss_kernel_ms = {
        "lovasz": 2 * sort_measured[SORT_MAIN_SHAPE]["ms"],
        "lovasz_per_image": 2 * sort_measured[SORT_PER_IMAGE_SHAPE]["ms"],
        "hist_lovasz": sum(hist_measured[k, SORT_MAIN_SHAPE]["ms"] for k in "EF"),
        "hist_lovasz_per_image": sum(hist_measured[k, SORT_PER_IMAGE_SHAPE]["ms"] for k in "EF"),
    }
    train_ips, kernel_share = training_throughput(loss_kernel_ms, torch)

    # ---------------------------------------------------------------- phase 5
    kernels = []
    for key, name, replaces in KERNEL_INFO:
        m = measured[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/ops/kernels/csrc/upsample_heads.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "kernel_ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
    for tag, m in sort_measured.items():
        if tag != SORT_MAIN_SHAPE:  # the -P row shape, beside the default's
            continue
        kernels.append({
            "name": S.sort_rows.__name__, "route": "cuda",
            "source": f"{PKG}/ops/kernels/csrc/sort_rows.cu",
            "replaces": "ee_semantic_segmentation_tpu/ops/pallas/sort_kernel.py:293",
            "launches": launches[S.sort_rows.__name__], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "kernel_ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": tag,
            "per_image_shape": {k: v for k, v in sort_measured[SORT_PER_IMAGE_SHAPE].items()
                                if k.endswith("ms")},
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
        })
    print(json.dumps({"kernels": kernels, "card": card.splitlines()[0], "eval_images_per_s": ips,
                      "train_images_per_s": train_ips,
                      "loss_kernel_share_of_train_step": kernel_share}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
