#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ee_semantic_segmentation_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. environment: torch/CUDA/nvcc versions and the card's name and power limit;
2. build: compile the CUDA kernels from ``csrc/`` with nvcc;
3. kernel vs plain version on the card (TF32 off), at the flagship eval
   shape (N=16, 64x64 -> 512x512, C=21) and a ragged one: argmax maps,
   confusion counts and entropies must agree; kernel, plain and library
   times are medians of 20 runs timed with CUDA events;
3b. the sort kernel D vs its plain version (TF32 off) at the flagship's
   Lovász row shapes (63 rows of 2^22, 1008 of 2^18), one and two tiles,
   1024, a ragged row, heavy ties and permutation keys with a float32
   payload (the backward's case, also at 63 rows of 2^22): sorted keys must equal torch.sort's and the (key, payload)
   pairs must agree under lexicographic order; kernel, plain, library and
   bound times at both flagship shapes, and one call split per CUDA kernel
   with ``torch.profiler``; then the multi-exit Lovász loss and
   its gradient with the kernel vs with the plain sort on flagship-shaped
   logits (3, 16, 512, 512, 21);
4. eval main path: the flagship branchy DeepLabV3-ResNet50 at 512² with
   seeded random weights, saved as a checkpoint and evaluated through the
   CLIs ``eval_miou`` and ``eval_br_ent`` with the kernel head (launch
   counts checked) and with the plain head (results must agree), then the
   eval throughput of both evaluators over the same pre-loaded batches;
4b. training main path: the flagship trained through the CLIs
   ``main_bradeepv3`` (per-batch and per-image ``-P`` Lovász) and
   ``main_bradeepv3_ce`` for one epoch of the synthetic set (4 steps of
   batch 16 at 512²): sort launches counted (2 per step for Lovász, 0 for
   CE), finite losses, the JAX package's CSV layouts, and each checkpoint
   evaluated by ``eval_miou``; then training images/s over pre-loaded
   batches and the share of a step spent in the sort;
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


def bounds_ms(N, h, w, H, W, count, esize):
    """Least time the card could take for each kernel's work at these
    inputs: max(bytes / HBM rate, operations / f32 rate).

    Bytes: each input read once, each output written once.  Operations
    (float32, one per add, multiply, compare, exp or log; an FMA is two) of
    the separable upsample: each row-interpolated value (H*w*C per image)
    and each output value (H*W*C) takes one multiply and one FMA (3), then
    one compare per output value for the argmax.  B adds per output value
    a subtract, an exp, an add and an FMA (5) and per pixel a log, a divide
    and a subtract (3).  Kernel A only touches the ``count`` valid rows."""
    up = H * w * C * 3 + H * W * C * 3 + H * W * C
    a_bytes = count * (h * w * C * esize + H * W * 4) + 3 * C * 4 + (H + W) * 16
    a_ops = count * up
    b_bytes = N * (h * w * C * esize + H * W * 4 + 4) + (H + W) * 16
    b_ops = N * (up + H * W * C * 5 + H * W * 3)
    out = {}
    for name, nbytes, ops in (("A", a_bytes, a_ops), ("B", b_bytes, b_ops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


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
        torch.cuda.synchronize()

        differ = maps_k != maps_p
        agree = 1.0 - differ.float().mean().item()
        n_differ_valid = int(differ[:count].sum())
        conf_err = float((conf_k - conf_p).abs().max())
        conf_l1 = float((conf_k - conf_p).abs().sum())
        ent_err = float((ent_k - ent_p).abs().max())
        ent_rel = float(((ent_k - ent_p).abs() / ent_p.abs()).max())
        print(f"[kernel-vs-plain] {tag}: N={N} {h}x{w}->{H}x{W} C={C} count={count}: "
              f"argmax agree {agree:.7f}, differing pixels {int(differ.sum())}; "
              f"confusion sum|d| {conf_l1:g} (max {conf_err:g}); entropy max|d| {ent_err:.3g} "
              f"(rel {ent_rel:.3g})")
        check(agree >= TOL_MAP_AGREE, f"{tag}: argmax maps agree on {agree:.7f} < {TOL_MAP_AGREE}")
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


TR_SCHEMA = ["train_loss", "val_mIoU_b1_mIoU", "val_mIoU_b2_mIoU", "val_mIoU_mIoU", "lr"]


def training_path(S, kernels, torch):
    """Phase 4b.  Trains the flagship through the CLIs, each run with every
    kernel's count set to 0 just before it; returns the sort's launches on
    the default (per-batch Lovász) run."""
    from ee_semantic_segmentation_tpu_torch.cli import eval_miou, main_bradeepv3, main_bradeepv3_ce
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import load_config

    n_train, bs, steps = 64, 16, 4  # synthetic train split: 4 steps of batch 16
    base = ["-t", "resnet50", "-n", "2", "-D", "512", "-b", str(bs), "-e", "1", "-d", "synthetic",
            "-l", "0.01", "--accum_steps", str(TRAIN_ACCUM)]
    runs = (("lovasz", main_bradeepv3, []), ("lovasz_per_image", main_bradeepv3, ["-P"]),
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
                want = 2 * steps * TRAIN_ACCUM if name.startswith("lovasz") else 0
                check(S.sort_rows.launches == want,
                      f"{name}: sort_rows launched {S.sort_rows.launches} times, want {want}")
                if name == "lovasz":
                    launches[S.sort_rows.__name__] = S.sort_rows.launches
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


def training_throughput(S, sort_ms, torch):
    """Phase 4b, end: train-step images/s of the flagship over pre-loaded
    batches (the first step warms up; 4 more timed with CUDA events), and
    the share of a step that two sort calls take."""
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
        "lovasz": (LovaszSoftmax(ignore=C, n_branches=2), sort_ms[SORT_MAIN_SHAPE]),
        "lovasz_per_image": (LovaszSoftmax(ignore=C, n_branches=2, per_image=True),
                             sort_ms[SORT_PER_IMAGE_SHAPE]),
        "ce": (BrXEntropyLoss(ignore_index=C, b_reduction="sum", n_exits=3), 0.0),
    }
    ips, share = {}, {}
    for name, (loss_fn, one_sort_ms) in losses.items():
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
        share[name] = 2 * one_sort_ms / step_ms
        print(f"[train-throughput] {name}: step {step_ms:.1f} ms (steps {[round(t, 1) for t in times]}), "
              f"{ips[f'train {name}']:.2f} images/s at 512x512 batch {bs}; two sorts "
              f"{2 * one_sort_ms:.1f} ms = {100 * share[name]:.1f} % of a step")
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


def main_path(U, torch):
    """Phase 4.  Returns each kernel's launches on its main-path run and the
    evaluators' images/s."""
    from ee_semantic_segmentation_tpu_torch.cli import eval_br_ent, eval_miou
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.batch_eval import (
        br_evaluator_entropy_fused,
        make_kernel_miou_step_fn,
        mIoU_evaluator_fused,
    )
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
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
            ):
                for head in ("kernel", "plain"):
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
            for col, a in split_k.items():
                b = split_p[col]
                check(a == b if isinstance(a, (int, str)) else
                      (math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL_MIOU_ABS,
                      f"tau split {col}: kernel head {a} vs plain head {b}")
        finally:
            os.chdir(cwd)

    for key, schema in (("miou", MIOU_SCHEMA), ("ent", ENT_SCHEMA)):
        for head in ("kernel", "plain"):
            check(list(rows[key, head][0]) == schema,
                  f"{key} {head} CSV schema {list(rows[key, head][0])} != {schema}")
    for col in ("b1_mIoU", "b2_mIoU", "mIoU"):
        a, b = as_float(rows["miou", "kernel"][0][col]), as_float(rows["miou", "plain"][0][col])
        print(f"[main-path] eval_miou {col}: kernel head {a!r}, plain head {b!r}")
        check((math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL_MIOU_ABS,
              f"eval_miou {col}: kernel head {a} vs plain head {b}")
    gk, gp = rows["ent", "kernel"][0], rows["ent", "plain"][0]
    print(f"[main-path] eval_br_ent kernel head row {dict(gk)}")
    print(f"[main-path] eval_br_ent plain head row  {dict(gp)}")
    for g in (gk, gp):
        exits = int(g["b1_count"]) + int(g["b2_count"]) + int(g["count_out"])
        check(exits == n_img and int(g["out_gl"]) == n_img,
              f"exit counts sum to {exits} (out_gl {g['out_gl']}), want {n_img}")
    for col in ("b1_count", "b2_count", "count_out", "out_gl"):
        check(gk[col] == gp[col], f"eval_br_ent {col}: kernel head {gk[col]} vs plain head {gp[col]}")
    for col in ("b1_mIoU", "b2_mIoU", "mIoU_out", "mIoU_gl"):
        a, b = as_float(gk[col]), as_float(gp[col])
        check((math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL_MIOU_ABS,
              f"eval_br_ent {col}: kernel head {a} vs plain head {b}")
    return launches, ips


KERNEL_INFO = (
    ("A", "upsample_argmax_confusion", "ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:441"),
    ("B", "upsample_entropy_argmax", "ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:284"),
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
    # the main paths run with PyTorch's defaults, as a user's CLI call does
    torch.backends.cudnn.allow_tf32 = True

    # ---------------------------------------------------------------- phase 4
    launches, ips = main_path(U, torch)

    # --------------------------------------------------------------- phase 4b
    launches.update(training_path(S, U.KERNELS + S.KERNELS, torch))
    train_ips, sort_share = training_throughput(
        S, {tag: m["ms"] for tag, m in sort_measured.items()}, torch)

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
    print(json.dumps({"kernels": kernels, "card": card.splitlines()[0], "eval_images_per_s": ips,
                      "train_images_per_s": train_ips, "sort_share_of_train_step": sort_share}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
