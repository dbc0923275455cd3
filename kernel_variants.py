#!/usr/bin/env python3
"""Time source variants of the unsort (kernel D's backward call) and of
kernel E against the shipped kernels, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 kernel_variants.py [--csrc DIR] [--only unsort|hist]

Each variant is ``csrc/<source>`` with a few text substitutions (a
constant changed, a step taken out), compiled by nvcc into a library of its
own under ``_build/variants/`` and called through the same C entry point as
the shipped kernel.  ``--csrc`` takes the sources from another tree (for
example an unpacked earlier commit); a variant whose text is not in those
sources is skipped.  Times are medians of 20 runs between CUDA events
(``chip_smoke.median_ms``) at the flagship's row shapes (63 x 2^22 and
1008 x 2^18) and, for E, 1024 bins on the three error laws of
``chip_smoke.py`` phase 3c.  A variant that takes a step out computes a
wrong result by design: only the shipped kernels' results are checked here
(against ``scatter_`` and the plain histogram), and ``chip_smoke.py``
checks them everywhere else.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent

FLAGSHIP_ROWS = ((63, 1 << 22), (1008, 1 << 18))
HIST_BINS = 1024

# name: (what it measures, source, [(text, replacement), ...])
VARIANTS = {
    "unsort one-pass scatter": ("sort_rows.cu", [
        ("constexpr int kUnsortMaxBuckets = 4096;", "constexpr int kUnsortMaxBuckets = 0;")]),
    "unsort W 2^12": ("sort_rows.cu", [
        ("constexpr int kUnsortLogW = 14;", "constexpr int kUnsortLogW = 12;")]),
    "unsort W 2^13": ("sort_rows.cu", [
        ("constexpr int kUnsortLogW = 14;", "constexpr int kUnsortLogW = 13;")]),
    "unsort W 2^15": ("sort_rows.cu", [
        ("constexpr int kUnsortLogW = 14;", "constexpr int kUnsortLogW = 15;")]),
    "unsort tile 2^13": ("sort_rows.cu", [
        ("constexpr int kPartItems = 32;", "constexpr int kPartItems = 16;")]),
    "unsort pass 2 on 256 threads": ("sort_rows.cu", [
        ("constexpr int kPlaceThreads = 512;", "constexpr int kPlaceThreads = 256;")]),
    # kernel E as shipped, with one device taken out
    "E without the 4-pixel runs": ("hist_lovasz.cu", [
        ("    if (key != r.key) {", "    if (true) {")]),
    "E with float sums only": ("hist_lovasz.cu", [
        ("const bool fixed = q >= kFixLo && q < kFixHi;", "const bool fixed = false;")]),
    "E loads and bucket ids only": ("hist_lovasz.cu", [
        ("    if (r.n) h.add(r.key, r.n, r.u, r.f);",
         "    if (r.n && r.key == -7 - bins) h.add(r.key, r.n, r.u, r.f);")]),
    # the histogram kernel with float sums in shared memory (an earlier
    # tree's csrc, given by --csrc), with one step taken out: its split
    "E, float-sum design, as it was": ("hist_lovasz.cu", [
        ("    atomicAdd(&s_n[b], 1);", "    atomicAdd(&s_n[b], 1);")]),
    "E, float-sum design, without the global flush": ("hist_lovasz.cu", [
        ("  __syncthreads();\n\n  int* c_row", "  __syncthreads();\n  if (P > 0) return;\n  int* c_row")]),
    "E, float-sum design, without float atomics": ("hist_lovasz.cu", [
        ("    atomicAdd(&s_S[b], e);\n", ""), ("      atomicAdd(&s_Sf[b], e);\n", "")]),
    "E, float-sum design, loads and bucket ids only": ("hist_lovasz.cu", [
        ("    atomicAdd(&s_n[b], 1);\n    atomicAdd(&s_S[b], e);\n    if (f_row[p]) {\n"
         "      atomicAdd(&s_f[b], 1);\n      atomicAdd(&s_Sf[b], e);\n    }\n",
         "    acc += b + (f_row[p] ? 1 : 0) + (e == 0.5f);\n"),
        ("  for (long long p = start + threadIdx.x; p < end; p += HIST_THREADS) {\n    const float e",
         "  int acc = 0;\n  for (long long p = start + threadIdx.x; p < end; p += HIST_THREADS) {\n"
         "    const float e"),
        ("  __syncthreads();\n\n  int* c_row", "  if (acc == -7) s_n[0] = acc;\n  __syncthreads();\n\n"
         "  int* c_row")]),
}


def build_variants(names, csrc, _build):
    """Compile each variant whose substitutions apply, in parallel; return
    {name: ctypes library}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for i, name in enumerate(names):
        src, subs = VARIANTS[name]
        text = (csrc / src).read_text()
        if not all(a in text for a, _ in subs):
            print(f"[variants] {name}: not in {csrc / src}, skipped")
            continue
        for a, b in subs:
            text = text.replace(a, b)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn_name, (args, res) in _build._SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = args, res
        libs[name] = lib
    return libs


def sass_atomics(so, _build):
    """{kernel: {SASS opcode: count}} of the atomic and reduction
    instructions in a built library (``cuobjdump -sass``): a shared float
    or 64-bit atomicAdd shows as a compare-and-swap loop, ATOMS.CAST.SPIN."""
    tool = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    fn, ops = None, {}
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "*/" in line and any(k in line for k in ("ATOM", "RED")):
            op = line.split("*/")[1].split()[0]
            ops.setdefault(fn, {}).setdefault(op, 0)
            ops[fn][op] += 1
    return ops


def unsort_with(lib, perm, vals, torch):
    B, P = perm.shape
    out = torch.empty_like(vals)
    scratch = torch.empty(lib.ee_unsort_scratch_words(B, P), dtype=torch.int32, device="cuda")
    err = lib.ee_unsort_rows(perm.data_ptr(), vals.data_ptr(), B, P, out.data_ptr(),
                             scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"unsort variant: CUDA error {err}")
    return out


def hist_with(lib, errors, fg, emax, inv_w, bins, torch):
    rows, P = errors.shape
    chunk = max(1 << 16, 64 * bins)
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "ee_hist_scratch_words"):
        out = torch.empty((rows, 4, bins), dtype=torch.float32, device="cuda")
        scratch = torch.empty(lib.ee_hist_scratch_words(rows, bins), dtype=torch.int32,
                              device="cuda")
    else:  # the float-sum design's interface: zeroed int32 counts and output
        out = torch.zeros((rows, 4, bins), dtype=torch.float32, device="cuda")
        scratch = torch.zeros((rows, 2, bins), dtype=torch.int32, device="cuda")
    err = lib.ee_hist2d_weighted(errors.data_ptr(), fg.data_ptr(), emax.data_ptr(),
                                 inv_w.data_ptr(), rows, P, bins, chunk, scratch.data_ptr(),
                                 out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"hist variant: CUDA error {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=pathlib.Path, default=None,
                    help="take the variants' sources from this csrc/ directory")
    ap.add_argument("--only", choices=("unsort", "hist"), default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
    from ee_semantic_segmentation_tpu_torch.ops.kernels import hist as Hk
    from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as S
    from ee_semantic_segmentation_tpu_torch.ops.lovasz import _hist_prepass

    card = CS.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card.splitlines()[0])
    csrc = args.csrc or _build.CSRC
    _build.load_library()
    names = [n for n in VARIANTS
             if args.only is None or n.startswith("unsort" if args.only == "unsort" else "E")]
    libs = build_variants(names, csrc, _build)
    for name, so in [("shipped", _build.build())] + [
            (n, _build.BUILD_DIR / "variants" / f"v{names.index(n)}.so") for n in libs
            if n.endswith("as it was")]:
        for fn, ops in sass_atomics(so, _build).items():
            if "hist_kernel" in fn or "unsort_partition" in fn:
                print(f"[variants] SASS atomics, {name}, {fn.split('_cu_')[-1][:60]}: {ops}")
    g = torch.Generator(device="cuda").manual_seed(0)
    CS.per_kernel_ms(lambda: torch.ones(1 << 20, device="cuda").sum(), torch)  # profiler warm-up

    if args.only in (None, "unsort"):
        for B, P in FLAGSHIP_ROWS:
            perm = torch.argsort(torch.rand(B, P, device="cuda", generator=g), dim=-1).int()
            vals = torch.randn(B, P, device="cuda", generator=g)
            idx = perm.long()
            ok = CS.bits_equal(S.unsort_rows(perm, vals), S.unsort_rows_plain(perm, vals), torch)
            CS.check(ok, f"unsort at {B}x{P} differs from scatter_")
            ms = {"shipped": CS.median_ms(lambda: S.unsort_rows(perm, vals))}
            for name, lib in libs.items():
                if name.startswith("unsort"):
                    ms[name] = CS.median_ms(lambda: unsort_with(lib, perm, vals, torch))
            ms["scatter_"] = CS.median_ms(lambda: torch.empty_like(vals).scatter_(-1, idx, vals))
            ms["shipped, again"] = CS.median_ms(lambda: S.unsort_rows(perm, vals))
            print(f"[variants] unsort {B}x{P} ms: {json.dumps(ms)}")
            for name, lib in (("shipped", None), *libs.items()):
                if name == "shipped" or name.startswith("unsort"):
                    fn = ((lambda: S.unsort_rows(perm, vals)) if lib is None
                          else (lambda: unsort_with(lib, perm, vals, torch)))
                    print(f"[variants] unsort {B}x{P} {name}, per CUDA kernel [launches, ms]: "
                          f"{CS.per_kernel_ms(fn, torch)}")
            del perm, vals, idx
            torch.cuda.empty_cache()

    if args.only in (None, "hist"):
        for R, P in FLAGSHIP_ROWS:
            for law in (None, *CS.LOVASZ_LAWS):
                errors, fg, valid = CS.hist_rows(R, P, g, torch, law)
                emax, inv_w = _hist_prepass(errors, valid, HIST_BINS)
                hk = Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=HIST_BINS)
                hp = Hk.hist2d_weighted_plain(errors, fg, emax, inv_w, bins=HIST_BINS)
                s64 = CS.hist_sums_f64(errors, fg, emax, inv_w, HIST_BINS, torch)
                rel = CS.max_rel(hk[:, 2:], s64, torch)
                CS.check(bool(torch.equal(hk[:, :2], hp[:, :2])), f"E's counts at {R}x{P} {law}")
                CS.check(rel <= CS.TOL_HIST_SUM_RTOL, f"E's sums at {R}x{P} {law}: rel {rel:.3g}")
                rel = f"{rel:.3g} (the plain version's {CS.max_rel(hp[:, 2:], s64, torch):.3g})"
                ms = {"shipped": CS.median_ms(
                    lambda: Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=HIST_BINS))}
                for name, lib in libs.items():
                    if name.startswith("E"):
                        ms[name] = CS.median_ms(
                            lambda: hist_with(lib, errors, fg, emax, inv_w, HIST_BINS, torch))
                print(f"[variants] E {R}x{P} {law or 'uniform'}: sums rel to float64 {rel}; ms "
                      f"{json.dumps(ms)}")
                print(f"[variants] E {R}x{P} {law or 'uniform'} shipped, per CUDA kernel: "
                      f"{CS.per_kernel_ms(lambda: Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=HIST_BINS), torch)}")
                del errors, fg, valid, hk, hp, s64
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
