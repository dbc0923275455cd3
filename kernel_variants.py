#!/usr/bin/env python3
"""Time source variants of the shipped CUDA kernels (the unsort, kernel
D's backward call, and kernels E, F, B, A and C) against them, on one
NVIDIA GPU.

Run from the root of a checkout:

    python3 kernel_variants.py [--csrc DIR] [--only unsort|hist|lookup|ent|conf|argmax]

Each variant is ``csrc/<source>`` with a few text substitutions (a
constant changed, a step taken out), compiled by nvcc into a library of its
own under ``_build/variants/`` and called through the same C entry point as
the shipped kernel.  Without ``--csrc`` the variants of the shipped sources
are built; ``--csrc`` takes the sources of another tree (for example an
unpacked earlier commit) and builds the variants of earlier designs
(``Variant.earlier``) whose text those sources hold, each design as it
was timed in turns with the shipped kernel.  Times are medians of 20 runs
between CUDA events (``chip_smoke.median_ms``) at the flagship's row
shapes (63 x 2^22 and 1008 x 2^18): E at 1024 bins on the three error laws
of ``chip_smoke.py`` phase 3c and at 16384 bins (E's bucket ranges) at
63 x 2^22; F at 1024, 16384 and 65536 bins on both shapes and the three
laws, beside ``gather``; B, A and C at the flagship's eval shape (N=16,
64x64 -> 512x512, C=21, float32; A and C also on a trained model's logits
and labels), where each variant's agreement with the plain version is
printed too.  With ``--csrc``, ``--only argmax`` also holds the earlier
tree's kernels A and B against the shipped ones: SASS, outputs and time.
A variant that takes a step out computes a wrong result by design: only
the shipped kernels' results are checked here (against ``scatter_``, the
plain histogram, lookup and heads), and ``chip_smoke.py`` checks them
everywhere else.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import itertools
import json
import math
import pathlib
import re
import subprocess
import sys
from typing import NamedTuple

ROOT = pathlib.Path(__file__).resolve().parent

FLAGSHIP_ROWS = ((63, 1 << 22), (1008, 1 << 18))
HIST_BINS = 1024
WIDE_BINS = 16384  # E's bucket ranges: its "E ranged" variants
LOOKUP_BINS = (16384, 65536)  # F's tile walk: its table staged, and read from L2

# kernel A's counting, as shipped (one shared atomicAdd a count), and the
# same counts with same-key counts merged first (A_MERGE_HELPERS)
A_COUNTS = """#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nx) {
        const int p = pred[j], t = truth[j];
        if (t == p) {
          atomicAdd(&hist[p], 1);                                // TP
        } else {
          atomicAdd(&hist[C + p], 1);                            // FP: truth is another class or void
          if (t >= 0 && t < C) atomicAdd(&hist[2 * C + t], 1);  // FN
        }
      }
"""
A_MERGE_HELPERS = """// The keys of a group's 4 pixels (< 0: none): one key with n = 4 where
// the 4 agree, else each key with n = 1.
__device__ __forceinline__ void count_keys(int* hist, const int (&k)[4]) {
  const bool same = k[0] == k[1] && k[1] == k[2] && k[2] == k[3];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = same ? (j == 0 ? k[0] : -1) : k[j];
    const int n = same ? 4 : 1;
    if (key >= 0) atomicAdd(&hist[key], n);
  }
}

"""
A_MERGED_COUNTS = """    int tp_fp[4] = {-1, -1, -1, -1}, fn[4] = {-1, -1, -1, -1};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nx) {
        const int p = pred[j], t = truth[j];
        tp_fp[j] = t == p ? p : C + p;
        if (t != p && t >= 0 && t < C) fn[j] = 2 * C + t;
      }
    count_keys(hist, tp_fp);
    count_keys(hist, fn);
"""

# kernel C's walk in groups of 8 output columns (lever (a)): at 8x the
# pixels of [8k + 4, 8k + 12) share their taps, so the groups start 4
# columns before the tile; the tile's first and last groups have 4 pixels
C_GROUPS_OF_8 = """// Kernel C's walk in groups of 8 output columns from x0 - 4.
__device__ __forceinline__ void label_band8(const float* t_s, const int2* col_idx,
                                            const float2* col_w, int C, int W, int y0, int x0,
                                            int rows, int cols, int lx0, int run,
                                            int* lab_img) {
  const int gw = (cols + 11) / 8;  // groups [x0 - 4 + 8 i, x0 + 4 + 8 i) a row
  for (int g = threadIdx.x; g < rows * gw; g += kEntThreads) {
    const int r = g / gw;
    const int xs = x0 - 4 + 8 * (g - r * gw);
    const int lo = max(xs, x0), nx = min(xs + 8, x0 + cols) - lo;
    const float* t_row = t_s + r * run;
    const int2 c0 = col_idx[lo], c7 = col_idx[lo + nx - 1];
    int lab[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (nx == 8 && c0.x == c7.x && c0.y == c7.y) {
      float w0[8], w1[8], m[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 cw = col_w[lo + j];
        w0[j] = cw.x;
        w1[j] = cw.y;
      }
      pixels_argmax<8>(t_row + (c0.x - lx0) * C, t_row + (c0.y - lx0) * C, w0, w1, C, m, lab);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < nx) {
          const int2 ci = col_idx[lo + j];
          const float2 cw = col_w[lo + j];
          float m;
          pixels_argmax<1>(t_row + (ci.x - lx0) * C, t_row + (ci.y - lx0) * C, &cw.x, &cw.y, C,
                           &m, &lab[j]);
        }
    }
    int* dst = lab_img + (size_t)(y0 + r) * W + lo;
    if (W % 4 == 0) {  // then lo and nx are multiples of 4
      *reinterpret_cast<int4*>(dst) = make_int4(lab[0], lab[1], lab[2], lab[3]);
      if (nx == 8) *reinterpret_cast<int4*>(dst + 4) = make_int4(lab[4], lab[5], lab[6], lab[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < nx) dst[j] = lab[j];
    }
  }
}

"""
# the same lever in aligned groups of 8 whose two halves share their taps
# and one low-res column (at 8x [8k, 8k + 4) take (k - 1, k) and [8k + 4,
# 8k + 8) take (k, k + 1)): 3 shared reads a class for 8 pixels, and 64
# groups a row, 256 a block of 4 rows: one group a thread
C_GROUPS_OF_8_3COL = """// 8 pixels whose halves share their taps: a, b for the first 4, b, c for the
// last 4 (pixels_argmax's arithmetic).
__device__ __forceinline__ void pixels_argmax_3col(const float* a, const float* b, const float* c,
                                                   const float* wc0, const float* wc1, int C,
                                                   int* best) {
  float m[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    m[p] = p < 4 ? wc0[p] * a[0] + wc1[p] * b[0] : wc0[p] * b[0] + wc1[p] * c[0];
    best[p] = 0;
  }
  for (int k = 1; k < C; ++k) {
    const float x = a[k], y = b[k], z = c[k];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const float v = p < 4 ? wc0[p] * x + wc1[p] * y : wc0[p] * y + wc1[p] * z;
      if (v > m[p]) {
        m[p] = v;
        best[p] = k;
      }
    }
  }
}

// Kernel C's walk in aligned groups of 8 output columns; a group whose
// halves do not chain walks as two groups of 4, as label_band does.
__device__ __forceinline__ void label_band8c(const float* t_s, const int2* col_idx,
                                             const float2* col_w, int C, int W, int y0, int x0,
                                             int rows, int cols, int lx0, int run,
                                             int* lab_img) {
  const int gw = (cols + 7) / 8;  // groups of 8 output columns a row
  for (int g = threadIdx.x; g < rows * gw; g += kEntThreads) {
    const int r = g / gw;
    const int xg = x0 + 8 * (g - r * gw);
    const int nx = min(8, x0 + cols - xg);  // pixels in the group
    const float* t_row = t_s + r * run;
    int lab[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    float w0[8], w1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 cw = col_w[xg + min(j, nx - 1)];
      w0[j] = cw.x;
      w1[j] = cw.y;
    }
    const int2 c0 = col_idx[xg], c3 = col_idx[xg + min(3, nx - 1)];
    const int2 c4 = col_idx[xg + min(4, nx - 1)], c7 = col_idx[xg + nx - 1];
    if (nx == 8 && c0.x == c3.x && c0.y == c3.y && c4.x == c7.x && c4.y == c7.y &&
        c0.y == c4.x) {
      pixels_argmax_3col(t_row + (c0.x - lx0) * C, t_row + (c0.y - lx0) * C,
                         t_row + (c4.y - lx0) * C, w0, w1, C, lab);
    } else {
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
        const int n4 = min(4, nx - h);
        const int2 d0 = col_idx[xg + min(h, nx - 1)], d3 = col_idx[xg + max(0, min(h + n4, nx) - 1)];
        if (n4 == 4 && d0.x == d3.x && d0.y == d3.y) {
          float m[4];
          pixels_argmax<4>(t_row + (d0.x - lx0) * C, t_row + (d0.y - lx0) * C, w0 + h, w1 + h, C,
                           m, lab + h);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < n4) {
              const int2 ci = col_idx[xg + h + j];
              float m;
              pixels_argmax<1>(t_row + (ci.x - lx0) * C, t_row + (ci.y - lx0) * C, &w0[h + j],
                               &w1[h + j], C, &m, &lab[h + j]);
            }
        }
      }
    }
    int* dst = lab_img + (size_t)(y0 + r) * W + xg;
    if (W % 4 == 0) {  // then xg and nx are multiples of 4
      *reinterpret_cast<int4*>(dst) = make_int4(lab[0], lab[1], lab[2], lab[3]);
      if (nx == 8) *reinterpret_cast<int4*>(dst + 4) = make_int4(lab[4], lab[5], lab[6], lab[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < nx) dst[j] = lab[j];
    }
  }
}

"""

# the C entries of an earlier tree whose signature has changed since:
# kernel F's per-chunk design took a chunk (pixels a block) after bins
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
EARLIER_SIGNATURES = {"ee_table_lookup": ([_P, _P, _P, _P, _P, _L, _L, _L, _L, _P, _P], _I)}

# the line of ee_table_lookup that makes kernel F's grid persistent
F_PERSISTENT = "  if (staged) {  // a persistent grid, as many blocks as fit the SMs at once"

class Variant(NamedTuple):
    """``source`` under csrc/ with the ``subs`` (text, replacement) pairs.
    ``earlier``: None for a variant of the shipped sources; else the variant
    is of an earlier tree's design (its csrc given by ``--csrc``) and this
    is a line that only that design holds.  An earlier variant with no
    ``subs`` is that design as it was, timed in turns with the shipped
    kernel."""
    source: str
    subs: tuple = ()
    earlier: str | None = None


# the lines that name an earlier tree's design: E's float sums in shared
# memory, F's block a chunk of a row, A's, B's and C's thread an output pixel
E_FLOAT_SUM = "    atomicAdd(&s_n[b], 1);"
F_PER_CHUNK = "      o_row[p] = __ldg(&t_row[f_row[p] ? b : bins + b]) * valid;"
A_PER_PIXEL = "    const int lab = labels[(size_t)n * HW + p];"
B_PER_PIXEL = "        if (k < C) v[k] = taps.value(k);"
C_PER_PIXEL = "  labels_out[(size_t)n * HW + p] = taps_argmax(taps, C);"

VARIANTS = {
    "unsort one-pass scatter": Variant("sort_rows.cu", [
        ("constexpr int kUnsortMaxBuckets = 4096;", "constexpr int kUnsortMaxBuckets = 0;")]),
    "unsort W 2^12": Variant("sort_rows.cu", [
        ("constexpr int kUnsortLogW = 14;", "constexpr int kUnsortLogW = 12;")]),
    "unsort W 2^13": Variant("sort_rows.cu", [
        ("constexpr int kUnsortLogW = 14;", "constexpr int kUnsortLogW = 13;")]),
    "unsort W 2^15": Variant("sort_rows.cu", [
        ("constexpr int kUnsortLogW = 14;", "constexpr int kUnsortLogW = 15;")]),
    "unsort tile 2^13": Variant("sort_rows.cu", [
        ("constexpr int kPartItems = 32;", "constexpr int kPartItems = 16;")]),
    "unsort pass 2 on 256 threads": Variant("sort_rows.cu", [
        ("constexpr int kPlaceThreads = 512;", "constexpr int kPlaceThreads = 256;")]),
    # kernel E as shipped, with one device taken out
    "E without the 4-pixel runs": Variant("hist_lovasz.cu", [
        ("    if (key != r.key) {", "    if (true) {")]),
    "E with float sums only": Variant("hist_lovasz.cu", [
        ("const bool fixed = q >= kFixLo && q < kFixHi;", "const bool fixed = false;")]),
    "E loads and bucket ids only": Variant("hist_lovasz.cu", [
        ("    if (r.n) h.add(r.key, r.n, r.u, r.f);",
         "    if (r.n && r.key == -7 - bins) h.add(r.key, r.n, r.u, r.f);")]),
    # E above 8192 bins (bucket ranges), as shipped with one device taken out
    "E ranged on 512 threads": Variant("hist_lovasz.cu", [
        ("constexpr int kRangedThreads = 1024;", "constexpr int kRangedThreads = 512;")]),
    "E ranged with 1 load in flight": Variant("hist_lovasz.cu", [
        ("      for (; v + 3 * T < n4; v += 4 * T) {",
         "      for (; false && v + 3 * T < n4; v += 4 * T) {")]),
    # the histogram kernel with float sums in shared memory (an earlier
    # tree's csrc, given by --csrc), with one step taken out: its split
    "E, float-sum design, as it was": Variant("hist_lovasz.cu", earlier=E_FLOAT_SUM),
    "E, float-sum design, without the global flush": Variant("hist_lovasz.cu", earlier=E_FLOAT_SUM, subs=[
        ("  __syncthreads();\n\n  int* c_row", "  __syncthreads();\n  if (P > 0) return;\n  int* c_row")]),
    "E, float-sum design, without float atomics": Variant("hist_lovasz.cu", earlier=E_FLOAT_SUM, subs=[
        ("    atomicAdd(&s_S[b], e);\n", ""), ("      atomicAdd(&s_Sf[b], e);\n", "")]),
    "E, float-sum design, loads and bucket ids only": Variant("hist_lovasz.cu", earlier=E_FLOAT_SUM, subs=[
        ("    atomicAdd(&s_n[b], 1);\n    atomicAdd(&s_S[b], e);\n    if (f_row[p]) {\n"
         "      atomicAdd(&s_f[b], 1);\n      atomicAdd(&s_Sf[b], e);\n    }\n",
         "    acc += b + (f_row[p] ? 1 : 0) + (e == 0.5f);\n"),
        ("  for (long long p = start + threadIdx.x; p < end; p += HIST_THREADS) {\n    const float e",
         "  int acc = 0;\n  for (long long p = start + threadIdx.x; p < end; p += HIST_THREADS) {\n"
         "    const float e"),
        ("  __syncthreads();\n\n  int* c_row", "  if (acc == -7) s_n[0] = acc;\n  __syncthreads();\n\n"
         "  int* c_row")]),
    # kernel B as shipped, with one constant changed or one step taken out
    "B band of 2 rows": Variant("upsample_heads.cu", [
        ("constexpr int kBandRows = 4;", "constexpr int kBandRows = 2;")]),
    "B band of 8 rows": Variant("upsample_heads.cu", [
        ("constexpr int kBandRows = 4;", "constexpr int kBandRows = 8;")]),
    "B on 128 threads": Variant("upsample_heads.cu", [
        ("constexpr int kEntThreads = 256;", "constexpr int kEntThreads = 128;")]),
    "B on 512 threads": Variant("upsample_heads.cu", [
        ("constexpr int kEntThreads = 256;", "constexpr int kEntThreads = 512;")]),
    "B band of 16 rows": Variant("upsample_heads.cu", [
        ("constexpr int kBandRows = 4;", "constexpr int kBandRows = 16;")]),
    "B with exp2f": Variant("upsample_heads.cu", [
        ("      const float e = fast_exp2(d);", "      const float e = exp2f(d);")]),
    "B with expf": Variant("upsample_heads.cu", [
        ("      const float e = fast_exp2(d);", "      const float e = expf(d * kLn2);")]),
    "B loads and argmax only": Variant("upsample_heads.cu", [
        ("      const float e = fast_exp2(d);", "      const float e = d;")]),
    "B without the label store": Variant("upsample_heads.cu", [
        ("      *reinterpret_cast<int4*>(dst) = make_int4(",
         "      if (lab[0] == -7) *reinterpret_cast<int4*>(dst) = make_int4(")]),
    "B with 4-byte label stores": Variant("upsample_heads.cu", [
        ("    if (W % 4 == 0) {  // then x0, cols and xg are multiples of 4 too",
         "    if (false) {  // then x0, cols and xg are multiples of 4 too")]),
    "B with scalar staging loads": Variant("upsample_heads.cu", [
        ("  const bool vec = (w * C) % 4 == 0 && (lx0 * C) % 4 == 0",
         "  const bool vec = false && (w * C) % 4 == 0 && (lx0 * C) % 4 == 0")]),
    "B on 128 threads, band of 8 rows": Variant("upsample_heads.cu", [
        ("constexpr int kEntThreads = 256;", "constexpr int kEntThreads = 128;"),
        ("constexpr int kBandRows = 4;", "constexpr int kBandRows = 8;")]),
    "B with class loops unrolled by 2": Variant("upsample_heads.cu", [
        ("  for (int k = 1; k < C; ++k) {\n    const float x = a[k], y = b[k];",
         "#pragma unroll 2\n  for (int k = 1; k < C; ++k) {\n    const float x = a[k], y = b[k];"),
        ("  for (int k = 0; k < C; ++k) {\n    const float x = a[k], y = b[k];",
         "#pragma unroll 2\n  for (int k = 0; k < C; ++k) {\n    const float x = a[k], y = b[k];")]),
    "B with class loops unrolled by 4": Variant("upsample_heads.cu", [
        ("  for (int k = 1; k < C; ++k) {\n    const float x = a[k], y = b[k];",
         "#pragma unroll 4\n  for (int k = 1; k < C; ++k) {\n    const float x = a[k], y = b[k];"),
        ("  for (int k = 0; k < C; ++k) {\n    const float x = a[k], y = b[k];",
         "#pragma unroll 4\n  for (int k = 0; k < C; ++k) {\n    const float x = a[k], y = b[k];")]),
    "B with class loops not unrolled": Variant("upsample_heads.cu", [
        ("  for (int k = 1; k < C; ++k) {\n    const float x = a[k], y = b[k];",
         "#pragma unroll 1\n  for (int k = 1; k < C; ++k) {\n    const float x = a[k], y = b[k];"),
        ("  for (int k = 0; k < C; ++k) {\n    const float x = a[k], y = b[k];",
         "#pragma unroll 1\n  for (int k = 0; k < C; ++k) {\n    const float x = a[k], y = b[k];")]),
    "B pixel by pixel (no shared-tap groups)": Variant("upsample_heads.cu", [
        ("    if (nx == 4 && c0.x == c3.x && c0.y == c3.y) {", "    if (false) {")]),
    "B staging without row reuse": Variant("upsample_heads.cu", [
        ("    if (ri.x != i_lo) {", "    if (true) {"), ("      if (ri.x == i_hi) {", "      if (false) {"),
        ("    if (ri.y != i_hi) {", "    if (true) {"), ("      if (ri.y == i_lo) {", "      if (false) {")]),
    "B pixels only (no staging)": Variant("upsample_heads.cu", [
        ("  stage_band_rows(logits + (size_t)n * h * w * C,",
         "  if (n < 0) stage_band_rows(logits + (size_t)n * h * w * C,")]),
    "B staging only (no pixels)": Variant("upsample_heads.cu", [
        ("  for (int g = threadIdx.x; g < rows * gw; g += kEntThreads) {",
         "  for (int g = threadIdx.x; g < 0; g += kEntThreads) {")]),
    # kernel C as shipped, with one step taken out or swapped.  B and C share
    # their group walk (label_band): where a variant changes it, B's variant
    # of the same name changes it too, and each is timed under its kernel
    "C staging only (no pixels)": Variant("upsample_heads.cu", [
        ("  label_band<false>(t_s,", "  if (n < 0) label_band<false>(t_s,")]),
    "C pixels only (no staging)": Variant("upsample_heads.cu", [
        ("  stage_band_rows(logits, w, C,", "  if (n < 0) stage_band_rows(logits, w, C,")]),
    "C pixel by pixel (no shared-tap groups)": Variant("upsample_heads.cu", [
        ("    if (nx == 4 && c0.x == c3.x && c0.y == c3.y) {", "    if (false) {")]),
    "C without the label store": Variant("upsample_heads.cu", [
        ("      *reinterpret_cast<int4*>(dst) = make_int4(",
         "      if (lab[0] == -7) *reinterpret_cast<int4*>(dst) = make_int4(")]),
    "C with 4-byte label stores": Variant("upsample_heads.cu", [
        ("    if (W % 4 == 0) {  // then x0, cols and xg are multiples of 4 too",
         "    if (false) {  // then x0, cols and xg are multiples of 4 too")]),
    # the two levers: (a) groups of 8 pixels that share their taps, half the
    # shared reads a pixel; (b) more work a block, a band of 8 rows
    "C groups of 8 pixels": Variant("upsample_heads.cu", [
        ("// Kernel C.  Grid: N * bands * ctiles blocks", C_GROUPS_OF_8 + "// Kernel C.  Grid: N * bands * ctiles blocks"),
        ("  label_band<false>(t_s,", "  label_band8(t_s,")]),
    "C groups of 8 pixels over 3 low-res columns": Variant("upsample_heads.cu", [
        ("// Kernel C.  Grid: N * bands * ctiles blocks",
         C_GROUPS_OF_8_3COL + "// Kernel C.  Grid: N * bands * ctiles blocks"),
        ("  label_band<false>(t_s,", "  label_band8c(t_s,")]),
    "C band of 8 rows": Variant("upsample_heads.cu", [
        ("constexpr int kBandRows = 4;", "constexpr int kBandRows = 8;")]),
    # kernel F as shipped, with one constant changed or one step taken out
    "F on 256 threads, tiles of 2048": Variant("hist_lovasz.cu", [
        ("constexpr int kWideThreads = 1024;", "constexpr int kWideThreads = 256;"),
        ("constexpr int kLookupTile = 8192;", "constexpr int kLookupTile = 2048;")]),
    "F with 1 step in flight": Variant("hist_lovasz.cu", [
        ("constexpr int kLookupTile = 8192;", "constexpr int kLookupTile = 4096;")]),
    "F with 4 steps in flight": Variant("hist_lovasz.cu", [
        ("constexpr int kLookupTile = 8192;", "constexpr int kLookupTile = 16384;")]),
    "F with scalar loads": Variant("hist_lovasz.cu", [
        ("                  reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&",
         "                  false && reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&")]),
    "F through L2 above 1024 bins": Variant("hist_lovasz.cu", [
        ("constexpr int kStagedLookupBins = 16384;", "constexpr int kStagedLookupBins = 1024;")]),
    "F one block a tile": Variant("hist_lovasz.cu", [(F_PERSISTENT, F_PERSISTENT.replace("staged", "false"))]),
    "F through L2 on a persistent grid": Variant("hist_lovasz.cu", [
        (F_PERSISTENT, F_PERSISTENT.replace("staged", "true"))]),
    "F without the table reads": Variant("hist_lovasz.cu", [
        ("      return tab[is_fg ? b : bins + b] * valid;",
         "      return (float)(is_fg ? b : bins + b) * valid;"),
        ("      return __ldg(&tab[is_fg ? b : bins + b]) * valid;",
         "      return (float)(is_fg ? b : bins + b) * valid;")]),
    # kernel F with one block a chunk of a row (an earlier tree's csrc, given
    # by --csrc), as it was: timed in turns with the shipped kernel
    "F, per-chunk design, as it was": Variant("hist_lovasz.cu", earlier=F_PER_CHUNK),
    # kernel A as shipped, with one step taken out or swapped
    "A without the label read (all void)": Variant("upsample_heads.cu", [
        ("      const int4 q = __ldg(reinterpret_cast<const int4*>(src));",
         "      const int4 q = make_int4(-1, -1, -1, -1);")]),
    "A without counting": Variant("upsample_heads.cu", [
        (A_COUNTS, "    if (pred[0] + pred[1] + pred[2] + pred[3] + truth[0] + truth[1] + truth[2]"
                   " + truth[3] == -100)\n      hist[0] = 1;\n")]),
    "A pixel by pixel (no shared-tap groups)": Variant("upsample_heads.cu", [
        ("    if (c0.x == c3.x && c0.y == c3.y && nx == 4) {", "    if (false) {")]),
    "A pixels only (no staging)": Variant("upsample_heads.cu", [
        ("  stage_band_rows(img, w, C,", "  if (n < 0) stage_band_rows(img, w, C,")]),
    "A staging only (no pixels)": Variant("upsample_heads.cu", [
        ("  for (int g = threadIdx.x; g < groups; g += kEntThreads) {",
         "  for (int g = threadIdx.x; g < 0; g += kEntThreads) {")]),
    # kernel A with same-key counts merged before they reach shared memory:
    # the 4 pixels of a group where their keys agree, then (second variant)
    # the lanes of a warp, each key's sum added by its lowest lane
    "A with the 4 pixels' keys merged": Variant("upsample_heads.cu", [
        ("// Kernel A.  Grid: count * bands * ctiles blocks", A_MERGE_HELPERS + "// Kernel A.  Grid: count * bands * ctiles blocks"),
        (A_COUNTS, A_MERGED_COUNTS)]),
    "A with the 4 pixels' and the warp's keys merged (match_any)": Variant("upsample_heads.cu", [
        ("// Kernel A.  Grid: count * bands * ctiles blocks",
         A_MERGE_HELPERS.replace("    if (key >= 0) atomicAdd(&hist[key], n);\n",
                                 "    if (__any_sync(__activemask(), key >= 0)) {\n"
                                 "      const unsigned peers = __match_any_sync(__activemask(), key);\n"
                                 "      const unsigned total = __reduce_add_sync(peers, (unsigned)n);\n"
                                 "      if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)\n"
                                 "        atomicAdd(&hist[key], (int)total);\n    }\n")
         + "// Kernel A.  Grid: count * bands * ctiles blocks"),
        (A_COUNTS, A_MERGED_COUNTS)]),
    # kernel A with one thread an output pixel (an earlier tree's csrc, given
    # by --csrc), as it was: timed in turns with the shipped kernel; kernel B
    # of that tree too
    "A, per-pixel design, as it was": Variant("upsample_heads.cu", earlier=A_PER_PIXEL),
    # kernel C with one thread an output pixel (an earlier tree's csrc, given
    # by --csrc), as it was: timed in turns with the shipped kernel; that
    # tree's kernels A and B are held against the shipped ones too
    "C, per-pixel design, as it was": Variant("upsample_heads.cu", earlier=C_PER_PIXEL),
    # kernel B with one thread an output pixel reading its 2x2 taps of every
    # class from device memory (an earlier tree's csrc, given by --csrc),
    # as it was and with one step taken out or swapped: its split
    "B, per-pixel design, as it was": Variant("upsample_heads.cu", earlier=B_PER_PIXEL),
    "B, per-pixel design, loads and argmax only": Variant("upsample_heads.cu", earlier=B_PER_PIXEL, subs=[
        ("          const float e = expf(d);\n", "          const float e = d;\n")]),
    "B, per-pixel design, without the label store": Variant("upsample_heads.cu", earlier=B_PER_PIXEL, subs=[
        ("    labels_out[(size_t)n * HW + p] = arg;\n    ent = logf(z) - s / z;",
         "    if (arg == -7) labels_out[(size_t)n * HW + p] = arg;\n    ent = logf(z) - s / z;")]),
    "B, per-pixel design, __expf": Variant("upsample_heads.cu", earlier=B_PER_PIXEL, subs=[
        ("          const float e = expf(d);\n", "          const float e = __expf(d);\n")]),
    "B, per-pixel design, exp2f on prescaled values": Variant("upsample_heads.cu", earlier=B_PER_PIXEL, subs=[
        ("          const float d = v[k] - m;\n          const float e = expf(d);\n",
         "          const float d = (v[k] - m) * 1.44269504f;\n          const float e = exp2f(d);\n"),
        ("    ent = logf(z) - s / z;", "    ent = 0.69314718f * (log2f(z) - s / z);")]),
}


def variant_so(name, _build):
    """The library path of a variant, named by a hash of its name (a
    process loads a path once: two variants must not share one)."""
    return _build.BUILD_DIR / "variants" / f"v{hashlib.sha1(name.encode()).hexdigest()[:12]}.so"


def build_variants(names, csrc, _build):
    """Compile each variant whose substitutions apply, in parallel; return
    {name: ctypes library}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name in names:
        src, subs, earlier = VARIANTS[name]
        text = (csrc / src).read_text()
        if not all(a in text for a, _ in subs) or (earlier is not None and earlier not in text):
            print(f"[variants] {name}: not in {csrc / src}, skipped")
            continue
        for a, b in subs:
            text = text.replace(a, b)
        so = variant_so(name, _build)
        cu = so.with_suffix(".cu")
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
        signatures = {**_build._SIGNATURES,
                      **(EARLIER_SIGNATURES if VARIANTS[name].earlier else {})}
        for fn_name, (args, res) in signatures.items():
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


def sass_of(so, _build, name):
    """{kernel: [SASS instructions]} of the kernels in a built library whose
    names contain ``name``, with the file's hash taken out of the names and
    the addresses out of the instructions: two builds of the same kernel
    compare equal."""
    tool = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    fns, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_ZN",
                        line.split("Function :")[1].strip())
            fns[fn] = []
        elif fn is not None and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split(";")[0].strip()
            if ins:
                fns[fn].append(ins)
    return {k: v for k, v in fns.items() if name in k}


def sass_moved(new, old):
    """What two SASS listings of one kernel (``sass_of``) differ in beyond
    register numbers: the instructions (the encoding words left out) with
    every register and predicate name made R or P, compared in order, and
    the opcodes that one holds more often than the other."""
    def norm(ins):
        return [re.sub(r"\bU?P[0-7T]\b", "P", re.sub(r"\bU?R(\d+|Z)\b", "R", i))
                for i in ins if not i.startswith("/*")]
    a, b = norm(new), norm(old)
    ops = lambda x: collections.Counter(next(t for t in i.split() if not t.startswith("@"))
                                        for i in x)
    more, fewer = ops(a) - ops(b), ops(b) - ops(a)
    return (f"{len(a)} instructions ({len(b)} in the earlier tree's), equal with registers "
            f"renamed {a == b}; opcodes more {dict(more)}, fewer {dict(fewer)}")


def lookup_with(lib, errors, fg, emax, inv_w, tables, bins, torch, earlier=False):
    """Kernel F through a variant's library; ``earlier``: the per-chunk
    design's interface, with the chunk its wrapper gave it."""
    out = torch.empty_like(errors)
    chunk = (max(1 << 15, 16 * min(bins, 8192)),) if earlier else ()
    err = lib.ee_table_lookup(errors.data_ptr(), fg.data_ptr(), emax.data_ptr(), inv_w.data_ptr(),
                              tables.data_ptr(), errors.shape[0], errors.shape[1], bins, *chunk,
                              out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lookup variant: CUDA error {err}")
    return out


def conf_with(lib, U, logits, labels, count, H, W, torch):
    """Kernel A through a variant's library: (3, C) int32 counts."""
    _, h, w, C = logits.shape
    counts = torch.zeros((3, C), dtype=torch.int32, device="cuda")
    err = lib.ee_upsample_argmax_confusion(
        *U._launch_args(logits, H, W), labels.data_ptr(), count, h, w, C, H, W,
        counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"confusion head variant: CUDA error {err}")
    return counts


def argmax_with(lib, U, logits, H, W, torch):
    """Kernel C through a variant's library (or an earlier tree's: the
    entry point's signature is unchanged): (N, H, W) int32 maps."""
    N, h, w, C = logits.shape
    labels = torch.empty((N, H, W), dtype=torch.int32, device="cuda")
    err = lib.ee_upsample_argmax(*U._launch_args(logits, H, W), N, h, w, C, H, W,
                                 labels.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"argmax head variant: CUDA error {err}")
    return labels


def in_turns(ms, name, variant, shipped, median_ms):
    """A variant timed in turns with the shipped kernel (variant, shipped,
    shipped, variant) under ``name`` and ``name, again``, the shipped
    kernel under ``shipped (in turns with <name>)``."""
    ms[name] = median_ms(variant)
    ms[f"shipped (in turns with {name})"] = median_ms(shipped)
    ms[f"shipped (in turns with {name}), again"] = median_ms(shipped)
    ms[f"{name}, again"] = median_ms(variant)


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
    chunk = max(1 << 16, 64 * min(bins, 8192))  # the wrapper's: sized by E's bucket range
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


def ent_with(lib, U, logits, H, W, torch):
    """Kernel B through a variant's library: (maps, entropies)."""
    N, h, w, C = logits.shape
    per_img = (lib.ee_ent_partials_per_image(h, w, C, H, W)
               if hasattr(lib, "ee_ent_partials_per_image")
               else -(-H * W // lib.ee_threads_per_block()))  # one partial a block of pixels
    labels = torch.empty((N, H, W), dtype=torch.int32, device="cuda")
    partial = torch.empty((N, per_img), dtype=torch.float32, device="cuda")
    ent = torch.empty((N,), dtype=torch.float32, device="cuda")
    err = lib.ee_upsample_entropy_argmax(
        *U._launch_args(logits, H, W), N, h, w, C, H, W, 1.0 / (H * W * math.log(C)),
        labels.data_ptr(), partial.data_ptr(), ent.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"entropy head variant: CUDA error {err}")
    return labels, ent


def heads_vs_earlier(lib, so, kernels, U, CS, logits, labels, _build, torch):
    """An earlier tree's eval heads (``so``, loaded as ``lib``) against the
    shipped ones, for each kernel name in ``kernels`` (B's
    ``up_ent_argmax_kernel``, A's ``up_argmax_conf_kernel``): SASS
    instruction for instruction, outputs, and time in turns, at
    ``logits`` and ``labels``."""
    N, _, _, C = logits.shape
    H, W = labels.shape[1:]
    for name in kernels:
        old, new = (sass_of(f, _build, name) for f in (so, _build.build()))
        for k in new:
            o = old.get(k, [])
            diff = [(i, a, b) for i, (a, b) in enumerate(zip(new[k], o)) if a != b]
            print(f"[variants] {name}'s SASS ({k[:60]}...): {len(new[k])} lines "
                  f"({len(o)} in the earlier tree's), equal {new[k] == o}; "
                  f"{len(diff)} differ, the first: {diff[:3]}; {sass_moved(new[k], o)}")
    # both trees through the same helpers: the same allocations around each
    shipped = _build.load_library()
    shape = f"N={N} {logits.shape[1]}x{logits.shape[2]}->{H}x{W} C={C} f32"
    if "up_ent_argmax_kernel" in kernels:
        maps_o, ent_o = ent_with(lib, U, logits, H, W, torch)
        maps_n, ent_n = ent_with(shipped, U, logits, H, W, torch)
        print(f"[variants] B outputs equal the earlier tree's: maps "
              f"{bool(torch.equal(maps_o, maps_n))}, entropies {bool(torch.equal(ent_o, ent_n))}")
        ms = {}
        in_turns(ms, "B of the earlier tree", lambda: ent_with(lib, U, logits, H, W, torch),
                 lambda: ent_with(shipped, U, logits, H, W, torch), CS.median_ms)
        print(f"[variants] B {shape} ms: {json.dumps(ms)}")
    if "up_argmax_conf_kernel" in kernels:
        conf_o = conf_with(lib, U, logits, labels, N, H, W, torch)
        conf_n = conf_with(shipped, U, logits, labels, N, H, W, torch)
        print(f"[variants] A's counts equal the earlier tree's: {bool(torch.equal(conf_o, conf_n))}")
        ms = {}
        in_turns(ms, "A of the earlier tree",
                 lambda: conf_with(lib, U, logits, labels, N, H, W, torch),
                 lambda: conf_with(shipped, U, logits, labels, N, H, W, torch), CS.median_ms)
        print(f"[variants] A {shape} ms: {json.dumps(ms)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=pathlib.Path, default=None,
                    help="take the variants' sources from this csrc/ directory")
    ap.add_argument("--only", choices=("unsort", "hist", "ent", "lookup", "conf", "argmax"),
                    default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
    from ee_semantic_segmentation_tpu_torch.ops.kernels import hist as Hk
    from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as S
    from ee_semantic_segmentation_tpu_torch.ops.kernels import upsample_argmax as U
    from ee_semantic_segmentation_tpu_torch.ops.lovasz import _hist_prepass, _hist_tables

    card = CS.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card.splitlines()[0])
    csrc = args.csrc or _build.CSRC
    _build.load_library()
    prefix = {"unsort": "unsort", "hist": "E", "ent": "B", "lookup": "F", "conf": "A",
              "argmax": "C"}
    # the shipped sources' variants, or with --csrc the earlier designs'
    names = [n for n, v in VARIANTS.items()
             if (args.only is None or n.startswith(prefix[args.only]))
             and (v.earlier is None) == (args.csrc is None)]
    libs = build_variants(names, csrc, _build)
    as_it_was = {n for n in libs if VARIANTS[n].earlier and not VARIANTS[n].subs}
    for name, so in [("shipped", _build.build())] + [(n, variant_so(n, _build)) for n in as_it_was]:
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
        for bins, (R, P) in [(HIST_BINS, rows) for rows in FLAGSHIP_ROWS] + [
                (WIDE_BINS, FLAGSHIP_ROWS[0])]:
            for law in (None, *CS.LOVASZ_LAWS):
                errors, fg, valid = CS.hist_rows(R, P, g, torch, law)
                emax, inv_w = _hist_prepass(errors, valid, bins)
                hk = Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=bins)
                hp = Hk.hist2d_weighted_plain(errors, fg, emax, inv_w, bins=bins)
                s64 = CS.hist_sums_f64(errors, fg, emax, inv_w, bins, torch)
                rel = CS.max_rel(hk[:, 2:], s64, torch)
                CS.check(bool(torch.equal(hk[:, :2], hp[:, :2])), f"E's counts at {R}x{P} {law}")
                CS.check(rel <= CS.TOL_HIST_SUM_RTOL, f"E's sums at {R}x{P} {law}: rel {rel:.3g}")
                rel = f"{rel:.3g} (the plain version's {CS.max_rel(hp[:, 2:], s64, torch):.3g})"
                ms = {"shipped": CS.median_ms(
                    lambda: Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=bins))}
                for name, lib in libs.items():  # the ranged variants differ above 8192 only
                    if name.startswith("E") and (bins > 8192 or not name.startswith("E ranged")):
                        ms[name] = CS.median_ms(
                            lambda: hist_with(lib, errors, fg, emax, inv_w, bins, torch))
                print(f"[variants] E {R}x{P} {bins} bins {law or 'uniform'}: sums rel to float64 "
                      f"{rel}; ms {json.dumps(ms)}")
                print(f"[variants] E {R}x{P} {bins} bins {law or 'uniform'} shipped, per CUDA "
                      f"kernel: {CS.per_kernel_ms(lambda: Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=bins), torch)}")
                del errors, fg, valid, hk, hp, s64
                torch.cuda.empty_cache()

    if args.only in (None, "lookup"):
        for bins in (HIST_BINS, *LOOKUP_BINS):
            for (R, P), law in itertools.product(FLAGSHIP_ROWS, (None, *CS.LOVASZ_LAWS)):
                errors, fg, valid = CS.hist_rows(R, P, g, torch, law)
                emax, inv_w = _hist_prepass(errors, valid, bins)
                _, tables = _hist_tables(Hk.hist2d_weighted(errors, fg, emax, inv_w, bins=bins))
                tables = tables.contiguous()
                shipped = lambda: Hk.table_lookup(errors, fg, emax, inv_w, tables, bins=bins)
                want = Hk.table_lookup_plain(errors, fg, emax, inv_w, tables, bins=bins)
                CS.check(CS.bits_equal(shipped(), want, torch), f"F at {R}x{P} {bins} {law}")
                ms = {"shipped": CS.median_ms(shipped)}
                for name, lib in libs.items():
                    if not name.startswith("F"):
                        continue
                    fn = lambda: lookup_with(lib, errors, fg, emax, inv_w, tables, bins, torch,
                                             earlier=bool(VARIANTS[name].earlier))
                    if name in as_it_was:
                        in_turns(ms, name, fn, shipped, CS.median_ms)
                    else:
                        ms[name] = CS.median_ms(fn)
                idx2 = (((emax[:, None] - errors) * inv_w[:, None]).clamp(0, bins - 1).long()
                        + bins * (~fg).long())
                ms["gather"] = CS.median_ms(lambda: torch.gather(tables.view(R, 2 * bins), 1, idx2))
                ms["shipped, again"] = CS.median_ms(shipped)
                print(f"[variants] F {R}x{P} {bins} bins {law or 'uniform'} ms: {json.dumps(ms)}")
                print(f"[variants] F {R}x{P} {bins} bins {law or 'uniform'} shipped, per CUDA "
                      f"kernel: {CS.per_kernel_ms(shipped, torch)}")
                del errors, fg, valid, tables, want, idx2
                torch.cuda.empty_cache()

    if args.only in (None, "conf"):
        N, h, w, H, W = 16, 64, 64, 512, 512
        rng = np.random.RandomState(0)  # chip_smoke.py phase 3's flagship logits and labels
        logits = torch.from_numpy((2 * rng.randn(N, h, w, CS.C)).astype(np.float32)).cuda()
        labels = torch.from_numpy(rng.randint(0, CS.C + 1, (N, H, W)).astype(np.int32)).cuda()
        lt, lab_t = (torch.from_numpy(a).cuda()
                     for a in CS.trained_conf_law(N, h, w, H, W, CS.C, seed=5))
        for law, (x, y) in (("uniform", (logits, labels)), ("trained", (lt, lab_t))):
            want = U.upsample_argmax_confusion_plain(x, y, N, (H, W))
            shipped = lambda: U.upsample_argmax_confusion(x, y, N, (H, W))
            CS.conf_vs_plain(U, torch, f"{law} law", x, y, N, (H, W))
            ms = {"shipped": CS.median_ms(shipped)}
            for name, lib in libs.items():
                if not name.startswith("A"):
                    continue
                fn = lambda: conf_with(lib, U, x, y, N, H, W, torch)
                if name in as_it_was:
                    got = fn().float()
                    print(f"[variants] A {name} on the {law} law: counts equal the plain "
                          f"version's {bool(torch.equal(got, want))}")
                    in_turns(ms, name, fn, shipped, CS.median_ms)
                else:
                    ms[name] = CS.median_ms(fn)
            ms["shipped, again"] = CS.median_ms(shipped)
            print(f"[variants] A N={N} {h}x{w}->{H}x{W} C={CS.C} f32, {law} law ms: "
                  f"{json.dumps(ms)}")
            print(f"[variants] A {law} law shipped, per CUDA kernel: "
                  f"{CS.per_kernel_ms(shipped, torch)}")
        # kernel B of the earlier tree (the "as it was" library) against the
        # shipped one: its SASS, its outputs and its time in turns
        for name, lib in libs.items():
            if name.startswith("A") and name in as_it_was:
                heads_vs_earlier(lib, variant_so(name, _build), ("up_ent_argmax_kernel",), U, CS,
                                 logits, labels, _build, torch)

    if args.only in (None, "argmax"):
        N, h, w, H, W = 16, 64, 64, 512, 512
        rng = np.random.RandomState(0)  # chip_smoke.py phase 3's flagship logits and labels
        logits = torch.from_numpy((2 * rng.randn(N, h, w, CS.C)).astype(np.float32)).cuda()
        labels = torch.from_numpy(rng.randint(0, CS.C + 1, (N, H, W)).astype(np.int32)).cuda()
        lt = torch.from_numpy(CS.trained_conf_law(N, h, w, H, W, CS.C, seed=5)[0]).cuda()
        for law, x in (("uniform", logits), ("trained", lt)):
            maps_p = U.upsample_argmax_plain(x, (H, W))
            shipped = lambda: U.upsample_argmax(x, (H, W))
            got = shipped()
            agree = 1.0 - (got != maps_p).float().mean().item()
            same_b = bool(torch.equal(got, U.upsample_entropy_argmax(x, (H, W))[0]))
            CS.check(agree >= CS.TOL_MAP_AGREE and same_b,
                     f"kernel C on the {law} law: maps agree {agree}, equal B's {same_b}")
            ms = {"shipped": CS.median_ms(shipped)}
            for name, lib in libs.items():
                if not name.startswith("C"):
                    continue
                fn = lambda: argmax_with(lib, U, x, H, W, torch)
                a = 1.0 - (fn() != maps_p).float().mean().item()
                print(f"[variants] C {name} on the {law} law: maps agree {a:.7f} (a variant that "
                      "takes a step out is wrong by design)")
                in_turns(ms, name, fn, shipped, CS.median_ms)
            ms["shipped, again"] = CS.median_ms(shipped)
            print(f"[variants] C N={N} {h}x{w}->{H}x{W} C={CS.C} f32, {law} law ms: "
                  f"{json.dumps(ms)}")
            for name, lib in (("shipped", None), *libs.items()):
                if name == "shipped" or name.startswith("C"):
                    fn = (shipped if lib is None else
                          (lambda: argmax_with(lib, U, x, H, W, torch)))
                    print(f"[variants] C {name}, {law} law, per CUDA kernel [launches, ms]: "
                          f"{CS.per_kernel_ms(fn, torch)}")
        # kernels B and A of the earlier tree (C's "as it was" library)
        # against the shipped ones: SASS, outputs and time in turns
        for name, lib in libs.items():
            if name.startswith("C") and name in as_it_was:
                heads_vs_earlier(lib, variant_so(name, _build),
                                 ("up_ent_argmax_kernel", "up_argmax_conf_kernel"), U, CS,
                                 logits, labels, _build, torch)

    if args.only in (None, "ent"):
        N, h, w, H, W = 16, 64, 64, 512, 512
        rng = np.random.RandomState(0)  # chip_smoke.py phase 3's flagship logits
        logits = torch.from_numpy((2 * rng.randn(N, h, w, CS.C)).astype(np.float32)).cuda()
        maps_p, ent_p = U.upsample_entropy_argmax_plain(logits, (H, W))

        def agreement(maps, ent):
            rel = float(((ent - ent_p).abs() / ent_p.abs()).max())
            return 1.0 - (maps != maps_p).float().mean().item(), rel

        agree, rel = agreement(*U.upsample_entropy_argmax(logits, (H, W)))
        CS.check(agree >= CS.TOL_MAP_AGREE and rel <= CS.TOL_ENT_RTOL,
                 f"kernel B vs plain: maps agree {agree}, entropy rel {rel:.3g}")
        ms = {"shipped": CS.median_ms(lambda: U.upsample_entropy_argmax(logits, (H, W)))}
        for name, lib in libs.items():
            if name.startswith("B"):
                a, r = agreement(*ent_with(lib, U, logits, H, W, torch))
                print(f"[variants] B {name}: maps agree {a:.7f}, entropy rel {r:.3g} (a variant "
                      "that takes a step out is wrong by design)")
                ms[name] = CS.median_ms(lambda: ent_with(lib, U, logits, H, W, torch))
        ms["shipped, again"] = CS.median_ms(lambda: U.upsample_entropy_argmax(logits, (H, W)))
        print(f"[variants] B N={N} {h}x{w}->{H}x{W} C={CS.C} f32 ms: {json.dumps(ms)}")
        for name, lib in (("shipped", None), *libs.items()):
            if name == "shipped" or name.startswith("B"):
                fn = ((lambda: U.upsample_entropy_argmax(logits, (H, W))) if lib is None
                      else (lambda: ent_with(lib, U, logits, H, W, torch)))
                print(f"[variants] B {name}, per CUDA kernel [launches, ms]: "
                      f"{CS.per_kernel_ms(fn, torch)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
