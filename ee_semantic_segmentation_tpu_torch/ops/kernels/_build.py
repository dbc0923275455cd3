"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

``csrc/*.cu`` compile into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds) under ``_build/`` beside
this file: one nvcc per source, all started together, then one link.  The
library's file name carries a hash of the sources and of the compile and
link flags, so an edited source builds anew and an unchanged one is reused.
There is no fallback: a missing ``nvcc`` or a failed build raises, naming
the command.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "ee_threads_per_block": ([], _I),
    "ee_error_string": ([_I], ctypes.c_char_p),
    # logits, is_bf16, row_idx, row_w, col_idx, col_w, labels,
    # count, h, w, C, H, W, counts, stream
    "ee_upsample_argmax_confusion": (
        [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P], _I),
    # logits, is_bf16, row_idx, row_w, col_idx, col_w,
    # N, h, w, C, H, W, inv_norm, labels_out, partial, ent_out, stream
    "ee_upsample_entropy_argmax": (
        [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P], _I),
    # logits, is_bf16, row_idx, row_w, col_idx, col_w, N, h, w, C, H, W, labels_out, stream
    "ee_upsample_argmax": ([_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P], _I),
    "ee_sort_log2_tile": ([], _I),
    # key_in, pay_in, key_is_float, B, P, key_out, pay_out, scr_key, scr_pay, stream
    "ee_sort_rows": ([_P, _P, _I, _L, _L, _P, _P, _P, _P, _P], _I),
    "ee_hist_max_bins": ([], _I),
    # errors, fg, emax, inv_w, rows, P, bins, chunk, counts, out, stream
    "ee_hist2d_weighted": ([_P, _P, _P, _P, _L, _L, _I, _L, _P, _P, _P], _I),
    # errors, fg, emax, inv_w, tables, rows, P, bins, chunk, out, stream
    "ee_table_lookup": ([_P, _P, _P, _P, _P, _L, _L, _I, _L, _P, _P], _I),
}


def find_nvcc() -> str | None:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc")


def build(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless this exact build exists; return the
    ``.so`` path.  nvcc's output (``-Xptxas -v``: registers, spills) is kept
    beside it in a ``.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    so = pathlib.Path(build_dir) / f"libee_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    cmds = [[nvcc or "nvcc", *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objs)]
    cmds.append([nvcc or "nvcc", *LINK_FLAGS, "-o", str(tmp), *map(str, objs)])
    if nvcc is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc not found (set CUDA_HOME or put nvcc on "
            f"PATH); the build commands are: {' ; '.join(' '.join(c) for c in cmds)}")
    so.parent.mkdir(parents=True, exist_ok=True)
    log = []
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        steps = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in steps):
            proc = subprocess.run(cmds[-1], capture_output=True, text=True)
            steps.append((cmds[-1], proc.stdout + proc.stderr, proc.returncode))
        for cmd, out, rc in steps:
            log.append(out)
            if rc != 0:
                raise RuntimeError(f"nvcc failed with exit code {rc}: {' '.join(cmd)}\n{out}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, so)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().ee_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
