"""Kernel D's wrappers and plain versions (``ops/kernels/sort.py``: the sort
and the backward's unsort) against the JAX package's sort
(``ops/pallas/sort_kernel.sort_pallas`` in interpret mode, and
``jax.lax.sort``), on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` phase
3b).  Here the wrappers take their plain versions because the tensors lie on
the CPU.  The JAX sorts are unstable, so where keys tie, rows are compared
with them as (key, payload) pairs in lexicographic order, as
``tests/test_sort_kernel.py`` does; the port's sort is stable, and is held
bit for bit against numpy's stable argsort.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ee_semantic_segmentation_tpu.ops.pallas.sort_kernel as SK
from ee_semantic_segmentation_tpu.ops import lovasz as JL
from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as TS

# the two-pass unsort's window (csrc/sort_rows.cu kUnsortLogW): its bucket
# edges are where a row's last window is short, full or one element long
_UNSORT_W = 1 << int(re.search(r"constexpr int kUnsortLogW = (\d+);",
                               (_build.CSRC / "sort_rows.cu").read_text()).group(1))


def _run_port(key: np.ndarray, pay: np.ndarray):
    ks, ps = TS.sort_rows(torch.from_numpy(key), torch.from_numpy(pay))
    return ks.numpy(), ps.numpy()


def _assert_same_sort(got_k, got_p, want_k, want_p):
    """Sorted keys equal in value; per row, the (key, payload) pairs equal
    under lexicographic order (payload order within ties is unspecified)."""
    np.testing.assert_array_equal(got_k, want_k)
    for b in range(got_k.shape[0]):
        g = np.lexsort((got_p[b], got_k[b]))
        w = np.lexsort((want_p[b], want_k[b]))
        np.testing.assert_array_equal(got_k[b][g], want_k[b][w])
        np.testing.assert_array_equal(got_p[b][g], want_p[b][w])


def _keys(kind: str, rng, B: int, P: int):
    if kind == "randn":
        return rng.randn(B, P).astype(np.float32)
    if kind == "ties":  # 16 distinct values: every key ties with P/16 others
        return (rng.randint(0, 16, (B, P)) - 7.5).astype(np.float32)
    if kind == "signed_zeros":  # -0.0 and 0.0 are equal keys in value
        return rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, 1e30], np.float32), (B, P))
    if kind == "nan_zeros":  # +-0, NaNs of both signs, +-inf, +-1e30
        nan = np.float32(np.nan)
        vals = np.array([-0.0, 0.0, nan, -nan, np.inf, -np.inf, 1e30, -1e30, 0.5], np.float32)
        return rng.choice(vals, (B, P))
    if kind == "int_extremes":  # int32 keys incl. both ends of the range
        ends = np.array([2**31 - 1, -2**31, 0, -1], np.int32)
        keys = rng.randint(-2**31, 2**31, (B, P), dtype=np.int64).astype(np.int32)
        return np.where(rng.rand(B, P) < 0.2, rng.choice(ends, (B, P)), keys)
    if kind == "perm":  # the backward's int32 position keys
        return np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32)
    raise ValueError(kind)


def test_plain_matches_sort_pallas_interpret():
    """B = 3 rows of P = 1024: float32 keys with a float32 payload, and the
    backward's case, int32 permutation keys with a gradient payload."""
    rng = np.random.RandomState(0)
    for key in (_keys("randn", rng, 3, 1024), _keys("perm", rng, 3, 1024)):
        pay = rng.randn(3, 1024).astype(np.float32)
        want_k, want_p = SK.sort_pallas(jnp.asarray(key), jnp.asarray(pay), interpret=True)
        _assert_same_sort(*_run_port(key, pay), np.asarray(want_k), np.asarray(want_p))


@pytest.mark.parametrize("B,P", [(2, 2048), (2, 8192)])
def test_plain_matches_chunked_sort_pallas(monkeypatch, B, P):
    """The JAX kernel's chunked sort-and-merge path for rows longer than one
    chunk, with the chunk shrunk as in tests/test_sort_kernel.py so that the
    interpreter stays fast (P = 8192 also takes its cross-pass fallback)."""
    monkeypatch.setattr(SK, "_CHUNK", 1024)
    monkeypatch.setattr(SK, "_MERGE_MAX", 4096)
    rng = np.random.RandomState(P)
    key, pay = _keys("randn", rng, B, P), rng.rand(B, P).astype(np.float32)
    want_k, want_p = SK._sort_chunked(jnp.asarray(key), jnp.asarray(pay), interpret=True)
    _assert_same_sort(*_run_port(key, pay), np.asarray(want_k), np.asarray(want_p))


@pytest.mark.parametrize("kind,P,pay_type", [
    ("randn", 1000, np.float32),           # P not a power of two
    ("randn", 2 * 67 * 101, np.int32),     # ragged, int32 payload
    ("ties", 4096, np.int32),
    ("ties", 3000, np.float32),
    ("signed_zeros", 2048, np.int32),
    ("perm", 5000, np.float32),
    ("randn", 1, np.int32),
    ("nan_zeros", 3000, np.int32),
    ("int_extremes", 2 * 67 * 101, np.int32),  # ragged, with the int32 key 2^31 - 1
])
def test_plain_matches_lax_sort(kind, P, pay_type):
    rng = np.random.RandomState(P)
    key = _keys(kind, rng, 3, P)
    pay = (rng.randn(3, P).astype(np.float32) if pay_type == np.float32
           else np.arange(3 * P, dtype=np.int32).reshape(3, P))
    want_k, want_p = jax.lax.sort((jnp.asarray(key), jnp.asarray(pay)), num_keys=1)
    got_k, got_p = _run_port(key, pay)
    assert got_k.dtype == key.dtype and got_p.dtype == pay.dtype
    _assert_same_sort(got_k, got_p, np.asarray(want_k), np.asarray(want_p))


def test_payload_moves_as_raw_bits():
    """A float32 payload comes back bit for bit, NaN and -0.0 included."""
    key = np.array([[3.0, 1.0, 2.0, 0.0]], np.float32)
    pay = np.array([[np.nan, -0.0, np.inf, 1e-45]], np.float32)
    _, got_p = _run_port(key, pay)
    np.testing.assert_array_equal(got_p.view(np.int32), pay[:, [3, 1, 2, 0]].view(np.int32))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.RandomState(1)
    key = torch.from_numpy(rng.randn(4, 300).astype(np.float32))
    pay = torch.arange(1200, dtype=torch.int32).view(4, 300)
    TS.sort_rows.launches = 0
    got = TS.sort_rows(key, pay)
    want = TS.sort_rows_plain(key, pay)
    assert TS.sort_rows.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert TS.KERNELS == (TS.sort_rows, TS.unsort_rows)


def test_wrapper_rejects_a_tensor_that_is_neither_on_the_cpu_nor_on_cuda():
    key = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TS.sort_rows(key, torch.empty(2, 8, dtype=torch.int32, device="meta"))
    assert TS.sort_rows.launches == 0


@pytest.mark.parametrize("kind,P", [
    ("ties", 4096), ("ties", 3001), ("signed_zeros", 2048), ("nan_zeros", 5000),
    ("int_extremes", 2 * 67 * 101), ("randn", 1),
])
def test_plain_sort_is_stable_and_keeps_the_key_bits(kind, P):
    """``sort_rows_plain`` (the kernel's bit-for-bit contract) is numpy's
    stable argsort: ties, -0.0 against +0.0 and NaNs of either sign (last)
    keep their input order, and every key comes back as its own bits."""
    rng = np.random.RandomState(P)
    key = _keys(kind, rng, 3, P)
    pay = np.arange(3 * P, dtype=np.int32).reshape(3, P)
    got_k, got_p = _run_port(key, pay)
    order = np.argsort(key, axis=-1, kind="stable")
    want_k = np.take_along_axis(key, order, -1)
    np.testing.assert_array_equal(got_k.view(np.int32), want_k.view(np.int32))
    np.testing.assert_array_equal(got_p, np.take_along_axis(pay, order, -1))
    ties = got_k[:, 1:] == got_k[:, :-1]
    if kind == "nan_zeros":
        ties |= np.isnan(got_k[:, 1:]) & np.isnan(got_k[:, :-1])
        assert np.isnan(got_k[:, -1]).all()
    assert (got_p[:, 1:] > got_p[:, :-1])[ties].all()


def _perms(rng, B, P):
    return np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32)


def _values(rng, B, P, dtype):
    if dtype == np.float32:  # a gradient, with a NaN, an inf and a -0.0 for the raw bits
        v = rng.randn(B, P).astype(np.float32)
        v.flat[:3] = [np.nan, -np.inf, -0.0][:min(3, v.size)]
        return v
    return rng.randint(-2**31, 2**31, (B, P), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("B,P,dtype", [
    (3, 1024, np.float32), (2, 2 * 67 * 101, np.float32), (4, 1000, np.int32),
    (3, 4097, np.int32), (1, 1, np.float32),
    # the two-pass unsort's bucket edges
    (2, _UNSORT_W - 1, np.float32), (2, _UNSORT_W, np.float32), (2, _UNSORT_W + 1, np.int32),
    (2, 2 * _UNSORT_W + 3, np.float32),
])
def test_unsort_plain_matches_the_jax_unsort_by_sort(B, P, dtype):
    """``unsort_rows_plain`` (and the CPU ``unsort_rows``) equal the JAX
    backward's unsort, ``jax.lax.sort((perm, vals), num_keys=1)[1]`` and
    ``_sort2(perm, vals)[1]`` on float32 positions as the JAX Lovász
    backward calls it, and ``sort_rows_plain(perm, vals)[1]``, bit for
    bit."""
    rng = np.random.RandomState(B * P)
    perm, vals = _perms(rng, B, P), _values(rng, B, P, dtype)
    want = np.asarray(jax.lax.sort((jnp.asarray(perm), jnp.asarray(vals)), num_keys=1)[1])
    pt, vt = torch.from_numpy(perm), torch.from_numpy(vals)
    bits = lambda a: np.asarray(a).view(np.int32)
    np.testing.assert_array_equal(bits(TS.unsort_rows_plain(pt, vt).numpy()), bits(want))
    np.testing.assert_array_equal(bits(TS.unsort_rows(pt, vt).numpy()), bits(want))
    np.testing.assert_array_equal(bits(TS.sort_rows_plain(pt, vt)[1].numpy()), bits(want))
    for b in range(B):
        jax_row = JL._sort2(jnp.asarray(perm[b].astype(np.float32)), jnp.asarray(vals[b]))[1]
        np.testing.assert_array_equal(bits(jax_row), bits(want[b]))


def test_unsort_inverts_the_sort_payload_permutation():
    """The Lovász round trip: sorting keys with an arange payload gives
    ``perm``; unsorting the sorted keys by it gives the keys back."""
    rng = np.random.RandomState(5)
    key = torch.from_numpy(_keys("ties", rng, 4, 3000))
    pos = torch.arange(3000, dtype=torch.int32).expand(4, -1).contiguous()
    key_sorted, perm = TS.sort_rows(key, pos)
    assert torch.equal(TS.unsort_rows(perm, key_sorted), key)


def test_cpu_unsort_takes_the_plain_version_and_rejects_other_devices():
    rng = np.random.RandomState(2)
    perm = torch.from_numpy(_perms(rng, 3, 500))
    vals = torch.from_numpy(rng.randn(3, 500).astype(np.float32))
    TS.unsort_rows.launches = 0
    assert torch.equal(TS.unsort_rows(perm, vals), TS.unsort_rows_plain(perm, vals))
    assert TS.unsort_rows.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        TS.unsort_rows(torch.empty(2, 8, dtype=torch.int32, device="meta"),
                       torch.empty(2, 8, device="meta"))
    assert TS.unsort_rows.launches == 0


def test_build_compiles_the_sort_source_with_plain_c_entry_points(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        _build.build(tmp_path)
    assert "sort_rows.cu" in str(err.value)
    for name in ("ee_sort_rows", "ee_unsort_rows", "ee_sort_aux_words", "ee_unsort_scratch_words",
                 "ee_unsort_window"):
        assert name in _build._SIGNATURES


def test_unsort_window_is_the_library_s(monkeypatch):
    """``unsort_window`` reads the window from the built library (the CUDA
    build needs nvcc, so a stand-in library answers here), and the source
    keeps it a power of two that 16-bit offsets address."""
    class Lib:
        ee_unsort_window = staticmethod(lambda: _UNSORT_W)

    monkeypatch.setattr(_build, "load_library", lambda: Lib)
    assert TS.unsort_window() == _UNSORT_W
    assert _UNSORT_W & (_UNSORT_W - 1) == 0 and 2 <= _UNSORT_W <= 1 << 16


def test_every_declared_entry_point_is_defined_with_as_many_arguments():
    """ctypes passes what ``_SIGNATURES`` declares: each name must be an
    ``extern "C"`` function of ``csrc/*.cu`` with that many parameters."""
    defined = {}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S):
            for name, params in re.findall(r"^\S.*?\b(ee_\w+)\(([^)]*)\)\s*\{", block, re.M | re.S):
                defined[name] = 0 if not params.strip() else params.count(",") + 1
    assert defined, "no extern \"C\" entry point found"
    assert set(defined) == set(_build._SIGNATURES)
    for name, (args, _) in _build._SIGNATURES.items():
        assert defined[name] == len(args), name
