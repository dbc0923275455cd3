"""Kernel D's wrapper and plain version (``ops/kernels/sort.py``) against the
JAX package's sort (``ops/pallas/sort_kernel.sort_pallas`` in interpret
mode, and ``jax.lax.sort``), on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` phase 3b).
Here the wrapper takes its plain version because the tensors lie on the
CPU.  A bitonic sort is unstable, so where keys tie, rows are compared as
(key, payload) pairs in lexicographic order, as ``tests/test_sort_kernel.py``
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ee_semantic_segmentation_tpu.ops.pallas.sort_kernel as SK
from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as TS


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
    assert TS.KERNELS == (TS.sort_rows,)


def test_wrapper_rejects_a_tensor_that_is_neither_on_the_cpu_nor_on_cuda():
    key = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TS.sort_rows(key, torch.empty(2, 8, dtype=torch.int32, device="meta"))
    assert TS.sort_rows.launches == 0
