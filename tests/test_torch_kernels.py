"""The PyTorch port's eval-head kernels, metrics and gate against the JAX package.

On the CPU the kernel wrappers of ``ee_semantic_segmentation_tpu_torch``
take their plain versions (the CUDA kernels themselves are held against
those plain versions on the card by ``chip_smoke.py``).  Here the plain
versions are held against the JAX package's Pallas kernels, which JAX runs
in interpret mode off the TPU, on the same numpy inputs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from ee_semantic_segmentation_tpu.ops import gating as jgating
from ee_semantic_segmentation_tpu.ops import metrics as jmetrics
from ee_semantic_segmentation_tpu_torch.ops import gating as tgating
from ee_semantic_segmentation_tpu_torch.ops import metrics as tmetrics
from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
from ee_semantic_segmentation_tpu_torch.ops.kernels import upsample_argmax as TU

# the JAX package's ops/pallas/__init__ re-exports functions under the
# submodule's name, so fetch the module itself
JU = importlib.import_module("ee_semantic_segmentation_tpu.ops.pallas.upsample_argmax")


@pytest.mark.parametrize("n_in,n_out", [(8, 32), (8, 13), (5, 17), (64, 512), (16, 16)])
def test_resize_matrix_is_the_jax_one(n_in, n_out):
    # a copy: bit-identical weights, so the kernels use the JAX kernel's taps
    np.testing.assert_array_equal(TU._resize_matrix_np(n_in, n_out),
                                  JU._resize_matrix_np(n_in, n_out))


@pytest.mark.parametrize("n_in,n_out", [(8, 32), (8, 13), (5, 17), (9, 67), (13, 101), (16, 16)])
def test_taps_rebuild_the_weight_matrix(n_in, n_out):
    """The kernels' two-tap tables hold exactly the matrix's nonzeros."""
    idx, w = TU._taps_np(n_in, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.arange(n_out)[:, None], idx), w)
    np.testing.assert_array_equal(m, TU._resize_matrix_np(n_in, n_out))


@pytest.mark.parametrize("hw,out_hw", [((8, 5), (13, 17)), ((5, 8), (17, 13)), ((8, 8), (32, 32))])
def test_interpolate_equals_weight_matrix_resize(hw, out_hw):
    """F.interpolate(bilinear, align_corners=False) — the plain head's
    upsample — equals the weight-matrix resize at non-integer scales.
    Tolerance 1e-5 absolute on O(1) values: float association only."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, *hw, 4).astype(np.float32))
    want = TU._upsample_plain(x, out_hw)
    got = Fn.interpolate(x.permute(0, 3, 1, 2), size=out_hw, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


CASES = [((2, 8, 12, 5), (32, 48), 1), ((3, 4, 4, 21), (32, 32), 3)]


@pytest.mark.parametrize("shape,out_hw,count", CASES)
def test_confusion_plain_matches_jax_kernel(shape, out_hw, count):
    """upsample_argmax_confusion: exactly equal counts (void labels and the
    count mask included); tie-free continuous logits give identical argmaxes."""
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32)
    C = shape[-1]
    labels = rng.randint(0, C + 1, (shape[0], *out_hw)).astype(np.int32)
    want = np.asarray(JU.upsample_argmax_confusion(jnp.asarray(x), jnp.asarray(labels),
                                                   count, out_hw))
    got = TU.upsample_argmax_confusion(torch.from_numpy(x), torch.from_numpy(labels),
                                       count, out_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, C)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,out_hw,count", CASES)
def test_entropy_plain_matches_jax_kernel(shape, out_hw, count):
    """upsample_entropy_argmax: equal label maps; entropy to rtol 1e-5 (the
    JAX kernel's online softmax vs softmax-then-log, both in f32)."""
    x = (2 * np.random.RandomState(4).randn(*shape)).astype(np.float32)
    want_maps, want_ent = JU.upsample_entropy_argmax(jnp.asarray(x), out_hw)
    maps, ent = TU.upsample_entropy_argmax(torch.from_numpy(x), out_hw)
    assert maps.dtype == torch.int32 and ent.dtype == torch.float32
    np.testing.assert_array_equal(maps.numpy(), np.asarray(want_maps))
    np.testing.assert_allclose(ent.numpy(), np.asarray(want_ent), rtol=1e-5, atol=0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = [k.launches for k in TU.KERNELS]
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 4, 3).astype(np.float32))
    labels = torch.zeros((2, 8, 8), dtype=torch.int32)
    TU.upsample_argmax_confusion(x, labels, 2, (8, 8))
    TU.upsample_entropy_argmax(x, (8, 8))
    TU.upsample_argmax(x, (8, 8))
    assert [k.launches for k in TU.KERNELS] == before == [0, 0, 0]


def test_wrappers_reject_other_devices_and_one_class():
    x = torch.empty((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TU.upsample_entropy_argmax(x, (8, 8))
    with pytest.raises(ValueError, match="n_classes >= 2"):
        TU.upsample_entropy_argmax(torch.zeros((1, 4, 4, 1)), (8, 8))


def test_build_raises_naming_the_command_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        _build.build(tmp_path)
    assert "arch=compute_90a,code=sm_90a" in str(err.value)
    assert "upsample_heads.cu" in str(err.value)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("as_logits", [True, False])
def test_confusion_counts_match_jax(as_logits):
    """bincount counts == the JAX one-hot counts, exactly, with void (C)
    and negative labels (both match no class)."""
    rng = np.random.RandomState(2)
    C = 6
    labels = rng.randint(-1, C + 2, (3, 9, 7)).astype(np.int32)
    if as_logits:
        pred = rng.randn(3, 9, 7, C).astype(np.float32)
    else:
        pred = rng.randint(0, C, (3, 9, 7)).astype(np.int32)
    want = jmetrics.confusion_counts(jnp.asarray(pred), jnp.asarray(labels), C)
    got = tmetrics.confusion_counts(torch.from_numpy(pred), torch.from_numpy(labels), C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tmetrics.confusion_update(torch.from_numpy(pred), torch.from_numpy(labels), C).numpy(),
        np.asarray(jmetrics.confusion_update(jnp.asarray(pred), jnp.asarray(labels), C)))


@pytest.mark.parametrize("policy", ["nan", "one", "skip"])
def test_miou_accumulator_matches_jax(policy):
    rng = np.random.RandomState(8)
    C = 7  # more classes than present, so the empty-class policy matters
    pred = rng.randint(0, 4, (2, 6, 6)).astype(np.int32)
    labels = rng.randint(0, 5, (2, 6, 6)).astype(np.int32)
    a, b = tmetrics.mIoU(C, policy), jmetrics.mIoU(C, policy)
    a(torch.from_numpy(pred), torch.from_numpy(labels))
    b(jnp.asarray(pred), jnp.asarray(labels))
    np.testing.assert_array_equal(a.accumulator, b.accumulator)
    assert a.compute() == pytest.approx(b.compute(), rel=1e-12, nan_ok=True)


@pytest.mark.parametrize("pool,size", [("none", 1), ("max", 3), ("min", 3), ("min", 1)])
def test_batched_norm_entropy_matches_jax(pool, size):
    """Including skimage's cval=0 edge padding (10 is not a multiple of 3).
    rtol 1e-5: f32 softmax/log in both frameworks."""
    x = (2 * np.random.RandomState(5).randn(2, 3, 10, 10, 4)).astype(np.float32)
    want = np.asarray(jgating.batched_norm_entropy(jnp.asarray(x), 4, pool, size))
    got = tgating.batched_norm_entropy(torch.from_numpy(x), 4, pool, size)
    assert tuple(got.shape) == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_pixel_entropy_handles_zero_probabilities():
    p = np.array([[1.0, 0.0, 0.0], [0.5, 0.5, 0.0], [1 / 3, 1 / 3, 1 / 3]], np.float32)
    want = np.asarray(jgating.pixel_entropy(jnp.asarray(p), 3))
    got = tgating.pixel_entropy(torch.from_numpy(p), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
