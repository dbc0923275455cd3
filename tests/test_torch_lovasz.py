"""The port's training losses (``ops/lovasz.py``, ``ops/branchy.py``,
``ops/xentropy.py``) against the JAX package and the reference's golden
values, on the CPU.

Value and gradient are held against ``jax.value_and_grad`` of the JAX
functions in float64 on the same numpy inputs, to 1e-10: the Lovász weights
are float32 on both sides, but they come from cumulative sums of 0/1
indicators, which are exact, so the two sides agree to float64 rounding.
The JAX side sorts with ``jax.lax.sort`` (its CPU backend) and unsorts the
gradient with a second sort; the port sorts with ``sort_rows`` and unsorts
with ``unsort_rows``, which take their plain versions for CPU tensors.  The golden
values come from the reference's own torch code in float32, at the JAX
tests' tolerance (rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as FX

from ee_semantic_segmentation_tpu.ops import branchy as JB
from ee_semantic_segmentation_tpu.ops import lovasz as JL
from ee_semantic_segmentation_tpu.ops import xentropy as JX
from ee_semantic_segmentation_tpu_torch.ops import branchy as TB
from ee_semantic_segmentation_tpu_torch.ops import lovasz as TL
from ee_semantic_segmentation_tpu_torch.ops import xentropy as TX
from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as TS

TOL_F64 = 1e-10
GOLDEN_RTOL = 1e-4


def _inputs(seed=0, exits=3, n=2, h=8, w=9, c=5, void_frac=0.15):
    """(E, N, H, W, C) float64 logits and (N, H, W) labels in [0, c] with
    ~void_frac at the void label c."""
    rng = np.random.RandomState(seed)
    x = 3.0 * rng.randn(exits, n, h, w, c)
    labels = rng.randint(0, c, (n, h, w))
    labels[rng.rand(n, h, w) < void_frac] = c
    return x, labels


def _jax_value_and_grad(fn, x, labels):
    with jax.enable_x64(True):
        v, g = jax.value_and_grad(lambda p: fn(p, jnp.asarray(labels)))(jnp.asarray(x))
        return float(v), np.asarray(g)


def _port_value_and_grad(fn, x, labels):
    xt = torch.tensor(x, requires_grad=True)
    v = fn(xt, torch.from_numpy(labels))
    v.backward()
    return float(v.detach()), xt.grad.numpy()


def _assert_f64_match(got, want):
    (gv, gg), (wv, wg) = got, want
    assert abs(gv - wv) <= TOL_F64 * max(abs(wv), 1.0), (gv, wv)
    assert gg.shape == wg.shape
    np.testing.assert_allclose(gg, wg, rtol=0, atol=TOL_F64)


LOVASZ_CASES = {
    "batch": dict(),
    "per_image": dict(per_image=True),
    "ignore": dict(ignore=5),
    "per_image_ignore": dict(per_image=True, ignore=5),
    "all": dict(classes="all", ignore=5),
    "tuple": dict(classes=(0, 2, 4), ignore=5),
    "max_present": dict(max_present=2, ignore=5),
    "max_present_per_image": dict(max_present=2, per_image=True, ignore=5),
    "softmax": dict(apply_softmax=True, ignore=5),
}


@pytest.mark.parametrize("case", list(LOVASZ_CASES))
def test_lovasz_softmax_value_and_grad_match_jax_f64(case):
    kw = LOVASZ_CASES[case]
    x, labels = _inputs(seed=len(case))
    want = _jax_value_and_grad(lambda p, l: JL.lovasz_softmax(p, l, **kw), x[0], labels)
    got = _port_value_and_grad(lambda p, l: TL.lovasz_softmax(p, l, **kw), x[0], labels)
    _assert_f64_match(got, want)


def test_lovasz_softmax_3d_input_matches_jax_f64():
    """(N, H, W) scores are one channel; labels are the 0/1 class ids."""
    x, labels = _inputs(seed=4, c=1)
    want = _jax_value_and_grad(lambda p, l: JL.lovasz_softmax(p, l, ignore=1), x[0, ..., 0], labels)
    got = _port_value_and_grad(lambda p, l: TL.lovasz_softmax(p, l, ignore=1), x[0, ..., 0], labels)
    _assert_f64_match(got, want)


def test_lovasz_softmax_flat_matches_jax_f64():
    rng = np.random.RandomState(9)
    x, labels, valid = rng.randn(60, 4), rng.randint(0, 4, 60), rng.rand(60) > 0.2
    want = _jax_value_and_grad(
        lambda p, l: JL.lovasz_softmax_flat(p, l, valid=jnp.asarray(valid)), x, labels)
    got = _port_value_and_grad(
        lambda p, l: TL.lovasz_softmax_flat(p, l, valid=torch.from_numpy(valid)), x, labels)
    _assert_f64_match(got, want)


def test_lovasz_grad_matches_jax():
    rng = np.random.RandomState(3)
    gt, valid = (rng.rand(4, 50) > 0.5).astype(np.float64), (rng.rand(4, 50) > 0.1).astype(np.float64)
    got = TL.lovasz_grad(torch.from_numpy(gt), torch.from_numpy(valid)).numpy()
    with jax.enable_x64(True):
        for r in range(4):
            want = np.asarray(JL.lovasz_grad(jnp.asarray(gt[r]), jnp.asarray(valid[r])))
            np.testing.assert_allclose(got[r], want, rtol=0, atol=1e-15)


BRANCHY_CASES = {
    "sum": dict(),
    "prev_out": dict(prev_out=True),
    "per_image": dict(per_image=True),
    "max_present": dict(max_present=2),
    "max_present_exact_fallback": dict(max_present=2, exact_fallback=True),
    "max_present_per_image_fallback": dict(max_present=2, per_image=True, exact_fallback=True),
    # K = 5 covers every present class: the fallback keeps the compact path
    "max_present_no_fallback_needed": dict(max_present=4, exact_fallback=True),
}


@pytest.mark.parametrize("case", list(BRANCHY_CASES))
def test_branchy_lovasz_value_and_grad_match_jax_f64(case):
    """Three exits (n_branches=2) of one loss call."""
    kw = BRANCHY_CASES[case]
    x, labels = _inputs(seed=7)
    want = _jax_value_and_grad(JB.LovaszSoftmax(ignore=5, n_branches=2, **kw), x, labels)
    got = _port_value_and_grad(TB.LovaszSoftmax(ignore=5, n_branches=2, **kw), x, labels)
    _assert_f64_match(got, want)


def test_branchy_lovasz_update_n_matches_jax_f64():
    x, labels = _inputs(seed=8)
    j, t = JB.LovaszSoftmax(ignore=5, n_branches=2, prev_out=True), \
        TB.LovaszSoftmax(ignore=5, n_branches=2, prev_out=True)
    j.update_n(1)
    t.update_n(1)
    _assert_f64_match(_port_value_and_grad(t, x, labels), _jax_value_and_grad(j, x, labels))


def test_one_sort_forward_and_one_backward_per_loss_call(monkeypatch):
    """All exits, images and classes of a call share one forward sort (the
    negated errors, float32 keys, int32 payload) and one backward unsort
    (int32 positions, float32 values); the backward sorts nothing."""
    calls = []

    def counting_sort(key, pay):
        calls.append(("sort", tuple(key.shape), key.dtype, pay.dtype))
        return TS.sort_rows_plain(key, pay)

    def counting_unsort(perm, vals):
        calls.append(("unsort", tuple(perm.shape), perm.dtype, vals.dtype))
        return TS.unsort_rows_plain(perm, vals)

    x, labels = _inputs(seed=2)
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    loss = TL._lovasz_exits(xt, torch.from_numpy(labels), per_image=True, ignore=5,
                            sort_kernels=(counting_sort, counting_unsort)).sum()
    rows = (3 * 2 * 5, 8 * 9)
    assert calls == [("sort", rows, torch.float32, torch.int32)]
    loss.backward()
    assert calls == [("sort", rows, torch.float32, torch.int32),
                     ("unsort", rows, torch.int32, torch.float32)]
    assert TL.SORT_KERNELS == (TS.sort_rows, TS.unsort_rows)


@pytest.mark.parametrize("case", ["batch", "per_image_ignore", "max_present"])
def test_unsort_backward_equals_the_jax_unsort_by_sort(case):
    """The backward's scatter gives the gradient that the JAX package's
    second sort on the saved positions gives, bit for bit (float32)."""
    kw = LOVASZ_CASES[case]
    x, labels = _inputs(seed=13)
    grads = []
    for unsort in (TS.unsort_rows_plain, lambda perm, vals: TS.sort_rows_plain(perm, vals)[1]):
        xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
        TL._lovasz_exits(xt, torch.from_numpy(labels), sort_kernels=(TS.sort_rows_plain, unsort),
                         **kw).sum().backward()
        grads.append(xt.grad)
    assert grads[0].abs().sum() > 0
    assert torch.equal(grads[0], grads[1])


# ---------------------------------------------------------------- golden values
def _hand():
    return FX.nchw_to_nhwc(FX.HAND_PRED), FX.HAND_TRUE[:, 0]


def _rand():
    logits, labels = FX.random_logits(seed=0)
    return FX.nchw_to_nhwc(logits), labels


def _absent():
    logits, labels = FX.random_logits_absent()
    return FX.nchw_to_nhwc(logits), labels


GOLDEN_LOVASZ = [
    ("hand/lovasz_present", _hand, dict(classes="present")),
    ("hand/lovasz_all", _hand, dict(classes="all")),
    ("hand/lovasz_per_image", _hand, dict(classes="present", per_image=True)),
    ("rand/lovasz_present_ignore", _rand, dict(classes="present", ignore=21)),
    ("rand/lovasz_all_ignore", _rand, dict(classes="all", ignore=21)),
    ("rand/lovasz_present_per_image_ignore", _rand,
     dict(classes="present", per_image=True, ignore=21)),
    ("absent/lovasz_present_ignore", _absent, dict(classes="present", ignore=6)),
    ("absent/lovasz_all_ignore", _absent, dict(classes="all", ignore=6)),
    ("absent/lovasz_list", _absent, dict(classes=(0, 1, 2), ignore=6)),
]


@pytest.mark.parametrize("key,make,kw", GOLDEN_LOVASZ, ids=[g[0] for g in GOLDEN_LOVASZ])
def test_lovasz_softmax_golden(golden, key, make, kw):
    pred, true = make()
    got = TL.lovasz_softmax(torch.from_numpy(pred), torch.from_numpy(true), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), golden[key], rtol=GOLDEN_RTOL, atol=1e-5)


def _exits():
    logits, labels = FX.random_logits(seed=3, exits=4, n=2, c=21, h=8, w=9)
    return torch.from_numpy(FX.nchw_to_nhwc(logits)), torch.from_numpy(labels)


@pytest.mark.parametrize("key,kw", [("exit/br_lovasz_sum", {}),
                                    ("exit/br_lovasz_prev_out", dict(prev_out=True))])
def test_branchy_lovasz_golden(golden, key, kw):
    got = TB.LovaszSoftmax(classes="present", ignore=21, n_branches=3, **kw)(*_exits())
    np.testing.assert_allclose(float(got), golden[key], rtol=GOLDEN_RTOL, atol=1e-5)


# ---------------------------------------------------------------- cross-entropy
@pytest.mark.parametrize("key,kw", [
    ("exit/br_xent_sum", dict(b_reduction="sum", n_exits=4)),
    ("exit/br_xent_weighted_mean", dict(b_reduction="mean", n_exits=4,
                                        weights=[0.25, 0.5, 0.75, 1.0])),
])
def test_branchy_xent_golden(golden, key, kw):
    got = TX.BrXEntropyLoss(ignore_index=21, **kw)(*_exits())
    np.testing.assert_allclose(float(got), golden[key], rtol=GOLDEN_RTOL, atol=1e-5)


@pytest.mark.parametrize("key,reduction", [("rand/ce_ignore_mean", "mean"),
                                           ("rand/ce_ignore_sum", "sum")])
def test_cross_entropy_golden(golden, key, reduction):
    pred, true = _rand()
    got = TX.cross_entropy(torch.from_numpy(pred), torch.from_numpy(true), ignore_index=21,
                           reduction=reduction)
    np.testing.assert_allclose(float(got), golden[key], rtol=GOLDEN_RTOL, atol=1e-5)


XENT_CASES = {
    "sum": dict(b_reduction="sum", n_exits=3),
    "mean_weighted": dict(b_reduction="mean", n_exits=3, weights=[0.5, 1.0, 2.0]),
    "inner_sum": dict(reduction="sum", b_reduction="sum", n_exits=3),
    "single_exit": dict(n_exits=0),
}


@pytest.mark.parametrize("case", list(XENT_CASES))
def test_branchy_xent_value_and_grad_match_jax_f64(case):
    kw = XENT_CASES[case]
    x, labels = _inputs(seed=11)
    if not kw["n_exits"]:
        x = x[0]
    want = _jax_value_and_grad(JX.BrXEntropyLoss(ignore_index=5, **kw), x, labels)
    got = _port_value_and_grad(TX.BrXEntropyLoss(ignore_index=5, **kw), x, labels)
    _assert_f64_match(got, want)


def test_cross_entropy_per_pixel_map_matches_jax():
    x, labels = _inputs(seed=12)
    got = TX.cross_entropy(torch.from_numpy(x[0]), torch.from_numpy(labels), 5, None).numpy()
    with jax.enable_x64(True):
        want = np.asarray(JX.cross_entropy(jnp.asarray(x[0]), jnp.asarray(labels), 5, None))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
