"""Kernels E and F's plain versions (``ops/kernels/hist.py``) and the
histogram Lovász (``ops/lovasz.py`` ``hist_bins``, the training CLI's
``-G``) against the JAX package, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 3c); here
the wrappers take their plain versions because the tensors lie on the CPU.
All comparisons are in float32, the JAX path's own type (its histograms are
float32 whatever the input).  The bucket ids come from the same float32
expression on both sides, so the counts agree exactly; the error sums and
the loss agree to float32 rounding of a reordered sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee_semantic_segmentation_tpu.ops import branchy as JB
from ee_semantic_segmentation_tpu.ops import lovasz as JL
from ee_semantic_segmentation_tpu.ops.pallas import hist_kernel as JH
from ee_semantic_segmentation_tpu_torch.ops import branchy as TB
from ee_semantic_segmentation_tpu_torch.ops import lovasz as TL
from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
from ee_semantic_segmentation_tpu_torch.ops.kernels import hist as TH

SUM_RTOL = 1e-6     # error sums vs the JAX scatter: one float32 rounding per term,
#                     adds in another order
PALLAS_RTOL = 1e-5  # vs the JAX Pallas kernel (interpret): its sums are MXU dots
LOSS_RTOL = 1e-6    # loss: float32 dot products in another order
GRAD_ATOL = 1e-8    # gradient: equal tables (exact counts), float32 chain


def _rows(R, P, bins, seed=0, void=0.1):
    """(R, P) float32 errors with void slots at -1e30, bool fg, and the
    rows' (emax, inv_w) as the loss computes them."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(R, P) > void
    fg = (rng.rand(R, P) < 0.3) & valid
    pred = (3 * rng.randn(R, P)).astype(np.float32)
    errors = np.where(valid, np.abs(fg - pred), -1e30).astype(np.float32)
    emax, inv_w = TL._hist_prepass(torch.from_numpy(errors), torch.from_numpy(valid), bins)
    return errors, fg, valid, emax.numpy(), inv_w.numpy()


def _jax_args(errors, fg, emax, inv_w):
    return (jnp.asarray(errors), jnp.asarray(fg.astype(np.float32)), jnp.asarray(emax),
            jnp.asarray(inv_w))


def _port_args(errors, fg, emax, inv_w):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (errors, fg, emax, inv_w))


def _assert_hist_close(got, want, rtol):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :2], want[:, :2])  # counts: exact
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=rtol, atol=0)


@pytest.mark.parametrize("R,P,bins", [(3, 1000, 128), (2, 5000, 256), (3, 2 * 67 * 11, 128)])
def test_hist_plain_matches_jax_scatter(R, P, bins):
    errors, fg, _, emax, inv_w = _rows(R, P, bins, seed=P)
    want = np.asarray(JH.hist2d_weighted_jnp(*_jax_args(errors, fg, emax, inv_w), bins=bins))
    got = TH.hist2d_weighted(*_port_args(errors, fg, emax, inv_w), bins=bins).numpy()
    _assert_hist_close(got, want, SUM_RTOL)


@pytest.mark.parametrize("R,P,bins", [(2, 5000, 128), (3, 3000, 256)])
def test_hist_plain_matches_jax_pallas_interpret(R, P, bins):
    """Several 4096-pixel chunks, the last one ragged."""
    errors, fg, _, emax, inv_w = _rows(R, P, bins, seed=R)
    want = np.asarray(JH.hist2d_weighted_pallas(*_jax_args(errors, fg, emax, inv_w), bins=bins,
                                                interpret=True))
    got = TH.hist2d_weighted(*_port_args(errors, fg, emax, inv_w), bins=bins).numpy()
    _assert_hist_close(got, want, PALLAS_RTOL)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("bins", [128, 256])
def test_lookup_plain_matches_jax(pallas, bins):
    """Bit for bit against the JAX gather; the Pallas kernel's one-hot
    product (interpret) moves each table entry unchanged too."""
    errors, fg, _, emax, inv_w = _rows(3, 4500, bins, seed=bins)
    tables = np.random.RandomState(1).randn(3, 2, bins).astype(np.float32)
    args = _jax_args(errors, fg, emax, inv_w) + (jnp.asarray(tables),)
    if pallas:
        want = np.asarray(JH.table_lookup_pallas(*args, bins=bins, interpret=True))
    else:
        want = np.asarray(JH.table_lookup_jnp(*args, bins=bins))
    got = TH.table_lookup(*_port_args(errors, fg, emax, inv_w), torch.from_numpy(tables),
                          bins=bins).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_all_void_and_all_tied_rows():
    """An all-void row: zero histograms, zero weights, emax = inv_w = 0.  An
    all-tied row: every pixel in bucket 0 (range 0 takes the 1e-12 floor)."""
    P, bins = 700, 128
    errors = np.full((2, P), -1e30, np.float32)
    errors[1] = 0.5
    valid = errors > -1e29
    fg = valid & (np.arange(P) % 3 == 0)
    emax, inv_w = TL._hist_prepass(torch.from_numpy(errors), torch.from_numpy(valid), bins)
    assert emax[0] == 0 and inv_w[0] == 0
    args = _port_args(errors, fg, emax.numpy(), inv_w.numpy())
    h = TH.hist2d_weighted(*args, bins=bins)
    assert not h[0].any()
    assert h[1, 0, 0] == P and h[1, 1, 0] == fg[1].sum() and h[1, 2, 0] == 0.5 * P
    assert not h[1, :, 1:].any()
    w = TH.table_lookup(*args, torch.ones(2, 2, bins), bins=bins)
    assert not w[0].any() and bool((w[1] == 1).all())


# ---------------------------------------------------------------- the loss
def _inputs(seed=0, exits=3, n=2, h=8, w=9, c=5, void_frac=0.15):
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(exits, n, h, w, c)).astype(np.float32)
    labels = rng.randint(0, c, (n, h, w))
    labels[rng.rand(n, h, w) < void_frac] = c
    return x, labels


def _value_and_grad_jax(fn, x, labels):
    import jax

    v, g = jax.value_and_grad(lambda p: fn(p, jnp.asarray(labels)))(jnp.asarray(x))
    return float(v), np.asarray(g)


def _value_and_grad_port(fn, x, labels):
    xt = torch.tensor(x, requires_grad=True)
    v = fn(xt, torch.from_numpy(labels))
    v.backward()
    return float(v.detach()), xt.grad.numpy()


def _assert_match(got, want):
    (gv, gg), (wv, wg) = got, want
    assert gv == pytest.approx(wv, rel=LOSS_RTOL)
    assert gg.shape == wg.shape
    np.testing.assert_allclose(gg, wg, rtol=0, atol=GRAD_ATOL)


LOSS_CASES = {
    "batch": dict(hist_bins=128),
    "per_image": dict(hist_bins=128, per_image=True),
    "ignore": dict(hist_bins=256, ignore=5),
    "per_image_ignore": dict(hist_bins=128, per_image=True, ignore=5),
    "all": dict(hist_bins=128, classes="all", ignore=5),
    "max_present": dict(hist_bins=128, max_present=2, ignore=5),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_hist_lovasz_softmax_value_and_grad_match_jax(case):
    kw = LOSS_CASES[case]
    x, labels = _inputs(seed=len(case))
    want = _value_and_grad_jax(lambda p, l: JL.lovasz_softmax(p, l, **kw), x[0], labels)
    got = _value_and_grad_port(lambda p, l: TL.lovasz_softmax(p, l, **kw), x[0], labels)
    _assert_match(got, want)


BRANCHY_CASES = {
    "sum": dict(),
    "per_image": dict(per_image=True),                                  # -P
    "max_present": dict(max_present=2),                                 # -K
    "max_present_exact_fallback": dict(max_present=2, exact_fallback=True),  # -K -X
    "prev_out": dict(prev_out=True, per_image=True),
}


@pytest.mark.parametrize("case", list(BRANCHY_CASES))
def test_branchy_hist_lovasz_value_and_grad_match_jax(case):
    """Three exits (n_branches=2) of one loss call, -G 128."""
    kw = dict(BRANCHY_CASES[case], hist_bins=128)
    x, labels = _inputs(seed=7)
    want = _value_and_grad_jax(JB.LovaszSoftmax(ignore=5, n_branches=2, **kw), x, labels)
    got = _value_and_grad_port(TB.LovaszSoftmax(ignore=5, n_branches=2, **kw), x, labels)
    _assert_match(got, want)


@pytest.mark.parametrize("P,bins,seed", [(1000, 128, 0), (5000, 256, 1), (4096, 128, 2)])
def test_hist_loss_within_the_analytic_bound_of_the_exact_loss(P, bins, seed):
    """|hist - exact| <= (max error - min error) / bins per row, against the
    port's own sorted loss."""
    errors, fg, valid, _, _ = _rows(3, P, bins, seed=seed)
    e, f, v = (torch.from_numpy(a) for a in (errors, fg, valid))
    exact = TL._ClassLoss.apply(e, f, v, TL.sort_rows)
    hist = TL._HistClassLoss.apply(e, f, v, bins, *TL.HIST_KERNELS)
    for r in range(3):
        ev = errors[r][valid[r]]
        assert abs(float(hist[r]) - float(exact[r])) <= (ev.max() - ev.min()) / bins + 1e-6


def test_all_void_row_gives_zero_loss_and_a_finite_gradient():
    errors = torch.full((2, 512), -1e30, requires_grad=True)
    fg = torch.zeros(2, 512, dtype=torch.bool)
    loss = TL._HistClassLoss.apply(errors, fg, errors.detach() > -1e29, 128, *TL.HIST_KERNELS)
    assert loss.tolist() == [0.0, 0.0]
    loss.sum().backward()
    assert torch.isfinite(errors.grad).all() and not errors.grad.any()


def test_one_histogram_forward_and_one_lookup_backward_per_loss_call():
    """All exits, images and classes of a call share one E launch forward
    and one F launch backward, and nothing is sorted."""
    calls = []

    def counting(fn):
        def wrapped(errors, *args, bins):
            calls.append((fn.__name__, tuple(errors.shape), errors.dtype))
            return fn(errors, *args, bins=bins)
        return wrapped

    def no_sort(key, pay):
        raise AssertionError("the histogram Lovász sorted")

    x, labels = _inputs(seed=2)
    xt = torch.tensor(x, requires_grad=True)
    loss = TL._lovasz_exits(xt, torch.from_numpy(labels), per_image=True, ignore=5,
                            hist_bins=128, sort=no_sort,
                            hist_kernels=(counting(TH.hist2d_weighted_plain),
                                          counting(TH.table_lookup_plain))).sum()
    rows = ((3 * 2 * 5, 8 * 9), torch.float32)
    assert calls == [("hist2d_weighted_plain",) + rows]
    loss.backward()
    assert calls == [("hist2d_weighted_plain",) + rows, ("table_lookup_plain",) + rows]


@pytest.mark.parametrize("bins", [0, 64, 100, 384, 1000])
def test_bad_bins_raise_the_jax_message(bins):
    x, labels = _inputs(seed=1)
    assert not TH.hist_bins_ok(bins) and not JH.hist_bins_ok(bins)
    with pytest.raises(ValueError, match="must be 128 \\* a power of two"):
        TL.lovasz_softmax(torch.from_numpy(x[0]), torch.from_numpy(labels), hist_bins=bins)
    with pytest.raises(ValueError, match="128 \\* a power of two"):
        TH.hist2d_weighted(torch.zeros(1, 4), torch.zeros(1, 4, dtype=torch.bool),
                           torch.zeros(1), torch.zeros(1), bins=bins)


@pytest.mark.parametrize("bins", [128, 256, 1024, 8192, 16384])
def test_hist_bins_ok_matches_jax(bins):
    assert TH.hist_bins_ok(bins) and JH.hist_bins_ok(bins)


# ---------------------------------------------------------------- wrappers
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    errors, fg, _, emax, inv_w = _rows(2, 300, 128)
    args = _port_args(errors, fg, emax, inv_w)
    tables = torch.randn(2, 2, 128)
    for k in TH.KERNELS:
        k.launches = 0
    assert torch.equal(TH.hist2d_weighted(*args, bins=128),
                       TH.hist2d_weighted_plain(*args, bins=128))
    assert torch.equal(TH.table_lookup(*args, tables, bins=128),
                       TH.table_lookup_plain(*args, tables, bins=128))
    assert [k.launches for k in TH.KERNELS] == [0, 0]
    assert TH.KERNELS == (TH.hist2d_weighted, TH.table_lookup)


def test_wrappers_reject_a_tensor_that_is_neither_on_the_cpu_nor_on_cuda():
    e = torch.empty(2, 8, device="meta")
    fg = torch.empty(2, 8, dtype=torch.bool, device="meta")
    r = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TH.hist2d_weighted(e, fg, r, r, bins=128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TH.table_lookup(e, fg, r, r, torch.empty(2, 2, 128, device="meta"), bins=128)
    assert [k.launches for k in TH.KERNELS] == [0, 0]


def test_build_compiles_the_hist_source_with_plain_c_entry_points(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        _build.build(tmp_path)
    assert "hist_lovasz.cu" in str(err.value)
    for name in ("ee_hist2d_weighted", "ee_table_lookup", "ee_hist_max_bins"):
        assert name in _build._SIGNATURES
