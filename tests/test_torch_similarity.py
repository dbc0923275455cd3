"""The similarity-gated evaluation of the port against the JAX package, on
the CPU: kernel C's plain version (``upsample_argmax``), the similarity
metrics of ``ops/gating.py``, the per-image mIoU of ``ops/metrics.py``, the
evaluators ``br_evaluator_similarity(_fused)`` and the CLIs ``eval_br_sim``
and ``eval_br_images``.

The CUDA kernel runs only on the card (``chip_smoke.py`` phases 3 and 4);
here the wrapper takes its plain version because the tensors lie on the
CPU.  Evaluators run a two-branch tiny model (and the conftest one-branch
``tiny_model``) with the JAX model's weights carried across by
``models/from_jax.load_flax_variables``; each gate's tau sits in the widest
gap between the exits' similarities, so that a float32 rounding cannot move
an image across it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee_semantic_segmentation_tpu.ops import gating as JG
from ee_semantic_segmentation_tpu.ops import metrics as JM
from ee_semantic_segmentation_tpu_torch.ops import gating as TG
from ee_semantic_segmentation_tpu_torch.ops import metrics as TM
from ee_semantic_segmentation_tpu_torch.ops.kernels import upsample_argmax as TU
from test_torch_port import _assert_same_result, _perturbed_variables, _port_model

JU = importlib.import_module("ee_semantic_segmentation_tpu.ops.pallas.upsample_argmax")
METRICS = ("ssim", "mse", "nmi", "vi", "h_xy", "h_yx")
SIM_RTOL, SIM_ATOL = 1e-5, 1e-6  # float32 means and logs taken in another order
N_CLASSES = 5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- kernel C
@pytest.mark.parametrize("shape,out_hw", [((2, 8, 12, 5), (32, 48)), ((3, 4, 4, 21), (32, 32)),
                                          ((2, 5, 7, 3), (17, 13)), ((2, 8, 8, 4), (8, 8))])
def test_upsample_argmax_plain_matches_jax_kernel_and_reference(shape, out_hw):
    """Equal label maps: the JAX Pallas kernel (interpret mode) and its
    jax.image.resize reference; tie-free continuous logits.  (8, 8) -> (8,
    8) is the no-resize contract: the argmax itself."""
    x = (2 * np.random.RandomState(sum(shape)).randn(*shape)).astype(np.float32)
    got = TU.upsample_argmax(torch.from_numpy(x), out_hw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (shape[0], *out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JU.upsample_argmax(jnp.asarray(x), out_hw)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JU.upsample_argmax_reference(jnp.asarray(x), out_hw)))
    np.testing.assert_array_equal(TU.upsample_argmax_plain(torch.from_numpy(x), out_hw).numpy(),
                                  got.numpy())


# ---------------------------------------------------------------- metrics
def _maps(seed=0, E=3, N=2, H=20, W=23, C=6):
    """(E, N, H, W) int32 label maps; consecutive exits agree on ~70 %."""
    rng = np.random.RandomState(seed)
    preds = rng.randint(0, C, (E, N, H, W)).astype(np.int32)
    for e in range(1, E):
        preds[e] = np.where(rng.rand(N, H, W) < 0.7, preds[e - 1], preds[e])
    return preds


@pytest.mark.parametrize("metric", METRICS)
def test_batched_similarity_matches_jax(metric):
    preds = _maps(seed=len(metric))
    want = np.asarray(JG.batched_similarity(jnp.asarray(preds), metric, 6, (5,)))
    got = TG.batched_similarity(torch.from_numpy(preds), metric, 6, (5,))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=SIM_RTOL, atol=SIM_ATOL)


@pytest.mark.parametrize("metric", ["vi", "h_xy", "h_yx"])
def test_ignore_labels_of_the_first_map_drop_pixels(metric):
    """skimage's ignore_labels semantics, several ignored labels, and a map
    that is all ignored (empty joint histogram: the sum floor of 1)."""
    preds = _maps(seed=3)
    preds[0, 1] = 2
    for ignore in ((2,), (2, 4)):
        want = np.asarray(JG.batched_similarity(jnp.asarray(preds), metric, 6, ignore))
        got = TG.batched_similarity(torch.from_numpy(preds), metric, 6, ignore)
        np.testing.assert_allclose(got.numpy(), want, rtol=SIM_RTOL, atol=SIM_ATOL)


def test_similarity_dispatch_matches_the_functions():
    a, b = (torch.from_numpy(m) for m in _maps(seed=5)[:2])
    assert torch.equal(TG.similarity(a, b, "SSIM", 6), TG.ssim_int(a, b, 5))
    assert torch.equal(TG.similarity(a, b, "mse", 6), TG.mse_int(a, b))
    assert torch.equal(TG.similarity(a, b, "nmi", 6), TG.nmi(a, b, 6))
    assert torch.equal(TG.similarity(a, b, "h_yx", 6), TG.seg_comp(a, b, 6, x_y=False))
    assert TG.SIM_GREATER == JG.SIM_GREATER


def test_ssim_window_sums_are_exact_integers():
    """The 7x7 window sums of integer maps (values up to 441, as a² is at 21
    classes) equal an int64 numpy brute force."""
    x = np.random.RandomState(2).randint(0, 442, (2, 30, 35)).astype(np.int32)
    got = TG._window_sums(torch.from_numpy(x), 7).numpy()
    want = np.zeros((2, 24, 29), np.int64)
    for i in range(7):
        for j in range(7):
            want += x[:, i:i + 24, j:j + 29]
    np.testing.assert_array_equal(got, want)


def test_joint_hist_matches_jax_one_hot_product():
    """Counts of (a, b) pairs; labels outside [0, n) and dropped pixels
    count nowhere."""
    rng = np.random.RandomState(4)
    a, b = rng.randint(-1, 7, (2, 9, 11)), rng.randint(0, 8, (2, 9, 11))
    keep = rng.rand(2, 9, 11) > 0.3
    got = TG._joint_hist(torch.from_numpy(a), torch.from_numpy(b), 6, torch.from_numpy(keep))
    for i in range(2):
        want = JG._joint_hist(jnp.asarray(a[i].ravel()), jnp.asarray(b[i].ravel()), 6,
                              weights=jnp.asarray(keep[i].ravel().astype(np.float32)))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_img_miou_matches_jax():
    """Per image over ``num_classes`` = 22 (VOC's void 21 is a class), with
    out-of-range predictions and labels (255) belonging to no class."""
    rng = np.random.RandomState(6)
    pred = rng.randint(0, 23, (5, 400))
    tgt = rng.randint(0, 22, (5, 400))
    tgt[:, :20] = 255
    got = TM._img_miou_one(torch.from_numpy(pred), torch.from_numpy(tgt), 22)
    want = [float(JM._img_miou_one(jnp.asarray(pred[i]), jnp.asarray(tgt[i]), 22))
            for i in range(5)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    a, b = TM.img_mIoU(22), JM.img_mIoU(22)
    for i in range(2):
        a(torch.from_numpy(pred[i].reshape(20, 20)), torch.from_numpy(tgt[i].reshape(20, 20)))
        b(jnp.asarray(pred[i].reshape(20, 20)), jnp.asarray(tgt[i].reshape(20, 20)))
    a.add_score(0.25, 2)
    b.add_score(0.25, 2)
    assert a.count == b.count == 4
    assert a.compute() == pytest.approx(b.compute(), rel=1e-6)
    assert np.isnan(TM.img_mIoU().compute())


# ---------------------------------------------------------------- evaluators
@pytest.fixture(scope="module")
def two_branch():
    """(JAX model, its state with perturbed variables, the port model) of a
    two-branch tiny model: exits after blocks 3 and 7, 5 classes, 32 px."""
    from ee_semantic_segmentation_tpu.models.branchy_deepv3 import (
        BranchyConfig,
        BranchyDeepLabV3,
    )
    from ee_semantic_segmentation_tpu.parallel import create_train_state
    from ee_semantic_segmentation_tpu.train.optim import sgd_momentum

    cfg = BranchyConfig(backbone_depth=50, img_dim=32, n_branches=2, segment_ends=(3, 7),
                        branch_channels=(256, 512), num_classes=N_CLASSES)
    model = BranchyDeepLabV3(config=cfg)
    state = create_train_state(model, sgd_momentum(), jax.random.PRNGKey(3),
                               jnp.zeros((4, 32, 32, 3)))
    variables = _perturbed_variables(state, seed=1)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    return model, state, _port_model(model, variables)


def _batches():
    rng = np.random.RandomState(11)
    batches = [{"image": rng.rand(4, 32, 32, 3).astype(np.float32),
                "label": rng.randint(0, N_CLASSES + 1, (4, 32, 32)).astype(np.int32)}
               for _ in range(2)]
    batches[1]["count"] = 3  # padded tail row, masked out of every count
    return batches


def _split_tau(port, metric):
    """A tau in the widest gap between the exit-0/exit-1 similarities of the
    7 valid images (port plain head)."""
    with torch.inference_mode():
        sims = sorted(
            v for b in _batches()
            for v in TG.batched_similarity(port(torch.from_numpy(b["image"]))[:2].argmax(-1),
                                           metric, N_CLASSES, (N_CLASSES - 1,))[0]
            .tolist()[:b.get("count", 4)])
    gap, i = max((sims[j + 1] - sims[j], j) for j in range(len(sims) - 1))
    assert gap > 1e-3, sims
    return (sims[i] + sims[i + 1]) / 2


SIM_EVAL_CASES = {  # each case compiles the JAX evaluator anew: few of them
    "ssim_plain": ("ssim", False, 0),
    "ssim_kernel": ("ssim", True, 0),
    "nmi_kernel": ("nmi", True, 0),
    "mse_plain": ("mse", False, 0),            # fires on sim < tau
    "h_yx_kernel_skip": ("h_yx", True, 1),     # skip 1: no gate position is left
}


@pytest.mark.parametrize("case", list(SIM_EVAL_CASES))
def test_similarity_evaluator_matches_jax(two_branch, case):
    from ee_semantic_segmentation_tpu.ee import batch_eval as JE
    from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE

    metric, kernel_head, skip = SIM_EVAL_CASES[case]
    model, state, port = two_branch
    tau = _split_tau(port, metric)
    kw = dict(ignore=(N_CLASSES - 1,), skip=skip, pallas_head=kernel_head)
    want = JE.br_evaluator_similarity_fused(model, state, 3, N_CLASSES, _batches(), metric,
                                            tau, **kw)
    got = TE.br_evaluator_similarity_fused(port, 3, N_CLASSES, _batches(), metric, tau, **kw)
    _assert_same_result(got, want)
    assert got["b1_count"] == 0 and got["b2_count"] + got["count_out"] == got["out_gl"] == 7
    assert (got["b2_count"] == 0) == (skip > 0)


@pytest.mark.parametrize("metric,skip", [("nmi", 0), ("vi", 1)])
def test_image_level_similarity_evaluator_matches_jax(two_branch, metric, skip):
    """eval_br_images: per-image mIoU accumulators of the chosen exits."""
    from ee_semantic_segmentation_tpu.ee import batch_eval as JE
    from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE

    model, state, port = two_branch
    tau = _split_tau(port, metric)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    forward = jax.jit(lambda x: model.apply(variables, x, train=False))
    kw = dict(ignore=(N_CLASSES - 1,), skip=skip)
    want = JE.br_evaluator_similarity(lambda x: forward(jnp.asarray(x)), 3, N_CLASSES,
                                      _batches(), metric, tau, image_level=True, **kw)
    got = TE.br_evaluator_similarity(port, 3, N_CLASSES, _batches(), metric, tau,
                                     image_level=True, **kw)
    _assert_same_result(got, want)
    assert got["b2_count"] + got["count_out"] == got["out_gl"] == 7


def test_plain_similarity_evaluator_is_the_fused_one_with_the_plain_head(two_branch):
    from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE

    _, _, port = two_branch
    tau = _split_tau(port, "nmi")
    got = TE.br_evaluator_similarity(port, 3, N_CLASSES, _batches(), "nmi", tau)
    want = TE.br_evaluator_similarity_fused(port, 3, N_CLASSES, _batches(), "nmi", tau)
    _assert_same_result(got, want)


def test_one_branch_takes_the_final_head(tiny_model, tiny_state):
    """With one branch there is no pair of exits to gate on."""
    from ee_semantic_segmentation_tpu.ee import batch_eval as JE
    from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE

    variables = _perturbed_variables(tiny_state, seed=2)
    state = tiny_state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    port = _port_model(tiny_model, variables)
    kw = dict(ignore=(N_CLASSES - 1,), pallas_head=True)
    want = JE.br_evaluator_similarity_fused(tiny_model, state, 2, N_CLASSES, _batches(), "ssim",
                                            0.0, **kw)
    got = TE.br_evaluator_similarity_fused(port, 2, N_CLASSES, _batches(), "ssim", 0.0, **kw)
    _assert_same_result(got, want)
    assert got["b1_count"] == 0 and got["count_out"] == 7


# ---------------------------------------------------------------- CLIs
SIM_SCHEMA = ["net_id", "b1_mIoU", "b1_count", "b2_mIoU", "b2_count", "mIoU_out", "count_out",
              "mIoU_gl", "out_gl", "t", "metric"]


def test_similarity_clis_write_the_jax_schema_on_cpu(tmp_path, monkeypatch):
    """eval_br_sim with both heads and eval_br_images, --device cpu, on a
    two-branch 21-class checkpoint: the JAX package's CSV schema (NaN
    filled with 0), equal rows across heads, exit counts summing to the 16
    synthetic test images."""
    from ee_semantic_segmentation_tpu_torch.cli import eval_br_images, eval_br_sim
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    torch.manual_seed(0)
    model = build_branchy_deeplabv3(depth=50, n=2, img_dim=32, num_classes=21)
    ckpt = save_checkpoint(str(tmp_path), "tiny2", model, model.config)
    monkeypatch.chdir(tmp_path)
    base = ["-M", ckpt, "-c", "21", "-D", "32", "32", "-d", "synthetic", "-b", "12",
            "-m", "ssim", "-t", "0.6"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            eval_br_sim.main(base + ["-s", "cuda"])
    with pytest.raises(ValueError, match="-m must be one of"):
        eval_br_sim.main(base[:-4] + ["-m", "ent", "--device", "cpu"])
    for head in ([], ["--pallas_head"]):
        eval_br_sim.main(base + ["-s", "sim", "--device", "cpu"] + head)
    eval_br_images.main(base + ["-s", "images", "--device", "cpu"])
    sim = [line.split(",") for line in (tmp_path / "sim.csv").read_text().splitlines()]
    images = [line.split(",") for line in (tmp_path / "images.csv").read_text().splitlines()]
    assert sim[0] == images[0] == SIM_SCHEMA and len(sim) == 3 and len(images) == 2
    for a, b in zip(sim[1], sim[2]):  # plain head vs kernel head
        try:
            assert float(a) == pytest.approx(float(b), rel=1e-6, abs=1e-12)
        except ValueError:
            assert a == b
    for row in sim[1:] + images[1:]:
        assert row[0] == "tiny2" and row[-1] == "ssim" and row[-2] == "0.6"
        assert int(row[2]) + int(row[4]) + int(row[6]) == int(row[8]) == 16
        assert all(v != "" for v in row)  # fillna=0
