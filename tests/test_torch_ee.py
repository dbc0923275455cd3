"""The early-exit engines and the rest of the eval surface of the port
against the JAX package, on the CPU: ``ee/sequential.EarlyExitRunner``,
``ee/masked`` (``make_masked_gated_apply``, ``make_masked_gated_scan``,
``gated_flops_per_image``), the PRF metrics of ``ops/metrics.py`` and the
forward-function evaluators ``mIoU_evaluator`` and ``br_evaluator_entropy``.

A two-branch tiny model (exits after blocks 3 and 7, 5 classes, 32 px)
carries the JAX model's weights across (``load_flax_variables``, with
perturbed BN statistics, affine terms and biases).  Each split tau sits in
the widest gap of the first gated exit's gate values that is also at least
``GATE_MARGIN`` from every other gate value the engines compare, so a
float32 rounding cannot move an image across it.  Exits and FLOPs must be
equal, and label maps agree on at least ``TOL_MAP_AGREE`` of the pixels.
The masked engine's ``pallas_head`` runs the JAX Pallas kernels B and C in
interpret mode (as ``tests/test_masked.py`` does) and the port's through
their plain versions: the tensors lie on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port import _assert_same_result, _perturbed_variables, _port_model

N_CLASSES = 5
SIM_IGNORE = (N_CLASSES - 1,)
TOL_MAP_AGREE = 0.99999  # share of label-map pixels that must agree
GATE_MARGIN = 1e-5       # least distance of a split tau from any gate value (the
#                          gates of the two packages differ by float32 roundings, ~1e-7)
PRF_RTOL = 1e-6          # PRF metrics: float32 ratios of equal integer counts


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def two_branch():
    """(JAX model, its {"params", "batch_stats"} with perturbed values, the
    port model with the same weights)."""
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
    return model, variables, _port_model(model, variables)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(21).rand(8, 32, 32, 3).astype(np.float32)


def _gate_values(port, images, metric, pool_size):
    """(values of the first gated exit, every gate value the engines
    compare) from the port's plain forward: each branch's entropy for the
    entropy gate, the exit-0/exit-1 similarity for the similarity gate."""
    from ee_semantic_segmentation_tpu_torch.ops import gating as TG

    with torch.inference_mode():
        out = port(torch.from_numpy(images))
    if metric in ("ent", "max", "min"):
        pool = {"ent": "none"}.get(metric, metric)
        ent = TG.batched_norm_entropy(out[:-1], N_CLASSES, pool, pool_size)
        return ent[0].tolist(), ent.flatten().tolist()
    sims = TG.batched_similarity(out[:2].argmax(-1), metric, N_CLASSES, SIM_IGNORE)[0].tolist()
    return sims, sims


def _split_tau(port, images, metric, pool_size=1):
    """The midpoint of a gap between two first-exit gate values (so the
    images split) that is farthest from every gate value compared."""
    first, every = _gate_values(port, images, metric, pool_size)
    first = sorted(first)
    mids = [(a + b) / 2 for a, b in zip(first, first[1:])]
    tau = max(mids, key=lambda t: min(abs(t - v) for v in every))
    assert min(abs(tau - v) for v in every) > GATE_MARGIN, (metric, every)
    return tau


def _tau(port, images, metric, kind, pool_size=1):
    return {"inf": np.inf, "-inf": -np.inf}.get(kind) or _split_tau(port, images, metric, pool_size)


def _assert_maps_agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    agree = (got == want).mean()
    assert agree >= TOL_MAP_AGREE, agree


# ---------------------------------------------------------------- sequential
SEQ_CASES = {  # id -> (metric, pool_size, tau kind, 0-based ignored branches)
    "ent_split": ("ent", 1, "split", ()),
    "ent_inf": ("ent", 1, "inf", ()),
    "ent_-inf": ("ent", 1, "-inf", ()),
    "ent_split_ignore0": ("ent", 1, "split", (0,)),
    "max_p2_split": ("max", 2, "split", ()),
    "ssim_split": ("ssim", 1, "split", ()),
    "ssim_inf": ("ssim", 1, "inf", ()),
    "ssim_split_ignore0": ("ssim", 1, "split", (0,)),
    "nmi_split": ("nmi", 1, "split", ()),
    "vi_split": ("vi", 1, "split", ()),
}


def _seq_kw(metric, tau, ignore, pool_size):
    less_than = metric not in ("ssim", "nmi")
    return dict(metric=metric, threshold=tau, less_than=less_than, ignore=ignore,
                n_classes=N_CLASSES, pool_size=pool_size, sim_ignore=SIM_IGNORE, img_dim=32)


@pytest.fixture(scope="module")
def jax_runners(two_branch):
    """The JAX sequential engine, one a (metric, pool size, ignored
    branches): its first call traces every stage (~4 s), so the cases of
    one key share it and set only its ``threshold``."""
    from ee_semantic_segmentation_tpu.ee.sequential import EarlyExitRunner

    model, variables, _ = two_branch
    runners = {}

    def get(metric, pool_size, ignore, tau):
        key = (metric, pool_size, ignore)
        if key not in runners:
            runners[key] = EarlyExitRunner(model, variables["params"], variables["batch_stats"],
                                           **_seq_kw(metric, tau, ignore, pool_size))
        runners[key].threshold = tau
        return runners[key]

    return get


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequential_engine_matches_jax(two_branch, jax_runners, images, case):
    """Per image: the same exit, FLOPs and counters, the same exit and last
    maps; and the port's masked engine (ignored branches as a leading skip)
    gives the same exits and maps."""
    from ee_semantic_segmentation_tpu_torch.ee.masked import make_masked_gated_apply
    from ee_semantic_segmentation_tpu_torch.ee.sequential import EarlyExitRunner as TR

    metric, pool_size, kind, ignore = SEQ_CASES[case]
    _, _, port = two_branch
    tau = _tau(port, images, metric, kind, pool_size)
    jr = jax_runners(metric, pool_size, ignore, tau)
    tr = TR(port, **_seq_kw(metric, tau, ignore, pool_size))
    exits = []
    for img in images:
        want, got = jr(img), tr(img)
        assert sorted(got) == sorted(want)
        for k in ("n", "exit_flops", "exit_flops_2", "edge_flops", "edge_flops_2",
                  "last_flops", "last_flops_2"):
            assert got[k] == want[k], k
        _assert_maps_agree(got["exit"].numpy(), want["exit"])
        _assert_maps_agree(got["last"].numpy(), want["last"])
        exits.append(got["n"])
    if kind == "split" and not ignore:
        assert len(set(exits)) > 1, exits  # the tau splits the images
    if kind == "inf":  # every gate fires (ssim: none)
        assert set(exits) == {3 if metric == "ssim" else 2 if ignore else 1}
    if kind == "-inf" or (ignore and metric == "ssim"):
        assert set(exits) == {3}

    skip = len(ignore)
    masked = make_masked_gated_apply(port, tau=tau, n_classes=N_CLASSES, skip=skip,
                                     pool_size=pool_size, metric=metric, sim_ignore=SIM_IGNORE)
    labels, m_exits = masked(torch.from_numpy(images))
    assert m_exits.tolist() == exits
    for i, img in enumerate(images):
        _assert_maps_agree(labels[i].numpy(), tr(img)["exit"].numpy())


# ---------------------------------------------------------------- masked
MASKED_CASES = {  # id -> (metric, pool_size, tau kind, skip, pallas_head)
    "ent_split_plain": ("ent", 1, "split", 0, False),
    "ent_split_kernel": ("ent", 1, "split", 0, True),
    "ent_inf_kernel": ("ent", 1, "inf", 0, True),
    "ent_-inf_kernel": ("ent", 1, "-inf", 0, True),
    "ent_split_skip1_kernel": ("ent", 1, "split", 1, True),
    "max_p2_split_kernel": ("max", 2, "split", 0, True),  # pooled: the plain head
    "ssim_split": ("ssim", 1, "split", 0, False),
    "nmi_split": ("nmi", 1, "split", 0, False),
    "vi_split": ("vi", 1, "split", 0, False),
}


@pytest.mark.parametrize("case", list(MASKED_CASES))
def test_masked_engine_matches_jax(two_branch, images, case):
    """The same exits and label maps as the JAX masked engine, and the same
    gated FLOPs of the exit histogram; with pallas_head, the JAX side runs
    its Pallas kernels in interpret mode."""
    from ee_semantic_segmentation_tpu.ee import masked as JM
    from ee_semantic_segmentation_tpu_torch.ee import masked as TM

    metric, pool_size, kind, skip, pallas_head = MASKED_CASES[case]
    model, variables, port = two_branch
    tau = _tau(port, images, metric, kind, pool_size)
    kw = dict(tau=tau, n_classes=N_CLASSES, skip=skip, pool_size=pool_size,
              pallas_head=pallas_head, metric=metric, sim_ignore=SIM_IGNORE)
    want_labels, want_exits = JM.make_masked_gated_apply(model, variables, **kw)(
        jnp.asarray(images))
    fn = TM.make_masked_gated_apply(port, **kw)
    labels, exits = fn(torch.from_numpy(images))
    assert fn.kernel_head == (pallas_head and metric == "ent")
    assert labels.dtype == exits.dtype == torch.int32
    np.testing.assert_array_equal(exits.numpy(), np.asarray(want_exits))
    _assert_maps_agree(labels.numpy(), want_labels)
    hist = dict(zip(*np.unique(exits.numpy(), return_counts=True)))
    for first in (False, True):
        assert TM.gated_flops_per_image(port, hist, skip=skip, img_dim=32,
                                        exclude_first_branch=first) == \
            JM.gated_flops_per_image(model, hist, skip=skip, img_dim=32,
                                     exclude_first_branch=first)
    if kind == "split" and not skip:
        assert len(set(exits.tolist())) > 1


@pytest.mark.parametrize("metric,pool_size,kernel_head", [("ent", 1, True), ("max", 2, False),
                                                          ("ssim", 1, False)])
def test_pallas_head_calls_kernels_b_and_c_only_for_the_plain_entropy_gate(
        two_branch, images, monkeypatch, metric, pool_size, kernel_head):
    """Kernel B once per gated stage the micro-batch reaches, C once when a
    row is still alive at the end; a pooled or similarity gate calls
    neither (the JAX package's plain head there), and launches nothing."""
    from ee_semantic_segmentation_tpu_torch.ee import masked as TM
    from ee_semantic_segmentation_tpu_torch.ops.kernels import upsample_argmax as U

    _, _, port = two_branch
    calls = {"B": 0, "C": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TM, "upsample_entropy_argmax", counting("B", U.upsample_entropy_argmax))
    monkeypatch.setattr(TM, "upsample_argmax", counting("C", U.upsample_argmax))
    for k in U.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    x = torch.from_numpy(images)
    for tau, b_calls, c_calls in ((np.inf, 1, 0), (-np.inf, 2, 1)):
        calls.update(B=0, C=0)
        fn = TM.make_masked_gated_apply(port, tau=tau, n_classes=N_CLASSES, metric=metric,
                                        pool_size=pool_size, pallas_head=True,
                                        sim_ignore=SIM_IGNORE)
        assert fn.kernel_head == kernel_head
        _, exits = fn(x)
        # the similarity gate's first exit only seeds, and ssim fires on sim > tau
        fires_all = tau < 0 if metric == "ssim" else tau > 0
        assert set(exits.tolist()) == ({2 if metric == "ssim" else 1} if fires_all else {3})
        if kernel_head:
            assert calls == {"B": b_calls, "C": c_calls}
        else:
            assert calls == {"B": 0, "C": 0}
    assert [k.launches for k in U.KERNELS] == [0, 0, 0]


def test_masked_scan_matches_per_batch(two_branch, images):
    from ee_semantic_segmentation_tpu_torch.ee import masked as TM

    _, _, port = two_branch
    tau = _split_tau(port, images, "ent")
    per = TM.make_masked_gated_apply(port, tau=tau, n_classes=N_CLASSES, pallas_head=True)
    scan = TM.make_masked_gated_scan(port, tau=tau, n_classes=N_CLASSES, pallas_head=True)
    xs = torch.from_numpy(images).reshape(2, 4, 32, 32, 3)
    labels_s, exits_s = scan(xs)
    assert scan.kernel_head and tuple(labels_s.shape) == (2, 4, 32, 32)
    for s in range(2):
        lab, ex = per(xs[s])
        assert torch.equal(labels_s[s], lab) and torch.equal(exits_s[s], ex)
    assert len(set(exits_s.flatten().tolist())) > 1


@pytest.mark.parametrize("skip", [0, 1, 2])
def test_gated_flops_per_image_equals_jax(two_branch, skip):
    from ee_semantic_segmentation_tpu.ee.masked import gated_flops_per_image as jf
    from ee_semantic_segmentation_tpu_torch.ee.masked import gated_flops_per_image as tf

    model, _, port = two_branch
    for hist in ({1: 3}, {2: 1, 3: 4}, {1: 2, 2: 5, 3: 1}, {}):
        for first in (False, True):
            for dim in (None, 64, (32, 48)):
                assert tf(port, hist, skip=skip, img_dim=dim, exclude_first_branch=first) == \
                    jf(model, hist, skip=skip, img_dim=dim, exclude_first_branch=first)


# ---------------------------------------------------------------- A3: PRF metrics
def _prf_inputs(seed=0, N=3, H=9, W=11, C=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, H, W, C).astype(np.float32)
    labels = rng.randint(0, C + 1, (N, H, W)).astype(np.int32)  # label C is void
    labels[0, :3] = 255
    return logits, labels


@pytest.mark.parametrize("name", ["Recall", "Precision", "F_beta", "Accuracy"])
@pytest.mark.parametrize("avg", ["macro", "micro", "none"])
def test_prf_metrics_match_jax(name, avg):
    """Every reduction, with void labels (C and 255), a (N, H, W, 1) target
    and F_beta's beta; ratios within PRF_RTOL."""
    from ee_semantic_segmentation_tpu.ops import metrics as JM
    from ee_semantic_segmentation_tpu_torch.ops import metrics as TM

    logits, labels = _prf_inputs(seed=len(name) + len(avg))
    for reduction in ("mean", "sum", "mean_batchwise", "sum_batchwise", None):
        kw = dict(reduction=reduction, avg=avg)
        if name == "F_beta":
            kw["beta"] = 0.5
        for target in (labels, labels[..., None]):
            want = np.asarray(getattr(JM, name)(**kw)(jnp.asarray(logits), jnp.asarray(target)))
            got = getattr(TM, name)(**kw)(torch.from_numpy(logits), torch.from_numpy(target))
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=PRF_RTOL, atol=0)


def test_flatten_pixels_and_apply_reduction_match_jax():
    from ee_semantic_segmentation_tpu.ops import losses as JL
    from ee_semantic_segmentation_tpu.ops import metrics as JM
    from ee_semantic_segmentation_tpu_torch.ops import losses as TL
    from ee_semantic_segmentation_tpu_torch.ops import metrics as TM

    logits, labels = _prf_inputs(seed=5)
    for got, want in zip(TM._flatten_pixels(torch.from_numpy(logits), torch.from_numpy(labels)),
                         JM._flatten_pixels(jnp.asarray(logits), jnp.asarray(labels))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.random.RandomState(6).rand(3, 4, 5).astype(np.float32)
    for reduction in ("mean", "sum", "mean_batchwise", "sum_batchwise", "none"):
        np.testing.assert_allclose(TL.apply_reduction(torch.from_numpy(x), reduction).numpy(),
                                   np.asarray(JL.apply_reduction(jnp.asarray(x), reduction)),
                                   rtol=1e-6)


# ---------------------------------------------------------------- A3: forward-function evaluators
def _batches():
    rng = np.random.RandomState(12)
    batches = [{"image": rng.rand(4, 32, 32, 3).astype(np.float32),
                "label": rng.randint(0, N_CLASSES + 1, (4, 32, 32)).astype(np.int32)}
               for _ in range(2)]
    batches[1]["count"] = 3  # padded tail row, left out of every count
    return batches


@pytest.fixture(scope="module")
def forwards(two_branch):
    """(the JAX forward function, the port's cli/common.forward_fn)."""
    from ee_semantic_segmentation_tpu_torch.cli.common import forward_fn

    model, variables, port = two_branch
    jfwd = jax.jit(lambda x: model.apply(variables, x, train=False))
    return (lambda x: jfwd(jnp.asarray(x))), forward_fn(port)


def test_forward_fn_returns_every_exit(two_branch, forwards):
    _, _, port = two_branch
    imgs = _batches()[0]["image"]
    out = forwards[1](imgs)
    assert tuple(out.shape) == (3, 4, 32, 32, N_CLASSES) and not torch.is_inference_mode_enabled()
    np.testing.assert_allclose(out.numpy(), np.asarray(forwards[0](imgs)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("empty_class", ["nan", "one"])
def test_miou_evaluator_matches_jax(forwards, empty_class):
    from ee_semantic_segmentation_tpu.ee import batch_eval as JE
    from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE

    want = JE.mIoU_evaluator(forwards[0], 3, N_CLASSES, _batches(), empty_class=empty_class)
    got = TE.mIoU_evaluator(forwards[1], 3, N_CLASSES, _batches(), empty_class=empty_class)
    _assert_same_result(got, want)


@pytest.mark.parametrize("metric,size,skip", [("ent", 1, 0), ("ent", 1, 1), ("max", 2, 0),
                                              ("min", 2, 0)])
def test_entropy_evaluator_through_a_forward_fn_matches_jax(two_branch, forwards, metric, size,
                                                            skip):
    """At a tau that splits the 7 valid images at the first exit."""
    from ee_semantic_segmentation_tpu.ee import batch_eval as JE
    from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE

    _, _, port = two_branch
    valid = np.concatenate([b["image"][:b.get("count", 4)] for b in _batches()])
    tau = _split_tau(port, valid, metric, size)
    kw = dict(metric=metric, size=size, skip=skip)
    want = JE.br_evaluator_entropy(forwards[0], 3, N_CLASSES, _batches(), tau, **kw)
    got = TE.br_evaluator_entropy(forwards[1], 3, N_CLASSES, _batches(), tau, **kw)
    _assert_same_result(got, want)
    assert got["b1_count"] + got["b2_count"] + got["count_out"] == got["out_gl"] == 7
    assert (got["b1_count"] == 0) == (skip > 0)
    fused = TE.br_evaluator_entropy_fused(port, 3, N_CLASSES, _batches(), tau, **kw)
    _assert_same_result(fused, got)
