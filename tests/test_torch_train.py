"""The port's training path against the JAX package, on the CPU.

Covers ``train/optim.py`` (parameter groups), ``train/schedulers.py``,
``parallel/train_step.py`` and the BatchNorm of ``models/resnet.py`` in
training mode; ``tests/test_torch_train_cli.py`` covers checkpoints, the
trainer and the training CLIs.

The train-step lockstep runs both sides in float64 from the same weights
(the conftest ``tiny_model``'s, carried over by ``load_flax_variables``,
with dropout off on both sides since the two RNG streams cannot be
aligned) on the same numpy batches.  In float64 the cross-framework noise
is ~1e-15, so every parameter, every BatchNorm running mean and variance
and every step's loss are held to 1e-8 relative: a wrong learning-rate
group, weight-decay term, momentum buffer or BatchNorm statistic fails.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee_semantic_segmentation_tpu.models import branchy_deepv3 as JB
from ee_semantic_segmentation_tpu.ops import branchy as JBr
from ee_semantic_segmentation_tpu.ops import xentropy as JX
from ee_semantic_segmentation_tpu.parallel.train_step import TrainState
from ee_semantic_segmentation_tpu.parallel.train_step import make_train_step as j_make_train_step
from ee_semantic_segmentation_tpu.train import optim as JO
from ee_semantic_segmentation_tpu.train import schedulers as JS
from ee_semantic_segmentation_tpu_torch.models import branchy_deepv3 as TB
from ee_semantic_segmentation_tpu_torch.models.from_jax import (
    _flatten,
    _torch_name,
    load_flax_variables,
)
from ee_semantic_segmentation_tpu_torch.models.resnet import BatchNorm
from ee_semantic_segmentation_tpu_torch.ops import branchy as TBr
from ee_semantic_segmentation_tpu_torch.ops import xentropy as TX
from ee_semantic_segmentation_tpu_torch.parallel.train_step import make_train_step
from ee_semantic_segmentation_tpu_torch.train import optim as TO
from ee_semantic_segmentation_tpu_torch.train import schedulers as TS

TOL_LOCKSTEP = 1e-8
VOID = 5  # the tiny model has 5 classes; label 5 is void


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: a full-width
    ResNet on 8 intra-op threads per process oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)

def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _port_model(cfg, variables, dtype):
    with torch.device("meta"):
        model = TB.BranchyDeepLabV3(TB.BranchyConfig(**dataclasses.asdict(cfg)))
    model = model.to_empty(device="cpu").to(dtype)
    load_flax_variables(model, variables)
    return model


def _batches(n_batches, batch, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        labels = rng.randint(0, VOID, (batch, 32, 32))
        labels[rng.rand(batch, 32, 32) < 0.1] = VOID
        out.append((rng.rand(batch, 32, 32, 3), labels.astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def lockstep_setup(tiny_model, tiny_state):
    """(config without dropout, float64 numpy variables).  BatchNorm
    statistics, BatchNorm scales and shifts and conv biases are seeded
    non-trivial values, so that no compared tensor starts at 0 or 1."""
    cfg = dataclasses.replace(tiny_model.config, head_dropout=0.0)
    rng = np.random.RandomState(0)
    variables = {"params": _numpy_tree(tiny_state.params),
                 "batch_stats": _numpy_tree(tiny_state.batch_stats)}
    draw = {"mean": lambda n: rng.normal(0.0, 0.2, n), "var": lambda n: rng.uniform(0.5, 1.5, n),
            "scale": lambda n: rng.uniform(0.5, 1.5, n), "bias": lambda n: rng.normal(0.0, 0.1, n)}
    for collection in variables.values():
        for path, v in list(_flatten(collection)):
            if path[-1] in draw:
                node = collection
                for k in path[:-1]:
                    node = node[k]
                node[path[-1]] = draw[path[-1]](v.shape)
    return cfg, jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def _jax_run(cfg, variables, loss, mult, batches, lrs, accum):
    with jax.enable_x64(True):
        model = JB.BranchyDeepLabV3(config=cfg, dtype=jnp.float64)
        tx = JO.sgd_momentum(mult)
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = TrainState(params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(0))
        if accum > 1:
            # the accumulation scan carries its loss sum in float32: return
            # the loss in float32 (its cotangent is still 1.0 in float64)
            loss = (lambda fn: lambda out, labels: fn(out, labels).astype(jnp.float32))(loss)
        step = j_make_train_step(model, loss, tx, donate=False, accum_steps=accum)
        losses = []
        for (images, labels), lr in zip(batches, lrs):
            state, m = step(state, jnp.asarray(images), jnp.asarray(labels), jnp.float64(lr))
            losses.append(float(m["loss"]))
        return losses, {"params": _numpy_tree(state.params),
                        "batch_stats": _numpy_tree(state.batch_stats)}


def _port_run(cfg, variables, loss, mult, batches, lrs, accum):
    model = _port_model(cfg, variables, torch.float64)
    opt = TO.make_optimizer(model, mult)
    step = make_train_step(model, loss, opt, accum_steps=accum)
    losses = [float(step(torch.from_numpy(im), torch.from_numpy(lb), lr))
              for (im, lb), lr in zip(batches, lrs)]
    return losses, model


def _assert_lockstep(got_losses, model, want_losses, want_vars, loss_rtol=TOL_LOCKSTEP):
    np.testing.assert_allclose(got_losses, want_losses, rtol=loss_rtol, atol=0)
    state = model.state_dict()
    n_checked = 0
    for collection in ("params", "batch_stats"):
        for path, want in _flatten(want_vars[collection]):
            name = _torch_name(collection, path)
            got = state[name].numpy()
            if want.ndim == 4:
                want = want.transpose(3, 2, 0, 1)
            err, scale = np.abs(got - want).max(), np.abs(want).max()
            assert err <= TOL_LOCKSTEP * scale, f"{name}: max|d| {err:.3g}, max|want| {scale:.3g}"
            n_checked += 1
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert n_checked == len(state) - n_bn  # everything but num_batches_tracked


LOCKSTEP_CASES = {
    # name: (loss factory (module), steps, batch, accum_steps)
    "lovasz": (lambda M: M.LovaszSoftmax(ignore=VOID, n_branches=1), 2, 4, 1),
    "lovasz_accum2": (lambda M: M.LovaszSoftmax(ignore=VOID, n_branches=1), 2, 8, 2),
    "ce": (lambda M: M.BrXEntropyLoss(ignore_index=VOID, b_reduction="sum", n_exits=2), 2, 4, 1),
}


@pytest.mark.parametrize("case", list(LOCKSTEP_CASES))
def test_train_step_lockstep_with_jax_f64(lockstep_setup, case):
    """Loss per step, every parameter and every BatchNorm running mean and
    variance after the steps, at the default group multipliers (backbone
    1, branch 1, classifier 1.1) and a learning rate that changes between
    steps.  ``lovasz_accum2`` splits a batch of 8 into 2 micro-batches:
    the running statistics advance twice per step on both sides.

    Batches (micro-batches) are of 4 images: there the ASPP pooling
    branch's BatchNorm normalises 4 values per channel, where
    ``nn.BatchNorm2d``'s running variance would be 4/3 of flax's.  At 2
    images it normalises 2 values whose difference is small for some
    channels, which amplifies the float64 noise of the first step ~1e3-fold
    in the second (measured: 3e-8 relative after 2 steps, against 1e-10 at
    4); batch 2 is held against flax in ``test_batchnorm_training_matches_flax``.
    """
    make_loss, steps, batch, accum = LOCKSTEP_CASES[case]
    cfg, variables = lockstep_setup
    mult = JO.branchy_lr_multipliers(1, 0.05)
    batches, lrs = _batches(steps, batch), [0.05, 0.03][:steps]
    jax_loss = make_loss(JX if case == "ce" else JBr)
    port_loss = make_loss(TX if case == "ce" else TBr)
    want_losses, want_vars = _jax_run(cfg, variables, jax_loss, mult, batches, lrs, accum)
    got_losses, model = _port_run(cfg, variables, port_loss, mult, batches, lrs, accum)
    # with accumulation the JAX side's loss is summed in float32 (above):
    # a few float32 roundings
    _assert_lockstep(got_losses, model, want_losses, want_vars,
                     loss_rtol=TOL_LOCKSTEP if accum == 1 else 2 ** -22)


def test_batch_one_train_step_runs(lockstep_setup):
    """Batch 1 trains, as in JAX: the ASPP pooling branch's BatchNorm sees
    one value per channel; its output is the shift, its running variance
    decays by the momentum."""
    cfg, variables = lockstep_setup
    model = _port_model(cfg, variables, torch.float32)
    pool_bns = [m for n, m in model.named_modules() if n.endswith("pool_bn")]
    before = [m.running_var.clone() for m in pool_bns]
    step = make_train_step(model, TBr.LovaszSoftmax(ignore=VOID, n_branches=1),
                           TO.make_optimizer(model))
    (im, lb), = _batches(1, 1)
    loss = step(torch.from_numpy(im).float(), torch.from_numpy(lb), 0.01)
    assert torch.isfinite(loss)
    for m, var in zip(pool_bns, before):
        torch.testing.assert_close(m.running_var, 0.9 * var, rtol=1e-6, atol=0)


# ------------------------------------------------------------ BatchNorm repair
@pytest.mark.parametrize("shape", [(2, 1, 1, 6), (1, 1, 1, 6), (3, 4, 5, 6)],
                         ids=["pooled_batch2", "pooled_batch1", "spatial"])
def test_batchnorm_training_matches_flax(shape):
    """Output, input and affine gradients, and running statistics of one
    training-mode call, against ``flax.linen.BatchNorm(momentum=0.9)`` in
    float64.  (2, 1, 1, C) is the ASPP pooling branch at batch 2, where
    ``nn.BatchNorm2d``'s unbiased running variance would be twice flax's."""
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape) * 2.0 + 0.5
    scale, shift = rng.uniform(0.5, 1.5, shape[-1]), rng.randn(shape[-1])
    mean0, var0 = rng.randn(shape[-1]) * 0.1, rng.uniform(0.5, 1.5, shape[-1])
    ct = rng.randn(*shape)
    with jax.enable_x64(True):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                           dtype=jnp.float64, param_dtype=jnp.float64)
        variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)},
                     "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

        def f(xx, p):
            y, upd = bn.apply({"params": p, "batch_stats": variables["batch_stats"]}, xx,
                              mutable=["batch_stats"])
            return jnp.sum(y * ct), (y, upd["batch_stats"])

        (_, (want_y, want_stats)), (want_gx, want_gp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), variables["params"])

    m = BatchNorm(shape[-1], eps=1e-5, momentum=0.1).double().train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(shift))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = m(xt)
    (y * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    close = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), want_y, **close)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), want_gx, **close)
    np.testing.assert_allclose(m.weight.grad.numpy(), want_gp["scale"], **close)
    np.testing.assert_allclose(m.bias.grad.numpy(), want_gp["bias"], **close)
    np.testing.assert_allclose(m.running_mean.numpy(), want_stats["mean"], **close)
    np.testing.assert_allclose(m.running_var.numpy(), want_stats["var"], **close)
    if shape[0] * shape[1] * shape[2] == 2:  # the fault the repair removes
        stock = torch.nn.BatchNorm2d(shape[-1], eps=1e-5, momentum=0.1).double().train()
        stock.running_var.copy_(torch.from_numpy(var0))
        stock(xt.detach())
        batch_var = x.reshape(-1, shape[-1]).var(0)
        np.testing.assert_allclose(stock.running_var.numpy(), 0.9 * var0 + 0.1 * 2 * batch_var)
        np.testing.assert_allclose(m.running_var.numpy(), 0.9 * var0 + 0.1 * batch_var)


def test_batchnorm_eval_mode_is_the_stock_module(lockstep_setup):
    """Eval-mode outputs of the tiny model are those of the same model
    built with ``nn.BatchNorm2d``: bit for bit."""
    cfg, variables = lockstep_setup
    model = _port_model(cfg, variables, torch.float32).eval()
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32))
    with torch.inference_mode():
        want = model(x)
    for name, m in list(model.named_modules()):
        for child_name, child in list(m.named_children()):
            if isinstance(child, BatchNorm):
                stock = torch.nn.BatchNorm2d(child.num_features, eps=child.eps,
                                             momentum=child.momentum)
                stock.load_state_dict(child.state_dict())
                setattr(m, child_name, stock.eval())
    assert not any(isinstance(m, BatchNorm) for m in model.modules())
    with torch.inference_mode():
        assert torch.equal(model(x), want)


# ------------------------------------------------------------ optimizer groups
@functools.lru_cache(maxsize=None)
def _jax_param_paths(cfg):
    model = JB.BranchyDeepLabV3(config=cfg)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, *cfg.img_hw, 3)))
    return [path for path, _ in _flatten(_numpy_tree_shapes(shapes["params"]))]


def _numpy_tree_shapes(tree):
    return {k: _numpy_tree_shapes(v) if hasattr(v, "items") else v for k, v in tree.items()}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(base_lr=0.002),
    dict(weighted_lr=True),
    dict(freeze_backbone=True),
    dict(freeze_backbone=True, freeze_from=1),
], ids=["default", "base_lr", "weighted_lr", "freeze_backbone", "freeze_from"])
def test_optimizer_groups_match_jax_multipliers(kw):
    """Each parameter's multiplier in the port's SGD groups equals the one
    the JAX chain applies to the same leaf, on a two-branch model."""
    with torch.device("meta"):
        model = TB.build_branchy_deeplabv3(depth=50, n=2, img_dim=64, num_classes=5)
    cfg = JB.BranchyConfig(**dataclasses.asdict(model.config))
    mult_j = JO.branchy_lr_multipliers(2, 0.01, **kw)
    mult_t = TO.branchy_lr_multipliers(2, 0.01, **kw)
    assert mult_t == mult_j
    want = {_torch_name("params", path): mult_j.get(JO.label_params(path), 1.0)
            for path in _jax_param_paths(cfg)}
    opt = TO.make_optimizer(model, mult_t)
    names = {id(p): n for n, p in model.named_parameters()}
    got = {}
    for group in opt.param_groups:
        assert (group["momentum"], group["weight_decay"], group["dampening"],
                group["nesterov"]) == (0.9, 5e-4, 0.0, False)
        for p in group["params"]:
            assert names[id(p)] not in got
            got[names[id(p)]] = group["mult"]
    assert got == want
    assert [g["name"] for g in opt.param_groups] == [
        "backbone", "branch_0", "branch_1", "classifier"]
    TO.set_lr(opt, 0.02)
    for group in opt.param_groups:
        assert group["lr"] == 0.02 * mult_t[group["name"]]


# ------------------------------------------------------------ schedulers
@pytest.mark.parametrize("min_lr", [0.0, 1e-4])
def test_polynomial_lr_matches_jax(min_lr):
    j, t = JS.PolynomialLR(0.01, 10, min_lr=min_lr), TS.PolynomialLR(0.01, 10, min_lr=min_lr)
    assert [t(e) for e in range(14)] == [j(e) for e in range(14)]


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_lr_on_plateau_matches_jax(mode):
    metrics = np.random.RandomState(4).rand(40).cumsum() % 1.3
    kw = dict(factor=0.75, patience=2, mode=mode, eps=1e-6, min_lr=1e-4)
    j, t = JS.ReduceLROnPlateau(0.01, **kw), TS.ReduceLROnPlateau(0.01, **kw)
    got = [t(e, float(m)) for e, m in enumerate(metrics)] + [t(40, None)]
    want = [j(e, float(m)) for e, m in enumerate(metrics)] + [j(40, None)]
    assert got == want and len(set(got)) > 2
