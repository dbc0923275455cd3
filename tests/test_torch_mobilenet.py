"""The port's MobileNetV3-Large backbone against the JAX package, on the CPU.

``models/mobilenetv3.py`` (block specs, FLOPs, geometry, the stem, the
inverted residual blocks with squeeze-and-excite), its wiring in
``models/branchy_deepv3.py`` (placement, FLOPs table, the 960-channel
classifier) and ``models/from_jax.py``; one training step; and the CLIs:
``main_bradeepv3 -t mobilenet``, ``eval_br_ent --pallas_head`` and
``export_serving`` on its checkpoint.

Weights are random numpy values of the JAX model's variable shapes
(``jax.eval_shape`` of its ``init``, so no init program is compiled), BN
statistics and affine terms and conv biases non-trivial, carried over by
``load_flax_variables``.  Both sides run in float64, where the
cross-framework noise is ~1e-15: the forward is held to 1e-9 of the largest
logit, the training step's loss, gradients and BatchNorm running statistics
to 1e-8 relative (``TOL_F64``).  ASPP dropout is off.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee_semantic_segmentation_tpu.models import branchy_deepv3 as JB
from ee_semantic_segmentation_tpu.models import mobilenetv3 as JM
from ee_semantic_segmentation_tpu.ops import branchy as JBr
from ee_semantic_segmentation_tpu_torch.models import branchy_deepv3 as TB
from ee_semantic_segmentation_tpu_torch.models import mobilenetv3 as TM
from ee_semantic_segmentation_tpu_torch.models.from_jax import _flatten, _torch_name
from ee_semantic_segmentation_tpu_torch.models.from_jax import load_flax_variables
from ee_semantic_segmentation_tpu_torch.ops import branchy as TBr
from test_torch_port import removes_tmp_path  # noqa: F401 (a fixture)

MNV3 = "mobilenet_v3_large"
N_CLASSES = 5
VOID = N_CLASSES
TOL_FORWARD = 1e-9  # float64 forward, relative to the largest logit
TOL_F64 = 1e-8      # float64 training step, relative to each tensor's largest value
ZERO_GRAD_ATOL = 1e-12  # gradients that are 0 in exact arithmetic: a per-channel shift
#                         that only reaches a training-mode BatchNorm (blocks.0's
#                         project_bn bias, ~1e-15 on both sides)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _jax_model(n, img, count_branches=True, dtype=jnp.float32):
    jm = JB.build_branchy_deeplabv3(n=n, img_dim=img, count_branches=count_branches,
                                    backbone=MNV3, num_classes=N_CLASSES)
    cfg = dataclasses.replace(jm.config, head_dropout=0.0)
    return JB.BranchyDeepLabV3(config=cfg, dtype=dtype)


def _random_variables(jax_model, seed):
    """float64 numpy {"params", "batch_stats"} of the model's shapes:
    lecun-scaled conv kernels, BN scale/shift/mean/var and conv biases away
    from 0 and 1."""
    H, W = jax_model.config.img_hw
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, H, W, 3)), train=False))
    rng = np.random.RandomState(seed)
    draw = {"kernel": lambda s: rng.normal(0.0, 1.0, s) / math.sqrt(np.prod(s[:-1])),
            "bias": lambda s: rng.normal(0.0, 0.1, s),
            "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "mean": lambda s: rng.normal(0.0, 0.2, s),
            "var": lambda s: rng.uniform(0.5, 1.5, s)}

    def fill(tree):
        return {k: fill(v) if hasattr(v, "items") else draw[k](v.shape) for k, v in tree.items()}

    return {c: fill(shapes[c]) for c in ("params", "batch_stats")}


def _port_model(jax_model, variables, dtype=torch.float64):
    cfg = TB.BranchyConfig(**dataclasses.asdict(jax_model.config))
    with torch.device("meta"):
        model = TB.BranchyDeepLabV3(cfg)
    model = model.to_empty(device="cpu").to(dtype)
    load_flax_variables(model, variables)
    return model


def _assert_close_rel(got, want, rel, what="", atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale + atol, f"{what}: max|d| {err:.3g} > {rel:g} x {scale:.3g} + {atol:g}"


# ------------------------------------------------------------ specs, placement
@pytest.mark.parametrize("dim", [64, 512])
def test_block_specs_flops_and_placement_equal_jax(dim):
    """Block specs, stem FLOPs, cumulative FLOPs and geometry, and the
    placement and FLOPs table over n 1..4, skip 0/1, count_branches both."""
    js, ts = JM.mobilenet_v3_block_specs(), TM.mobilenet_v3_block_specs()
    assert [dataclasses.astuple(b) for b in ts.blocks] == [dataclasses.astuple(b) for b in js.blocks]
    assert len(ts.blocks) == 16 and ts.blocks[-1].cout == 960
    assert ts.stem_flops(dim, dim) == js.stem_flops(dim, dim)
    assert ts.cumulative_flops(dim, dim) == js.cumulative_flops(dim, dim)
    assert ts.block_geometry(dim, dim) == js.block_geometry(dim, dim)
    assert [TM._make_divisible(v) for v in (3, 16, 18, 60, 240)] == \
        [JM._make_divisible(v) for v in (3, 16, 18, 60, 240)]
    for n in range(1, 5):
        for skip in (0, 1):
            for cb in (False, True):
                kw = dict(count_branches=cb, skip=skip)
                assert TB.place_branches(ts, n, dim, **kw) == JB.place_branches(js, n, dim, **kw)
                jm = JB.build_branchy_deeplabv3(n=n, img_dim=dim, backbone=MNV3, **kw)
                with torch.device("meta"):
                    tm = TB.build_branchy_deeplabv3(n=n, img_dim=dim, backbone=MNV3, **kw)
                assert tm.config == TB.BranchyConfig(**dataclasses.asdict(jm.config))
                assert tm.flops_table() == jm.flops_table()


def test_two_exit_placement_at_512():
    """BASELINE.json's 2-exit MobileNetV3 at 512²: asked for 2 branches,
    the FLOPs rule places one, after block 11 (112 channels, 32x32: 16x
    below the input), as the JAX package does; the classifier takes 960
    channels."""
    jm = JB.build_branchy_deeplabv3(n=2, img_dim=512, backbone=MNV3)
    with torch.device("meta"):
        tm = TB.build_branchy_deeplabv3(n=2, img_dim=512, backbone=MNV3)
    assert tm.config.segment_ends == jm.config.segment_ends == (11,)
    assert tm.config.branch_channels == jm.config.branch_channels == (112,)
    assert tm.config.n_exits == 2
    assert tm.classifier.aspp.conv0.in_channels == 960
    assert tm.branches[0].aspp.conv0.in_channels == 112
    assert isinstance(tm.stem, TM.MNV3Stem)
    assert all(isinstance(b, TM.InvertedResidual) for b in tm.blocks)
    spec = tm.spec
    h, w, _ = spec.blocks[10].out_shape(*spec.block_geometry(512, 512)[10][:2])
    assert (h, w) == (32, 32)


# ------------------------------------------------------------ weights
def test_every_flax_leaf_fills_a_port_tensor():
    """load_flax_variables raises on an unused flax leaf or an unfilled port
    tensor; here it takes every leaf by name.  The depthwise kernel (k, k,
    1, C) becomes the (C, 1, k, k) weight of a groups=C conv; SE convs keep
    their biases; BN has torchvision's eps 1e-3."""
    jm = _jax_model(2, 64)
    v = _random_variables(jm, seed=0)
    port = _port_model(jm, v)
    sd = port.state_dict()
    p = v["params"]
    dw = p["block_3"]["depthwise"]["kernel"]
    assert dw.shape == (5, 5, 1, 72) and tuple(sd["blocks.3.depthwise.weight"].shape) == (72, 1, 5, 5)
    np.testing.assert_array_equal(sd["blocks.3.depthwise.weight"].numpy(), dw.transpose(3, 2, 0, 1))
    assert port.blocks[3].depthwise.groups == 72
    assert port.blocks[12].depthwise.dilation == (2, 2)  # the dilated last stage
    np.testing.assert_array_equal(sd["blocks.3.se.fc1.bias"].numpy(), p["block_3"]["se"]["fc1"]["bias"])
    np.testing.assert_array_equal(sd["blocks.15.bn.running_var"].numpy(),
                                  v["batch_stats"]["block_15"]["bn"]["var"])
    np.testing.assert_array_equal(sd["stem.conv.weight"].numpy(),
                                  p["stem"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    assert {m.eps for m in port.blocks.modules() if isinstance(m, torch.nn.BatchNorm2d)} == {1e-3}
    assert {m.eps for m in port.classifier.modules() if isinstance(m, torch.nn.BatchNorm2d)} == {1e-5}
    n_leaves = sum(1 for c in ("params", "batch_stats") for _ in _flatten(v[c]))
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    assert n_leaves == len(sd) - n_bn  # every tensor but num_batches_tracked


# ------------------------------------------------------------ forward
def test_forward_matches_jax_f64():
    """The 2-exit placement at 64 px, both sides in float64: low-res logits
    (4x4, output stride 16) and upsampled logits to 1e-9 of the largest."""
    x = np.random.RandomState(1).rand(2, 64, 64, 3)
    with jax.enable_x64(True):
        jm = _jax_model(2, 64, dtype=jnp.float64)
        v = _random_variables(jm, seed=1)

        @jax.jit
        def both(variables, images):
            return (jm.apply(variables, images, train=False),
                    jm.apply(variables, images, train=False, method=JB.BranchyDeepLabV3.lowres_logits))

        full, low = both(jax.tree.map(jnp.asarray, v), jnp.asarray(x))
        want_full, want_low = np.asarray(full), [np.asarray(l) for l in low]
    assert jm.config.segment_ends == (11,) and want_full.dtype == np.float64
    port = _port_model(jm, v).eval()
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        got_low, got_full = port.lowres_logits(xt), port(xt)
    assert [tuple(l.shape) for l in got_low] == [(2, 4, 4, N_CLASSES)] * 2
    for i, (got, want) in enumerate(zip(got_low, want_low)):
        _assert_close_rel(got.numpy(), want, TOL_FORWARD, f"low-res exit {i}")
    for e in range(got_full.shape[0]):
        _assert_close_rel(got_full[e].numpy(), want_full[e], TOL_FORWARD, f"exit {e}")


# ------------------------------------------------------------ training step
def test_train_step_loss_and_gradients_match_jax_f64():
    """One training-mode forward and backward of the multi-exit Lovász loss
    on a 2-exit MobileNetV3 at 32 px, batch 4, in float64: the loss, the
    gradient of every parameter and every BatchNorm running mean and
    variance after the step (flax's biased variance, momentum 0.9) to 1e-8
    relative."""
    rng = np.random.RandomState(3)
    x = rng.rand(4, 32, 32, 3)
    labels = rng.randint(0, N_CLASSES, (4, 32, 32))
    labels[rng.rand(4, 32, 32) < 0.1] = VOID
    labels = labels.astype(np.int32)
    with jax.enable_x64(True):
        jm = _jax_model(2, 32, dtype=jnp.float64)
        v = _random_variables(jm, seed=2)
        n_branches = jm.config.n_branches
        loss_fn = JBr.LovaszSoftmax(ignore=VOID, n_branches=n_branches)

        @jax.jit
        def value_and_grad(params, stats):
            def f(p):
                out, upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                    train=True, mutable=["batch_stats"])
                return loss_fn(out, jnp.asarray(labels)), upd["batch_stats"]

            return jax.value_and_grad(f, has_aux=True)(params)

        (loss, new_stats), grads = value_and_grad(jax.tree.map(jnp.asarray, v["params"]),
                                                  jax.tree.map(jnp.asarray, v["batch_stats"]))
        want_loss = float(loss)
        want = {"params": jax.tree.map(np.asarray, grads),
                "batch_stats": jax.tree.map(np.asarray, new_stats)}
    assert n_branches == 1
    port = _port_model(jm, v).train()
    got_loss = TBr.LovaszSoftmax(ignore=VOID, n_branches=n_branches)(
        port(torch.from_numpy(x)), torch.from_numpy(labels))
    got_loss.backward()
    assert got_loss.item() == pytest.approx(want_loss, rel=TOL_F64, abs=0)
    params = dict(port.named_parameters())
    buffers = dict(port.named_buffers())
    n_checked = 0
    for collection in ("params", "batch_stats"):
        for path, w in _flatten(want[collection]):
            name = _torch_name(collection, path)
            got = params[name].grad if collection == "params" else buffers[name]
            if w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)
            _assert_close_rel(got.detach().numpy(), w, TOL_F64, name,
                              atol=ZERO_GRAD_ATOL if collection == "params" else 0.0)
            n_checked += 1
    assert n_checked == len(params) + sum(1 for n in buffers if not n.endswith("num_batches_tracked"))


# ------------------------------------------------------------ CLIs
@pytest.mark.usefixtures("removes_tmp_path")
def test_cli_trains_mobilenet_and_evaluates_and_exports_it(tmp_path, monkeypatch):
    """``main_bradeepv3 -t mobilenet -n 2`` for one epoch at 32 px writes the
    JAX CLI's sidecar (the config the JAX trainer builds for the same flags,
    read back by the JAX package's ``load_config``); ``eval_br_ent
    --pallas_head`` evaluates the checkpoint, its exits summing to the 16
    synthetic test images and its row equal to the plain head's; and
    ``export_serving --head gated --pallas_head`` exports it, the program
    giving the eager engine's exits and maps."""
    from ee_semantic_segmentation_tpu.train.checkpoint import load_config as j_load_config
    from ee_semantic_segmentation_tpu_torch.cli import eval_br_ent, export_serving, main_bradeepv3
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model
    from ee_semantic_segmentation_tpu_torch.ee.aot import load_exported, manifest_for
    from ee_semantic_segmentation_tpu_torch.ee.masked import make_masked_gated_apply

    monkeypatch.chdir(tmp_path)
    ckpt = main_bradeepv3.main(["-t", "mobilenet", "-n", "2", "-D", "32", "-b", "8", "-e", "1",
                                "-d", "synthetic", "-l", "0.05", "-N", "mnv3", "--device", "cpu"])
    want = JB.build_branchy_deeplabv3(depth=101, n=2, img_dim=32, count_branches=False,
                                      backbone=MNV3, num_classes=21).config
    assert j_load_config(ckpt) == want
    meta = json.loads((tmp_path / "synthetic_results" / "mnv3" / "mnv3.json").read_text())
    assert meta["config"]["backbone"] == MNV3 and meta["config"]["n_branches"] == 2
    assert meta["config"] == json.loads(json.dumps(dataclasses.asdict(want)))

    base = ["-M", ckpt, "-c", "21", "-D", "32", "32", "-d", "synthetic", "-b", "8", "-t", "0.9",
            "-s", "mnv3_ent", "--device", "cpu"]
    for head in ([], ["--pallas_head"]):
        eval_br_ent.main(base + head)
    rows = [line.split(",") for line in (tmp_path / "mnv3_ent.csv").read_text().splitlines()]
    assert rows[0] == ["net_id", "b1_mIoU", "b1_count", "b2_mIoU", "b2_count", "mIoU_out",
                       "count_out", "mIoU_gl", "out_gl", "t", "pool", "pool_size"]
    assert len(rows) == 3
    for row in rows[1:]:
        assert int(row[2]) + int(row[4]) + int(row[6]) == int(row[8]) == 16
    for a, b in zip(rows[1], rows[2]):  # plain head vs kernel head
        try:
            assert float(a) == pytest.approx(float(b), rel=1e-6, abs=1e-12)
        except ValueError:
            assert a == b

    out = str(tmp_path / "mnv3_gated")
    export_serving.main(["-M", ckpt, "-o", out, "-b", "2", "--head", "gated", "-t", "0.9",
                         "--pallas_head", "--device", "cpu"])
    man = manifest_for(out)
    assert man["head"] == "gated" and man["pallas_head"] and man["device"] == "cpu"
    assert man["in_avals"] == [{"shape": [2, 32, 32, 3], "dtype": "float32"}]
    assert man["out_avals"] == [{"shape": [2, 32, 32], "dtype": "int32"},
                                {"shape": [2], "dtype": "int32"}]
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32))
    labels, exits = load_exported(out).module()(x)
    model = load_model(ckpt, torch.device("cpu"))
    want_labels, want_exits = make_masked_gated_apply(model, tau=0.9, pallas_head=True)(x)
    assert torch.equal(exits, want_exits) and torch.equal(labels, want_labels)
