"""The PyTorch port (``ee_semantic_segmentation_tpu_torch``) against the JAX package.

Model, placement, evaluators, checkpoints, data and CLIs of the port's first
slice (per-exit mIoU and entropy-gated evaluation), run on the CPU at the
conftest ``tiny_model`` size.  Inputs come from numpy with a seed; weights
are the JAX model's, carried over by ``models/from_jax.load_flax_variables``
with BN statistics, BN affine terms and conv biases overwritten by seeded
non-trivial values so that a mapping error cannot hide.
"""

import ast
import dataclasses
import importlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee_semantic_segmentation_tpu.models import branchy_deepv3 as JB
from ee_semantic_segmentation_tpu.models.resnet import resnet_block_specs as j_specs
from ee_semantic_segmentation_tpu_torch.models import branchy_deepv3 as TB
from ee_semantic_segmentation_tpu_torch.models.from_jax import load_flax_variables
from ee_semantic_segmentation_tpu_torch.models.resnet import resnet_block_specs as t_specs

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "ee_semantic_segmentation_tpu_torch"


def _perturbed_variables(state, seed=0):
    """numpy {"params", "batch_stats"} of ``state`` with seeded BN running
    stats (mean != 0, var != 1), BN scale/shift and conv biases."""
    rng = np.random.RandomState(seed)
    variables = {"params": _numpy_tree(state.params),
                 "batch_stats": _numpy_tree(state.batch_stats)}

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "mean":
                tree[k] = rng.normal(0.0, 0.2, v.shape).astype(v.dtype)
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
            elif k == "bias":
                tree[k] = rng.normal(0.0, 0.1, v.shape).astype(v.dtype)

    perturb(variables)
    return variables


def _numpy_tree(tree):
    """Nested dicts of numpy copies (what load_flax_variables takes)."""
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _port_model(jax_model, variables, dtype=torch.float32):
    cfg = TB.BranchyConfig(**dataclasses.asdict(jax_model.config))
    with torch.device("meta"):
        model = TB.BranchyDeepLabV3(cfg)
    model = model.to_empty(device="cpu")
    load_flax_variables(model, variables)
    return model.to(dtype).eval()


@pytest.fixture(scope="module")
def tiny_vars(tiny_state):
    return _perturbed_variables(tiny_state)


@pytest.fixture(scope="module")
def tiny_port(tiny_model, tiny_vars):
    return _port_model(tiny_model, tiny_vars)


def _images(n=2, seed=1):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


def _assert_close_rel(got, want, rel):
    """max|got - want| <= rel * max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max|d| {err:.3g} > {rel:g} x max|logit| {scale:.3g}"


# ------------------------------------------------------------------ placement
@pytest.mark.parametrize("depth", [50, 101])
@pytest.mark.parametrize("dim", [256, 512])
def test_placement_and_flops_table_equal_jax(depth, dim):
    """Exactly equal over the test_placement_parity.py grid (n 1..7, skip
    0/1, count_branches both) for this depth and image size."""
    js, ts = j_specs(depth), t_specs(depth)
    assert [dataclasses.astuple(b) for b in js.blocks] == [dataclasses.astuple(b) for b in ts.blocks]
    assert js.cumulative_flops(dim, dim) == ts.cumulative_flops(dim, dim)
    for n in range(1, 8):
        for skip in (0, 1):
            for cb in (False, True):
                kw = dict(count_branches=cb, skip=skip)
                want = JB.place_branches(js, n, dim, **kw)
                assert TB.place_branches(ts, n, dim, **kw) == want
                jm = JB.build_branchy_deeplabv3(depth=depth, n=n, img_dim=dim, **kw)
                cfg = TB.BranchyConfig(**dataclasses.asdict(jm.config))
                with torch.device("meta"):
                    tm = TB.BranchyDeepLabV3(cfg)
                assert tm.flops_table() == jm.flops_table()


def test_flagship_placement():
    """The flagship eval model: exits after layer3.4 and layer4.1."""
    with torch.device("meta"):
        m = TB.build_branchy_deeplabv3(depth=50, n=2, img_dim=512, count_branches=False)
    assert m.config.segment_ends == (12, 15)
    assert m.config.branch_channels == (1024, 2048)


def test_mobilenet_backbone_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TB.build_branchy_deeplabv3(depth=50, n=1, img_dim=64, backbone="mobilenet_v3_large")


# ---------------------------------------------------------------- weights
def test_load_flax_variables_fills_everything_by_name(tiny_port, tiny_vars):
    p, s = tiny_vars["params"], tiny_vars["batch_stats"]
    sd = tiny_port.state_dict()
    np.testing.assert_array_equal(sd["blocks.0.conv2.weight"].numpy(),
                                  p["block_0"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["branches.0.aspp.pool_bn.weight"].numpy(),
                                  p["branch_0"]["aspp"]["pool_bn"]["scale"])
    np.testing.assert_array_equal(sd["classifier.classifier.bias"].numpy(),
                                  p["classifier"]["classifier"]["bias"])
    np.testing.assert_array_equal(sd["stem.bn1.running_var"].numpy(), s["stem"]["bn1"]["var"])


def test_load_flax_variables_rejects_missing_and_unused(tiny_model, tiny_vars):
    missing = {"params": dict(tiny_vars["params"]), "batch_stats": tiny_vars["batch_stats"]}
    del missing["params"]["classifier"]
    with pytest.raises(ValueError, match="unfilled port tensors.*classifier.classifier.weight"):
        _port_model(tiny_model, missing)
    extra = {"params": dict(tiny_vars["params"]), "batch_stats": tiny_vars["batch_stats"]}
    extra["params"]["branch_1"] = tiny_vars["params"]["branch_0"]
    with pytest.raises(ValueError, match="unused flax leaves.*branch_1"):
        _port_model(tiny_model, extra)


# ---------------------------------------------------------------- forward
@pytest.fixture(scope="module")
def jax_outputs(tiny_model, tiny_vars):
    x = jnp.asarray(_images())

    @jax.jit
    def both(variables):
        full = tiny_model.apply(variables, x, train=False)
        low = tiny_model.apply(variables, x, train=False, method=type(tiny_model).lowres_logits)
        return full, low

    full, low = both(jax.tree.map(jnp.asarray, tiny_vars))
    return np.asarray(full), [np.asarray(l) for l in low]


def test_lowres_logits_match_jax_f32(tiny_port, jax_outputs):
    """Each exit to 1e-4 of the largest logit: the convs' float association
    differs between XLA:CPU and PyTorch's CPU kernels."""
    with torch.inference_mode():
        low = tiny_port.lowres_logits(torch.from_numpy(_images()))
    assert len(low) == len(jax_outputs[1]) == 2
    for got, want in zip(low, jax_outputs[1]):
        assert got.is_contiguous()
        _assert_close_rel(got.numpy(), want, 1e-4)


def test_forward_matches_jax_f32(tiny_port, jax_outputs):
    """(E, N, H, W, C) upsampled logits, same 1e-4 relative tolerance."""
    with torch.inference_mode():
        full = tiny_port(torch.from_numpy(_images()))
    for e in range(full.shape[0]):
        _assert_close_rel(full[e].numpy(), jax_outputs[0][e], 1e-4)


def test_lowres_and_forward_match_jax_f64(tiny_model, tiny_vars):
    """In float64 on both sides the association noise drops to ~1e-15, so
    1e-9 of the largest logit isolates semantics."""
    x = _images()
    v64 = jax.tree.map(lambda a: a.astype(np.float64), tiny_vars)
    with jax.enable_x64(True):
        m64 = JB.BranchyDeepLabV3(config=tiny_model.config, dtype=jnp.float64)
        jv = jax.tree.map(jnp.asarray, v64)
        want_full = np.asarray(m64.apply(jv, jnp.asarray(x, jnp.float64), train=False))
        want_low = [np.asarray(l) for l in m64.apply(
            jv, jnp.asarray(x, jnp.float64), train=False, method=JB.BranchyDeepLabV3.lowres_logits)]
    assert want_full.dtype == np.float64
    port = _port_model(tiny_model, v64, torch.float64)
    with torch.inference_mode():
        xt = torch.from_numpy(x).double()
        low, full = port.lowres_logits(xt), port(xt)
    for got, want in zip(low, want_low):
        _assert_close_rel(got.numpy(), want, 1e-9)
    for e in range(full.shape[0]):
        _assert_close_rel(full[e].numpy(), want_full[e], 1e-9)


# ---------------------------------------------------------------- evaluators
def _batches():
    rng = np.random.RandomState(5)
    batches = [{"image": rng.rand(4, 32, 32, 3).astype(np.float32),
                "label": rng.randint(0, 6, (4, 32, 32)).astype(np.int32)} for _ in range(2)]
    batches[1]["count"] = 3  # padded tail row, masked out of every count
    return batches


def _assert_same_result(got, want):
    assert list(got) == list(want)
    for k in want:
        # empty exit buckets give NaN mIoU (reference semantics) on both sides
        assert got[k] == pytest.approx(want[k], rel=1e-6, nan_ok=True), k


@pytest.mark.parametrize("head", ["plain", "kernel"])
def test_miou_evaluator_matches_jax(tiny_model, tiny_state, tiny_port, tiny_vars, head):
    from ee_semantic_segmentation_tpu.ee import batch_eval as JE
    from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE

    state = tiny_state.replace(params=tiny_vars["params"], batch_stats=tiny_vars["batch_stats"])
    if head == "kernel":
        jstep = JE.make_pallas_miou_step_fn(tiny_model, 5)
        tstep = TE.make_kernel_miou_step_fn(tiny_port, 5)
    else:
        jstep = tstep = None
    want = JE.mIoU_evaluator_fused(tiny_model, state, 2, 5, _batches(), step=jstep)
    got = TE.mIoU_evaluator_fused(tiny_port, 2, 5, _batches(), step=tstep)
    _assert_same_result(got, want)


@pytest.mark.parametrize("head", ["plain", "kernel"])
def test_entropy_evaluator_matches_jax(tiny_model, tiny_state, tiny_port, tiny_vars, head):
    from ee_semantic_segmentation_tpu.ee import batch_eval as JE
    from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE

    state = tiny_state.replace(params=tiny_vars["params"], batch_stats=tiny_vars["batch_stats"])
    kw = dict(pallas_head=head == "kernel")
    want = JE.br_evaluator_entropy_fused(tiny_model, state, 2, 5, _batches(), 0.97, **kw)
    got = TE.br_evaluator_entropy_fused(tiny_port, 2, 5, _batches(), 0.97, **kw)
    _assert_same_result(got, want)
    assert got["b1_count"] + got["count_out"] == got["out_gl"] == 7


# ---------------------------------------------------------------- checkpoint, data, CLI
def test_checkpoint_roundtrip_and_sidecar_schema(tmp_path, tiny_port):
    from ee_semantic_segmentation_tpu.train.checkpoint import load_config as j_load_config
    from ee_semantic_segmentation_tpu_torch.train import checkpoint as TC

    path = TC.save_checkpoint(str(tmp_path), "tiny", tiny_port, tiny_port.config)
    # the JAX package reads the port's sidecar into the same config
    assert dataclasses.asdict(j_load_config(path)) == dataclasses.asdict(tiny_port.config)
    loaded = TC.load_model(path, torch.device("cpu"))
    assert loaded.config == tiny_port.config and not loaded.training
    want = tiny_port.state_dict()
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    x = torch.from_numpy(_images())
    with torch.inference_mode():
        # the loaded model is channels-last: another conv association
        _assert_close_rel(loaded(x).numpy(), tiny_port(x).numpy(), 1e-5)
    with pytest.raises(FileNotFoundError, match=r"\.json"):
        TC.load_model(str(tmp_path / "missing"), torch.device("cpu"))


def test_synthetic_data_and_loader_match_jax():
    from ee_semantic_segmentation_tpu.data.loader import DataLoader as JL
    from ee_semantic_segmentation_tpu.data.synthetic import SyntheticSegDataset as JS
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader as TL
    from ee_semantic_segmentation_tpu_torch.data.synthetic import SyntheticSegDataset as TS

    for jb, tb in zip(JL(JS(size=24, n=5, seed=2), 3), TL(TS(size=24, n=5, seed=2), 3)):
        assert jb["count"] == tb["count"]
        np.testing.assert_array_equal(jb["image"], tb["image"])
        np.testing.assert_array_equal(jb["label"], tb["label"])
    with pytest.raises(NotImplementedError, match="shard_by_process"):
        TL(TS(size=8, n=2), 1, shard_by_process=True)


def test_append_csv_writes_the_jax_layout(tmp_path):
    from ee_semantic_segmentation_tpu.cli.common import append_csv as j_append
    from ee_semantic_segmentation_tpu_torch.cli.common import append_csv as t_append

    res = {"net_id": ["a", "b"], "b1_mIoU": [0.25, float("nan")], "b1_count": [3, 0],
           "t": [0.5, 0.5], "pool": ["ent", "ent"]}
    for fillna in (None, 0):
        for fn, name in ((j_append, "j.csv"), (t_append, "t.csv")):
            for _ in range(2):  # header once, rows appended
                fn(res, str(tmp_path / f"{fillna}{name}"), fillna=fillna)
        assert (tmp_path / f"{fillna}t.csv").read_text() == (tmp_path / f"{fillna}j.csv").read_text()


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    torch.manual_seed(0)
    model = TB.build_branchy_deeplabv3(depth=50, n=1, img_dim=32, num_classes=21)
    return save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), "tiny21", model, model.config)


def test_cli_asks_for_cpu_explicitly_without_cuda(tiny_ckpt):
    from ee_semantic_segmentation_tpu_torch.cli import eval_br_ent, eval_miou

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    for cli in (eval_miou, eval_br_ent):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["-M", tiny_ckpt, "-c", "21", "-D", "32", "32", "-d", "synthetic"])


def test_cli_end_to_end_on_cpu(tiny_ckpt, tmp_path, monkeypatch):
    """Both CLIs, both heads: reference CSV schemas, equal results across
    heads, exit counts summing to the 16 synthetic test images."""
    from ee_semantic_segmentation_tpu_torch.cli import eval_br_ent, eval_miou

    monkeypatch.chdir(tmp_path)
    base = ["-M", tiny_ckpt, "-c", "21", "-D", "32", "32", "-d", "synthetic", "-b", "12",
            "--device", "cpu"]
    for head in ([], ["--pallas_head"]):
        eval_miou.main(base + ["-s", "miou"] + head)
        eval_br_ent.main(base + ["-s", "ent", "-t", "0.97"] + head)
    miou = [line.split(",") for line in (tmp_path / "miou.csv").read_text().splitlines()]
    ent = [line.split(",") for line in (tmp_path / "ent.csv").read_text().splitlines()]
    assert miou[0] == ["net_id", "b1_mIoU", "mIoU"] and len(miou) == 3
    assert ent[0] == ["net_id", "b1_mIoU", "b1_count", "mIoU_out", "count_out", "mIoU_gl",
                      "out_gl", "t", "pool", "pool_size"] and len(ent) == 3
    for rows in (miou, ent):
        plain, kernel = rows[1], rows[2]
        assert plain[0] == kernel[0] == "tiny21"
        for a, b in zip(plain[1:], kernel[1:]):
            try:
                assert float(a) == pytest.approx(float(b), rel=1e-6, abs=1e-12)
            except ValueError:
                assert a == b
    for row in ent[1:]:
        assert int(row[2]) + int(row[4]) == int(row[6]) == 16


# ---------------------------------------------------------------- isolation
def _port_modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        yield ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)


def test_port_never_imports_jax_at_run_time():
    """Import every module of the port (and chip_smoke) in a fresh process:
    neither jax, flax nor any module of the JAX package may load."""
    code = (
        "import importlib, sys\n"
        f"for m in {list(_port_modules())!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ee_semantic_segmentation_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax_import():
    """Statically, including imports inside functions (chip_smoke's)."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "ee_semantic_segmentation_tpu"), (f, n)
