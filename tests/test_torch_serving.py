"""The port's batched early-exit server (``ee/serving.py``) and serving
artifacts (``ee/aot.py``), on the CPU.

The server against the JAX package's ``BatchedEarlyExitServer`` on the
conftest ``tiny_model`` (one branch, 5 classes, 32 px) with the same
weights (``_perturbed_variables``), both in float64 so that the label maps
must be equal: the same exit of every image, the same maps, the same
``stats()`` and ``avg_flops_per_image``, in the all-exit, none-exit,
partial-flush and split cases of ``tests/test_serving.py``.  Both servers
take the entropy of a float32 softmax; a split tau lies in the widest gap
of the first exit's entropies, more than ``GATE_MARGIN`` from each.

The artifacts mirror ``tests/test_aot.py``: a round trip equals the live
model, the artifacts run in a process that imports only ``torch`` and the
kernel-operator module, a symbolic batch serves batches 1 and 3, a
symbolic batch with the kernel head raises, and the gated export equals
the eager masked engine, its graph holding the kernels' operators.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee_semantic_segmentation_tpu.models import branchy_deepv3 as JB
from test_torch_port import _perturbed_variables, _port_model, removes_tmp_path  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
N_CLASSES = 5
GATE_MARGIN = 1e-5  # least distance of a split tau from any entropy (float32 softmax)
TOL_EXPORT = 1e-5   # exported eval forward vs the live model, as tests/test_aot.py


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


# ------------------------------------------------------------------ server
@pytest.fixture(scope="module")
def served(tiny_model, tiny_state):
    """(JAX float64 model, its float64 variables, the port's float64 model)."""
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                       _perturbed_variables(tiny_state, seed=3))
    jm = JB.BranchyDeepLabV3(config=tiny_model.config, dtype=jnp.float64)
    return jm, v64, _port_model(tiny_model, v64, torch.float64)


def _split_tau(port, images):
    from ee_semantic_segmentation_tpu_torch.ops.gating import batched_norm_entropy

    dtype = next(port.parameters()).dtype
    with torch.inference_mode():
        ent = sorted(batched_norm_entropy(port(torch.from_numpy(images).to(dtype))[:1],
                                          N_CLASSES)[0].tolist())
    gap, i = max((ent[j + 1] - ent[j], j) for j in range(len(ent) - 1))
    assert gap > 2 * GATE_MARGIN, ent
    return (ent[i] + ent[i + 1]) / 2


SERVER_CASES = {  # id -> (tau, micro-batch, images)
    "all_exit": (2.0, 4, 10),
    "none_exit": (-1.0, 4, 6),
    "partial_flush": (-1.0, 8, 3),
    "split": ("split", 4, 10),
}


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_server_matches_jax(served, case):
    from ee_semantic_segmentation_tpu.ee.serving import BatchedEarlyExitServer as JServer
    from ee_semantic_segmentation_tpu_torch.ee.serving import BatchedEarlyExitServer as TServer

    jm, v64, port = served
    tau, B, n = SERVER_CASES[case]
    images = _images(n, seed=7)
    if tau == "split":
        tau = _split_tau(port, images)
    with jax.enable_x64(True):
        params = jax.tree.map(jnp.asarray, v64["params"])
        stats = jax.tree.map(jnp.asarray, v64["batch_stats"])
        jsrv = JServer(jm, params, stats, tau=tau, batch_size=B, n_classes=N_CLASSES)
        juids = jsrv.submit(images)
        want = jsrv.flush()
        want_stats = jsrv.stats()
    tsrv = TServer(port, tau=tau, batch_size=B, n_classes=N_CLASSES)
    uids = tsrv.submit(images)
    got = tsrv.flush()
    assert uids == juids and set(got) == set(want) == set(uids)
    for uid in uids:
        assert got[uid]["n"] == want[uid]["n"], uid
        assert got[uid]["label_map"].dtype == np.int32
        np.testing.assert_array_equal(got[uid]["label_map"], np.asarray(want[uid]["label_map"]))
    assert tsrv.stats() == want_stats
    assert tsrv.avg_flops_per_image == jsrv.avg_flops_per_image
    exits = [got[u]["n"] for u in uids]
    runs = want_stats["stage_runs"]
    if case == "all_exit":  # only stage 0 runs, and costs less than the full model
        table = port.flops_table(32)
        assert set(exits) == {1} and runs[0] > 0 and runs[1] == 0
        assert tsrv.avg_flops_per_image < sum(table["segments"]) + sum(table["branches"])
    elif case == "split":
        assert set(exits) == {1, 2}
    else:
        assert set(exits) == {2} and runs[-1] > 0
    if case == "partial_flush":
        assert want_stats["padded_slots"] == 2 * (B - n)  # both stages padded at flush


def test_server_keeps_the_model_device_and_dtype(served):
    """Images in float32 numpy run in the model's float64; results come back
    as numpy maps of the input size."""
    from ee_semantic_segmentation_tpu_torch.ee.serving import BatchedEarlyExitServer

    _, _, port = served
    srv = BatchedEarlyExitServer(port, tau=2.0, batch_size=2, n_classes=N_CLASSES)
    assert srv.dtype == torch.float64 and srv.device == torch.device("cpu")
    res = srv.flush()
    assert res == {} and srv.stats()["waves"] == 0
    srv.submit(_images(1))
    res = srv.flush()
    assert list(res) == [0] and res[0]["label_map"].shape == (32, 32)


# ------------------------------------------------------------------ export
@pytest.fixture(scope="module")
def tiny_port(tiny_model, tiny_state):
    return _port_model(tiny_model, _perturbed_variables(tiny_state, seed=4))


@pytest.fixture(scope="module")
def exported(tiny_port, tmp_path_factory):
    """The eval forward at batch 2 and the gated engine's kernel head at
    batch 2 and a tau that splits the two images, saved once for the
    module; the folder goes after its last test."""
    from ee_semantic_segmentation_tpu_torch.ee.aot import (
        export_eval_forward,
        export_gated,
        save_exported,
    )

    folder = tmp_path_factory.mktemp("aot")
    x = _images(2, seed=2)
    tau = _split_tau(tiny_port, x)
    fwd = save_exported(export_eval_forward(tiny_port, batch_size=2), str(folder / "fwd"),
                        {"head": "logits"})
    gated = save_exported(export_gated(tiny_port, 2, tau=tau, n_classes=N_CLASSES,
                                       pallas_head=True), str(folder / "gated"), {"head": "gated"})
    yield {"fwd": fwd, "gated": gated, "tau": tau, "x": x}
    shutil.rmtree(folder)


def test_export_roundtrip_matches_live_model(tiny_port, exported):
    from ee_semantic_segmentation_tpu_torch.ee.aot import load_exported, manifest_for

    x = torch.from_numpy(_images(2, seed=0))
    with torch.no_grad():
        want = tiny_port(x)
        got = load_exported(exported["fwd"]).module()(x)
    torch.testing.assert_close(got, want, rtol=TOL_EXPORT, atol=TOL_EXPORT)
    man = manifest_for(exported["fwd"])
    assert man["head"] == "logits" and man["device"] == "cpu" and man["format"] == "torch.export"
    assert man["in_avals"] == [{"shape": [2, 32, 32, 3], "dtype": "float32"}]
    assert man["out_avals"] == [{"shape": [2, 2, 32, 32, N_CLASSES], "dtype": "float32"}]
    assert man["bytes"] == os.path.getsize(exported["fwd"])
    with pytest.raises(FileNotFoundError, match="no exported artifact"):
        load_exported(exported["fwd"] + ".missing")


def test_exported_runs_without_model_code(tiny_port, exported):
    """A fresh process that imports torch, runs the eval-forward artifact,
    then imports only the kernel-operator module and runs the gated kernel
    head's artifact: the same outputs as the live model and engine, and no
    model module loaded."""
    from ee_semantic_segmentation_tpu_torch.ee.masked import make_masked_gated_apply

    x = exported["x"]
    with torch.no_grad():
        want_logits = tiny_port(torch.from_numpy(x)).numpy()
    want_labels, want_exits = make_masked_gated_apply(
        tiny_port, tau=exported["tau"], n_classes=N_CLASSES, pallas_head=True)(torch.from_numpy(x))
    folder = os.path.dirname(exported["fwd"])
    xp = os.path.join(folder, "x.npy")
    np.save(xp, x)
    code = (
        "import importlib, sys, numpy as np, torch\n"
        "torch.set_grad_enabled(False)\n"
        f"x = torch.from_numpy(np.load({xp!r}))\n"
        f"np.save({folder!r} + '/logits.npy', torch.export.load({exported['fwd']!r}).module()(x).numpy())\n"
        "importlib.import_module('ee_semantic_segmentation_tpu_torch.ops.kernels.upsample_argmax')\n"
        f"labels, exits = torch.export.load({exported['gated']!r}).module()(x)\n"
        f"np.save({folder!r} + '/labels.npy', labels.numpy())\n"
        f"np.save({folder!r} + '/exits.npy', exits.numpy())\n"
        "print(sorted(m for m in sys.modules if m.startswith('ee_semantic')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=folder,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert "ee_semantic_segmentation_tpu_torch.ops.kernels.upsample_argmax" in loaded
    assert not [m for m in loaded if ".models" in m or ".ee" in m or ".cli" in m
                or m.split(".")[0] == "ee_semantic_segmentation_tpu"], loaded
    np.testing.assert_allclose(np.load(os.path.join(folder, "logits.npy")), want_logits,
                               rtol=TOL_EXPORT, atol=TOL_EXPORT)
    np.testing.assert_array_equal(np.load(os.path.join(folder, "exits.npy")), want_exits.numpy())
    np.testing.assert_array_equal(np.load(os.path.join(folder, "labels.npy")), want_labels.numpy())


@pytest.mark.usefixtures("removes_tmp_path")
def test_symbolic_batch_export_serves_any_batch(tiny_port, tmp_path):
    from ee_semantic_segmentation_tpu_torch.ee.aot import (
        export_eval_forward,
        load_exported,
        manifest_for,
        save_exported,
    )

    path = str(tmp_path / "poly")
    save_exported(export_eval_forward(tiny_port, batch_size=None), path, {"head": "logits"})
    assert isinstance(manifest_for(path)["in_avals"][0]["shape"][0], str)
    program = load_exported(path).module()
    for n in (1, 3):
        x = torch.from_numpy(_images(n, seed=n))
        with torch.no_grad():
            want = tiny_port(x)
            got = program(x)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=TOL_EXPORT, atol=TOL_EXPORT)


def test_gated_symbolic_batch_rejects_pallas_head(tiny_port):
    from ee_semantic_segmentation_tpu_torch.ee.aot import export_gated

    with pytest.raises(ValueError, match="symbolic batch"):
        export_gated(tiny_port, None, tau=0.5, n_classes=N_CLASSES, pallas_head=True)


@pytest.mark.parametrize("head,tau_kind,batch", [("kernel", "split", 2), ("kernel", "above", 2),
                                                 ("plain", "split", None)])
def test_gated_export_matches_masked_engine(tiny_port, exported, head, tau_kind, batch):
    """Labels and exit indices of the exported engine equal the eager masked
    engine's.  The kernel head's graph holds kernel B's and C's operators
    and a ``cond`` a stage; at a tau above every entropy both images exit
    at the branch and the final stage is skipped.  The plain head exports
    with a symbolic batch and serves 2 and 3 images."""
    from ee_semantic_segmentation_tpu_torch.ee.aot import export_gated, load_exported
    from ee_semantic_segmentation_tpu_torch.ee.masked import make_masked_gated_apply

    tau = exported["tau"] if tau_kind == "split" else 2.0
    kernel = head == "kernel"
    if kernel and tau_kind == "split":
        ep = load_exported(exported["gated"])
    else:
        ep = export_gated(tiny_port, batch, tau=tau, n_classes=N_CLASSES, pallas_head=kernel)
    ops = [str(node.target) for gm in ep.graph_module.modules()
           if isinstance(gm, torch.fx.GraphModule) for node in gm.graph.nodes
           if node.op == "call_function"]
    assert ops.count("cond") == 2  # the branch's stage and the final stage
    assert ("ee_seg.upsample_entropy_argmax.default" in ops) == kernel
    assert ("ee_seg.upsample_argmax.default" in ops) == kernel
    live = make_masked_gated_apply(tiny_port, tau=tau, n_classes=N_CLASSES, pallas_head=kernel)
    assert live.kernel_head == kernel
    for x in (exported["x"], _images(3, seed=9)) if batch is None else (exported["x"],):
        x = torch.from_numpy(x)
        want_labels, want_exits = live(x)
        labels, exits = ep.module()(x)
        assert labels.dtype == exits.dtype == torch.int32
        assert torch.equal(exits, want_exits) and torch.equal(labels, want_labels)
        if tau_kind == "above":
            assert exits.tolist() == [1, 1]
        elif x.shape[0] == 2:
            assert sorted(exits.tolist()) == [1, 2]


@pytest.mark.usefixtures("removes_tmp_path")
def test_export_cli_writes_the_artifact(tmp_path, tiny_port):
    """``export_serving`` on a checkpoint: the logits head with a symbolic
    batch, the JAX tool's manifest keys, and a refusal of the kernel head at
    a symbolic batch."""
    from ee_semantic_segmentation_tpu_torch.cli import export_serving
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    ckpt = save_checkpoint(str(tmp_path), "tiny", tiny_port, tiny_port.config)
    out = str(tmp_path / "served")
    assert export_serving.main(["-M", ckpt, "-o", out, "--symbolic_batch",
                                "--device", "cpu"]) == out + ".pt2"
    man = json.loads(pathlib.Path(out + ".json").read_text())
    assert man["checkpoint"] == ckpt and man["head"] == "logits"
    assert man["batch_size"] == "symbolic" and man["n_exits"] == 2
    with pytest.raises(ValueError, match="symbolic batch"):
        export_serving.main(["-M", ckpt, "-o", out, "--symbolic_batch", "--head", "gated",
                             "--pallas_head", "--device", "cpu"])
