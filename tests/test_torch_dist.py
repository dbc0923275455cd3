"""The port's data parallelism (``parallel/mesh.py``; the global-batch
BatchNorm, losses and train step) at world 2 over gloo, on the CPU.

One 2-rank job per module (``tests/torch_dist_cases.py``, group
``train``, rendezvous through a ``file://`` store in a temporary folder)
runs one SGD step of every case, and its rank 0 the same step in one
process on the whole global batch; it saves the differences and the
losses.  Meanwhile this process runs the JAX package's step on its
8-virtual-device mesh (conftest) beside the port's one-process step, from
the conftest ``tiny_model``'s perturbed weights carried over by
``load_flax_variables``, in float64 with dropout off, as
``tests/test_torch_train.py`` does.  The full-width model's states are
compared where they are made and never written out (they would take
gigabytes): world 2 is held to the JAX mesh through world 1,
max|w2 - jax| <= max|w2 - w1| + max|w1 - jax|.  The evaluators, the
masked engine, the loader, the trainer and the CLIs under ``torchrun`` are
in ``tests/test_torch_dist_eval.py``.

Tolerances:

* world 2 against world 1: the loss and every parameter and BatchNorm
  running statistic within ``TOL_WORLD`` relative (the global statistics
  and sums are taken in another order); the histogram loss (``-G``) sums
  its errors in float32, so its loss value is held to ``HIST_LOSS_RTOL``;
* world 2 against the JAX mesh step, for the four losses at a global batch
  of 8 (one image a JAX device): ``tests/test_torch_train.py``'s
  ``TOL_LOCKSTEP`` (``HIST_LOSS_RTOL`` for the ``-G`` loss value).  The
  JAX mesh replicates a batch that its 8 devices do not divide, so at
  ``accum_steps=2`` (micro-batches of 4) and at global batches of 3 and 1
  its step is the one-device step, which ``tests/test_torch_train.py``
  holds the port's one-process step to; here those cases are held to the
  port's one-process step;
* parameters across the ranks: bit for bit.
"""

import dataclasses
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_cases as cases
from test_torch_port import _perturbed_variables, _port_model

TOL_WORLD = 1e-10
TOL_LOCKSTEP = 1e-8
HIST_LOSS_RTOL = 1e-6
WORLD = 2
JAX_CASES = ("lovasz", "per_image", "hist1024", "ce")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f64(tree):
    if hasattr(tree, "items"):
        return {k: _f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def write_config(tiny_model, directory, which, **replace):
    with open(os.path.join(directory, "config.json"), "w") as fh:
        json.dump({which: dataclasses.asdict(dataclasses.replace(tiny_model.config,
                                                                  **replace))}, fh)


def launch(directory, group, extra=()):
    """Start the two ranks of ``group`` (and the ``extra`` commands, each
    (argv, working folder)) in fresh processes without a launcher's
    environment."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    script = os.path.join(REPO, "tests", "torch_dist_cases.py")
    runs = [([sys.executable, script, group, str(r), str(WORLD), directory], directory)
            for r in range(WORLD)]
    runs += [([sys.executable, *argv], cwd) for argv, cwd in extra]
    return [subprocess.Popen(argv, env=env, cwd=cwd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT) for argv, cwd in runs]


def finish(procs, directory, work):
    """Run ``work()`` here while ``procs`` run, then wait for them (killed
    on any failure); returns (``work()``'s result, the ranks' results)."""
    try:
        result = work()
        deadline = time.monotonic() + 900
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(
        log.decode(errors="replace")[-3000:] for log in logs)
    return result, [dict(np.load(os.path.join(directory, f"rank{r}.npz")))
                    for r in range(WORLD)]


def _jax_train(tiny_model, variables, directory, name):
    """The JAX package's train step of case ``name`` on the 8-device mesh,
    float64, against the port's one-process step: (JAX loss, port loss,
    {state entry: (max|port - jax|, max|jax|)})."""
    from ee_semantic_segmentation_tpu_torch.models.from_jax import _flatten, _torch_name
    from ee_semantic_segmentation_tpu.models import branchy_deepv3 as JB
    from ee_semantic_segmentation_tpu.ops import branchy as JBr
    from ee_semantic_segmentation_tpu.ops import xentropy as JX
    from ee_semantic_segmentation_tpu.parallel import make_mesh
    from ee_semantic_segmentation_tpu.parallel.train_step import TrainState, make_train_step
    from ee_semantic_segmentation_tpu.train import optim as JO
    from test_torch_train import _numpy_tree

    kind, kw, _, accum = cases.TRAIN_CASES[name]
    cfg = dataclasses.replace(tiny_model.config, head_dropout=0.0)
    with jax.enable_x64(True):
        model = JB.BranchyDeepLabV3(config=cfg, dtype=jnp.float64)
        tx = JO.sgd_momentum(JO.branchy_lr_multipliers(1, cases.LR))
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = TrainState(params=params, batch_stats=jax.tree.map(jnp.asarray,
                                                                   variables["batch_stats"]),
                           opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(0))
        if kind == "ce":
            loss = JX.BrXEntropyLoss(ignore_index=cases.VOID, b_reduction="sum", n_exits=2)
        else:
            loss = JBr.LovaszSoftmax(ignore=cases.VOID, n_branches=1, **kw)
        if accum > 1:  # the accumulation scan sums its loss in float32
            loss = (lambda fn: lambda out, labels: fn(out, labels).astype(jnp.float32))(loss)
        step = make_train_step(model, loss, tx, mesh=make_mesh(), donate=False,
                               accum_steps=accum)
        images, labels = cases.train_batch(name)
        state, m = step(state, jnp.asarray(images), jnp.asarray(labels), jnp.float64(cases.LR))
        want = {"params": _numpy_tree(state.params), "batch_stats": _numpy_tree(state.batch_stats)}
    loss_one, got = cases.train_step_state(directory, name, None)
    errors = {}
    for collection in ("params", "batch_stats"):
        for path, w in _flatten(want[collection]):
            k = _torch_name(collection, path)
            w = torch.from_numpy(w.transpose(3, 2, 0, 1) if w.ndim == 4 else w)
            errors[k] = (float((got[k] - w).abs().max()), float(w.abs().max()))
    return float(m["loss"]), loss_one, errors


@pytest.fixture(scope="module")
def dist(tiny_model, tiny_state, tmp_path_factory):
    """Every train case at world 2 (both ranks) and at world 1, and the JAX
    mesh step of ``JAX_CASES``; the folder is removed at teardown."""
    folder = tmp_path_factory.mktemp("dist")
    directory = str(folder)
    try:
        train_vars = _f64(_perturbed_variables(tiny_state, seed=0))
        write_config(tiny_model, directory, "train", head_dropout=0.0)
        torch.save(_port_model(tiny_model, train_vars, torch.float64).state_dict(),
                   os.path.join(directory, "train.pt"))
        procs = launch(directory, "train")
        jax_train, ranks = finish(procs, directory, lambda: {
            name: _jax_train(tiny_model, train_vars, directory, name) for name in JAX_CASES})
        yield {"ranks": ranks, "jax_train": jax_train}
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def _train_keys(out, name):
    prefix = f"train/{name}/"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


# ------------------------------------------------------------ the process group
def test_initialize_multihost_without_launcher_is_one_process(monkeypatch):
    from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

    for k in pm.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert pm.initialize_multihost() is None
    assert pm.initialize_multihost(device="cuda") is None  # no launcher: no CUDA needed
    assert not torch.distributed.is_initialized() and pm.is_primary()


def test_initialize_multihost_with_an_unreachable_address_raises():
    """Explicit arguments mean several processes: a rendezvous nobody
    serves (a local port with no listener) raises, never one process."""
    from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):  # torch's DistNetworkError or DistStoreError
        pm.initialize_multihost(f"tcp://127.0.0.1:{port}", 2, 1, device="cpu",
                                timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()


def test_height_sharding_raises_naming_a6b():
    from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

    with pytest.raises(NotImplementedError, match="A6b"):
        pm.make_mesh_2d(sp=2)
    assert pm.space_size(None) == 1


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shard_rows_are_contiguous_blocks_in_rank_order(world):
    from ee_semantic_segmentation_tpu_torch.parallel.mesh import DataMesh, shard_batch, shard_rows

    for n in range(0, 10):
        meshes = [DataMesh(None, world, r, torch.device("cpu")) for r in range(world)]
        blocks = [shard_rows(n, m) for m in meshes]
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        sizes = [b - a for a, b in blocks]
        assert max(sizes) - min(sizes) <= 1
        x = np.arange(n)
        np.testing.assert_array_equal(np.concatenate([shard_batch(m, x) for m in meshes]), x)


# ------------------------------------------------------------------ train step
@pytest.mark.parametrize("name", list(cases.TRAIN_CASES))
def test_train_step_world2_matches_world1(dist, name):
    """The loss, every parameter and every BatchNorm running statistic after
    one step at world 2 against one process on the whole global batch."""
    got = _train_keys(dist["ranks"][0], name)
    rtol_loss = HIST_LOSS_RTOL if "hist" in name else TOL_WORLD
    np.testing.assert_allclose(got["loss"], got["loss_one"], rtol=rtol_loss, atol=0)
    names = [k[len("one/err/"):] for k in got if k.startswith("one/err/")]
    assert names
    for k in names:
        err, scale = got[f"one/err/{k}"], got[f"one/scale/{k}"]
        tol = 0.0 if k.endswith("num_batches_tracked") else TOL_WORLD * scale
        assert err <= tol, f"{k}: max|d| {err:.3g}, max|want| {scale:.3g}"


@pytest.mark.parametrize("name", JAX_CASES)
def test_train_step_world2_matches_jax_mesh(dist, name):
    want_loss, loss_one, errors = dist["jax_train"][name]
    got = _train_keys(dist["ranks"][0], name)
    rtol = HIST_LOSS_RTOL if "hist" in name else TOL_LOCKSTEP
    np.testing.assert_allclose(got["loss"], want_loss, rtol=rtol, atol=0)
    n_state = sum(k.startswith("one/err/") and not k.endswith("num_batches_tracked") for k in got)
    assert len(errors) == n_state  # every parameter and running statistic
    for k, (err_one_jax, scale) in errors.items():
        bound = float(got[f"one/err/{k}"]) + err_one_jax  # >= max|w2 - jax|
        assert bound <= TOL_LOCKSTEP * scale, f"{k}: max|d| <= {bound:.3g}, max|want| {scale:.3g}"


@pytest.mark.parametrize("name", list(cases.TRAIN_CASES))
def test_parameters_bit_identical_across_ranks(dist, name):
    for rank in dist["ranks"]:
        got = _train_keys(rank, name)
        assert bool(got["identical"])  # every state entry and the loss, on every rank
    assert _train_keys(dist["ranks"][0], name)["loss"] == _train_keys(dist["ranks"][1], name)["loss"]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_padded_blocks_are_the_jax_pad_to_devices_layout(world):
    """With ``pad`` the batch is padded to a multiple of the world with
    repeats of its last row and split into equal blocks, and ``count`` is
    rebased to each block, as the JAX package's ``_pad_to_devices``."""
    from ee_semantic_segmentation_tpu_torch.parallel.mesh import DataMesh, shard_batch

    for n in range(1, 10):
        for count in range(0, n + 1):
            meshes = [DataMesh(None, world, r, torch.device("cpu")) for r in range(world)]
            x = np.arange(n)
            parts = [shard_batch(m, {"image": x, "label": torch.from_numpy(x), "count": count},
                                 pad=True) for m in meshes]
            m = -(-n // world)
            padded = np.concatenate([x, np.repeat(x[-1:], m * world - n)])
            np.testing.assert_array_equal(np.concatenate([p["image"] for p in parts]), padded)
            np.testing.assert_array_equal(torch.cat([p["label"] for p in parts]).numpy(), padded)
            assert [p["count"] for p in parts] == [min(max(count - r * m, 0), m)
                                                   for r in range(world)]


def test_empty_shard_case_really_has_an_empty_rank():
    from ee_semantic_segmentation_tpu_torch.parallel.mesh import DataMesh, shard_rows

    assert [shard_rows(1, DataMesh(None, WORLD, r, None)) for r in range(WORLD)] == [(0, 1),
                                                                                     (1, 1)]
    assert cases.TRAIN_CASES["batch1"][2] == 1 and cases.TRAIN_CASES["batch3"][2] == 3


def test_collectives_were_issued(dist):
    for rank in dist["ranks"]:
        assert rank["collectives/all_reduce"] > 0 and rank["collectives/all_gather"] > 0
