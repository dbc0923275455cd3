"""The port's data-parallel evaluation and training loop at world 2 over
gloo, on the CPU: the fused evaluators (kernel heads A, B and C through
their plain versions), the image-level evaluator, the masked engine, the
``shard_by_process`` loader, ``replicate``, the trainer's decisions, and
the CLIs under ``torch.distributed.run``.

One 2-rank job per module (``tests/torch_dist_cases.py``, group ``eval``,
rendezvous through a ``file://`` store) runs every case, and its rank 0
the evaluators in one process on the whole global batch; the CLIs run
under the launcher (2 ranks) beside the same CLIs in this process; and
this process runs the JAX package's evaluators and masked engine on its
8-virtual-device mesh, from the conftest ``tiny_model``'s perturbed
weights.  Counts, exits and maps against world 1 and CSVs against one
process: bit for bit.  Against the JAX mesh: counts and exits equal, mIoU
within 1e-6 relative and maps on ``TOL_MAP_AGREE`` of the pixels
(``tests/test_torch_ee.py``'s; the two frameworks' float32 logits differ
in their roundings).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dist_cases as cases
from test_torch_dist import WORLD, finish, launch, write_config
from test_torch_port import _perturbed_variables, _port_model

TOL_MAP_AGREE = 0.99999
# the trainer in float64: world 2 against one process after one epoch, the
# epoch loss and every state entry relative to its largest value
TOL_TRAINER = 1e-9
EVALUATORS = ("miou_plain", "miou_kernel", "entropy", "similarity", "images")


def _split_tau(port, images):
    """The midpoint of the widest gap between the branch exit's entropies."""
    from ee_semantic_segmentation_tpu_torch.ops.gating import batched_norm_entropy

    with torch.inference_mode():
        ent = sorted(batched_norm_entropy(port(torch.from_numpy(images))[:1], 5, "none", 1)[0]
                     .tolist())
    gaps = [(b - a, (a + b) / 2) for a, b in zip(ent, ent[1:])]
    width, tau = max(gaps)
    assert width > 1e-4, ent
    return tau


def _jax_eval(tiny_model, state, data):
    """The JAX package's evaluators and masked engine on the 8-device mesh,
    in the layout of ``torch_dist_cases.eval_cases``."""
    from ee_semantic_segmentation_tpu.ee import batch_eval as JE
    from ee_semantic_segmentation_tpu.ee.masked import make_masked_gated_apply
    from ee_semantic_segmentation_tpu.parallel import make_eval_step, make_mesh

    mesh = make_mesh()
    tau, sim_tau = float(data["ent_tau"]), float(data["sim_tau"])
    batches = cases.eval_batches(data)
    out = {}
    out.update(cases.numeric("miou_plain", JE.mIoU_evaluator_fused(
        tiny_model, state, 2, 5, batches, mesh=mesh)))
    out.update(cases.numeric("miou_kernel", JE.mIoU_evaluator_fused(
        tiny_model, state, 2, 5, batches,
        step=JE.make_pallas_miou_step_fn(tiny_model, 5, mesh=mesh))))
    out.update(cases.numeric("entropy", JE.br_evaluator_entropy_fused(
        tiny_model, state, 2, 5, batches, tau, pallas_head=True, mesh=mesh)))
    out.update(cases.numeric("similarity", JE.br_evaluator_similarity_fused(
        tiny_model, state, 2, 5, batches, "ssim", sim_tau, ignore=(4,), pallas_head=True,
        mesh=mesh)))
    fwd = make_eval_step(tiny_model, mesh)
    out.update(cases.numeric("images", JE.br_evaluator_similarity(
        lambda x: fwd(state.params, state.batch_stats, jnp.asarray(x)), 2, 5, batches, "nmi",
        sim_tau, ignore=(4,), image_level=True)))
    fn = make_masked_gated_apply(
        tiny_model, {"params": state.params, "batch_stats": state.batch_stats}, tau=tau,
        n_classes=5, pallas_head=True, mesh=mesh)
    for i, batch in enumerate(batches):
        x = np.concatenate([batch["image"], batch["image"][-1:].repeat(3, 0)])  # 8 devices
        labels, exits = fn(jnp.asarray(x))
        out[f"masked/labels{i}"] = np.asarray(labels)[:5]
        out[f"masked/exits{i}"] = np.asarray(exits)[:5]
    return out


@pytest.fixture(scope="module")
def dist(tiny_model, tiny_state, tmp_path_factory):
    """The eval group at world 2 (both ranks, rank 0 also at world 1), the
    CLIs under the launcher and in this process, and the JAX mesh runs;
    the folder is removed at teardown."""
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    folder = tmp_path_factory.mktemp("dist_eval")
    directory = str(folder)
    try:
        eval_vars = _perturbed_variables(tiny_state, seed=1)
        write_config(tiny_model, directory, "eval")
        port = _port_model(tiny_model, eval_vars)
        torch.save(port.state_dict(), os.path.join(directory, "eval.pt"))
        save_checkpoint(directory, "tiny", port, port.config)  # for the CLIs
        rng = np.random.RandomState(12)
        images = rng.rand(8, 32, 32, 3).astype(np.float32)
        labels = rng.randint(0, 6, (8, 32, 32)).astype(np.int32)
        np.savez(os.path.join(directory, "data.npz"), eval_images=images, eval_labels=labels,
                 ent_tau=_split_tau(port, images), sim_tau=0.5)
        for sub in ("cli_one", "cli_dp"):
            os.mkdir(os.path.join(directory, sub))
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_cases.py")
        procs = launch(directory, "eval", [(
            ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={WORLD}", script,
             "cli", directory], os.path.join(directory, "cli_dp"))])

        def here():
            cwd = os.getcwd()
            os.chdir(os.path.join(directory, "cli_one"))
            try:
                cases.run_clis(directory)
            finally:
                os.chdir(cwd)
            state = tiny_state.replace(params=eval_vars["params"],
                                       batch_stats=eval_vars["batch_stats"])
            return _jax_eval(tiny_model, state, np.load(os.path.join(directory, "data.npz")))

        jax_eval, ranks = finish(procs, directory, here)
        csvs = {sub: {name: open(os.path.join(directory, sub, name)).read()
                      for name in sorted(os.listdir(os.path.join(directory, sub)))}
                for sub in ("cli_one", "cli_dp")}
        yield {"ranks": ranks, "jax_eval": jax_eval, "csvs": csvs}
    finally:
        shutil.rmtree(folder, ignore_errors=True)


# ------------------------------------------------------------ loader, trainer
def test_shard_by_process_batches_partition_the_jax_global_batch(dist):
    """At per-rank batch b the ranks' k-th batches together are the JAX
    one-process batch k of W*b: rank r holds its rows j*W + r."""
    from ee_semantic_segmentation_tpu.data.loader import DataLoader as JL
    from ee_semantic_segmentation_tpu.data.synthetic import SyntheticSegDataset as JS

    L = cases.LOADER
    want = list(JL(JS(size=8, n=L["n"], seed=4), WORLD * L["batch"], shuffle=True,
                   seed=L["seed"]))
    for k, jb in enumerate(want):
        rows = jb["image"][: jb["count"]]
        for r, rank in enumerate(dist["ranks"]):
            np.testing.assert_array_equal(rank[f"loader/image{k}"], rows[r::WORLD])
    assert f"loader/image{len(want)}" not in dist["ranks"][0]


def test_replicate_gives_every_rank_rank0s_weights(dist):
    a, b = dist["ranks"]
    keys = [k for k in a if k.startswith("replicate/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_trainer_decisions_equal_on_every_rank(dist):
    """Validation counts are all-reduced, so each rank's tracker (losses,
    per-exit validation mIoU, learning rates) is the same and the LR and
    early-stopping decisions agree without a broadcast; rank 0 wrote the
    best checkpoint, which every rank sees."""
    a, b = dist["ranks"]
    keys = sorted(k for k in a if k.startswith("trainer/"))
    assert "trainer/lr" in keys and "trainer/val_mIoU_b1_mIoU" in keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bool(a["trainer/saved"]) and bool(b["trainer/saved"])


@pytest.mark.parametrize("name", list(cases.TRAINER_CASES))
def test_trainer_world2_matches_one_process(dist, name):
    """One epoch of the trainer at world 2 against one process: every rank
    takes the same steps (17 images at batch 16: a full and a padded batch
    on both ranks), micro-batches are those of the global batch, and the
    epoch loss, the parameters and the BatchNorm running statistics agree
    within ``TOL_TRAINER``."""
    a, b = dist["ranks"]
    prefix = f"trainer_{name}/"
    np.testing.assert_array_equal(a[prefix + "loss"], b[prefix + "loss"])
    np.testing.assert_allclose(a[prefix + "loss"], a[prefix + "loss_one"], rtol=TOL_TRAINER)
    names = [k[len(prefix + "one/err/"):] for k in a if k.startswith(prefix + "one/err/")]
    assert names
    for k in names:
        err, scale = a[f"{prefix}one/err/{k}"], a[f"{prefix}one/scale/{k}"]
        tol = 0.0 if k.endswith("num_batches_tracked") else TOL_TRAINER * scale
        assert err <= tol, f"{k}: max|d| {err:.3g}, max|want| {scale:.3g}"


def test_clis_under_torchrun_write_the_one_process_rows(dist):
    """eval_miou, eval_br_ent (kernel heads A and B through their plain
    versions), eval_br_images and ee_dnn_op_ne --engine masked under
    ``torch.distributed.run`` at world 2: rank 0 alone writes, and every
    CSV equals the one-process run's byte for byte."""
    one, dp = dist["csvs"]["cli_one"], dist["csvs"]["cli_dp"]
    assert sorted(one) == sorted(cases.cli_args("", 0.5)) == sorted(dp)
    for name in one:
        assert dp[name] == one[name], name
        assert dp[name].count("\n") == 2, name  # the header and one row: rank 0 alone wrote


def test_collectives_were_issued(dist):
    for rank in dist["ranks"]:
        assert rank["collectives/all_reduce"] > 0 and rank["collectives/all_gather"] > 0
        assert rank["collectives/broadcast"] > 0 and rank["collectives/barrier"] > 0


# ------------------------------------------------------------------ evaluators
def _eval_keys(out, prefix):
    return {k: v for k, v in out.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("evaluator", EVALUATORS + ("masked",))
def test_evaluator_world2_equals_world1(dist, evaluator):
    one = {k[len("one/"):]: v for k, v in _eval_keys(
        {k: v for k, v in dist["ranks"][0].items() if k.startswith("one/")}, "one/" + evaluator
    ).items()}
    assert one
    for rank in dist["ranks"]:
        got = _eval_keys(rank, evaluator)
        assert sorted(got) == sorted(one)
        for k in one:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)


@pytest.mark.parametrize("evaluator", EVALUATORS + ("masked",))
def test_evaluator_world2_matches_jax_mesh(dist, evaluator):
    got = _eval_keys(dist["ranks"][0], evaluator)
    want = _eval_keys(dist["jax_eval"], evaluator)
    assert sorted(got) == sorted(want)
    for k in want:
        if "labels" in k:
            assert (got[k] == want[k]).mean() >= TOL_MAP_AGREE, k
        elif "count" in k or "exits" in k or k.endswith("/out_gl"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6, nan_ok=True), k
