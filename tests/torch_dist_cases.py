"""The data-parallel cases of ``tests/test_torch_dist.py`` (GROUP
``train``) and ``tests/test_torch_dist_eval.py`` (GROUP ``eval``).

Each rank of a gloo group runs every case of its group and saves what it
got::

    python tests/torch_dist_cases.py GROUP RANK WORLD DIR
    python -m torch.distributed.run --standalone --nproc_per_node=2 \
        tests/torch_dist_cases.py cli DIR      # the CLIs, in the current folder

where ``DIR`` holds the inputs the test wrote (``config.json``,
``train.pt`` or ``eval.pt`` and the ``tiny`` checkpoint, ``data.npz``)
and the ``file://`` store of the rendezvous; rank r writes
``DIR/rank{r}.npz``.  Rank 0 also runs the train and eval cases without a
group (``mesh=None``) on the whole global batch, the one-process results
the tests hold the ranks to.  This module imports the port and never JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
from ee_semantic_segmentation_tpu_torch.data.synthetic import SyntheticSegDataset
from ee_semantic_segmentation_tpu_torch.ee import batch_eval as TE
from ee_semantic_segmentation_tpu_torch.ee.masked import make_masked_gated_apply
from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import (
    BranchyConfig,
    BranchyDeepLabV3,
)
from ee_semantic_segmentation_tpu_torch.ops.branchy import LovaszSoftmax
from ee_semantic_segmentation_tpu_torch.ops.xentropy import BrXEntropyLoss
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm
from ee_semantic_segmentation_tpu_torch.parallel.train_step import make_train_step
from ee_semantic_segmentation_tpu_torch.train import optim as TO

N_CLASSES = 5
VOID = 5
LR = 0.05
TRAIN_CASES = {
    # name: (loss, loss kwargs, global batch, accum_steps)
    "lovasz": ("lovasz", {}, 8, 1),
    "per_image": ("lovasz", {"per_image": True}, 8, 1),
    "hist1024": ("lovasz", {"hist_bins": 1024}, 8, 1),
    "ce": ("ce", {}, 8, 1),
    # the JAX mesh replicates a batch or micro-batch that its 8 devices do
    # not divide, so from here on its step is the one-device step
    "accum2": ("lovasz", {}, 8, 2),
    "batch3": ("lovasz", {}, 3, 1),
    "batch1": ("lovasz", {}, 1, 1),
}
LOADER = dict(n=11, batch=2, seed=5)  # per-rank batch; the one-process batch is world * 2


def make_loss(kind, kw, mesh=None):
    if kind == "ce":
        return BrXEntropyLoss(ignore_index=VOID, b_reduction="sum", n_exits=2, mesh=mesh)
    return LovaszSoftmax(ignore=VOID, n_branches=1, mesh=mesh, **kw)


def train_batch(name, seed=3):
    """The global batch of a train case: float64 images, labels with void."""
    B = TRAIN_CASES[name][2]
    rng = np.random.RandomState(seed + B)
    labels = rng.randint(0, VOID, (B, 32, 32))
    labels[rng.rand(B, 32, 32) < 0.1] = VOID
    return rng.rand(B, 32, 32, 3), labels.astype(np.int32)


def load_model(directory, which, dtype, **replace):
    with open(os.path.join(directory, "config.json")) as fh:
        cfg = dict(json.load(fh)[which], **replace)
    for k in ("segment_ends", "branch_channels"):
        cfg[k] = tuple(cfg[k])
    with torch.device("meta"):  # skip the random init the weights replace
        model = BranchyDeepLabV3(BranchyConfig(**cfg))
    state = torch.load(os.path.join(directory, f"{which}.pt"), weights_only=True)
    model.load_state_dict(state, assign=True)
    return model.to(dtype)


def train_step_state(directory, name, mesh):
    """One SGD step of case ``name`` on its global batch (of which each rank
    runs its rows, with a mesh) -> (loss, the model's state dict after it)."""
    kind, kw, _, accum = TRAIN_CASES[name]
    model = load_model(directory, "train", torch.float64)
    opt = TO.make_optimizer(model, TO.branchy_lr_multipliers(1, LR))
    step = make_train_step(model, make_loss(kind, kw, mesh), opt, accum_steps=accum, mesh=mesh)
    images, labels = train_batch(name)
    loss = step(torch.from_numpy(images), torch.from_numpy(labels), LR)
    return float(loss), model.state_dict()


def max_errors(prefix, got, want):
    """{prefix/err/k: max|got[k] - want[k]|, prefix/scale/k: max|want[k]|}."""
    out = {}
    for k, w in want.items():
        w = torch.as_tensor(w, dtype=torch.float64)
        out[f"{prefix}/err/{k}"] = np.asarray(float((got[k].double() - w).abs().max()))
        out[f"{prefix}/scale/{k}"] = np.asarray(float(w.abs().max()))
    return out


def train_case(directory, name, mesh):
    """Case ``name`` at world W: the loss, whether the state after the step
    is bit-identical on every rank, and on rank 0 the one-process step on
    the whole batch beside it (its loss and, per state entry, the largest
    difference and the largest value).  Full state dicts of the full-width
    model are not written out: they would take gigabytes."""
    loss, state = train_step_state(directory, name, mesh)
    same = all(bool((pm.all_gather(v, mesh) == v).all()) for v in state.values())
    same &= bool((pm.all_gather(torch.tensor([loss], dtype=torch.float64), mesh) == loss).all())
    out = {"loss": np.asarray(loss), "identical": np.asarray(same)}
    if mesh.rank == 0:
        loss_one, state_one = train_step_state(directory, name, None)
        out["loss_one"] = np.asarray(loss_one)
        out.update(max_errors("one", state, state_one))
    return out


def eval_batches(data):
    """Two host batches of 5: the second has 3 valid rows and 2 padded."""
    images, labels = data["eval_images"], data["eval_labels"]
    return [{"image": images[:5], "label": labels[:5]},
            {"image": np.concatenate([images[5:], images[7:8].repeat(2, 0)]),
             "label": np.concatenate([labels[5:], labels[7:8].repeat(2, 0)]), "count": 3}]


def numeric(prefix, res):
    return {f"{prefix}/{k}": np.asarray(v, np.float64) for k, v in res.items()
            if not isinstance(v, str)}


def eval_cases(directory, data, mesh):
    """The four fused evaluators (plain head, kernel heads A, B and C), the
    image-level similarity evaluator, and the masked engine's maps and
    exits on micro-batches of 5."""
    model = load_model(directory, "eval", torch.float32).eval()
    tau, sim_tau = float(data["ent_tau"]), float(data["sim_tau"])
    out = {}
    for head, step in (("plain", None), ("kernel", TE.make_kernel_miou_step_fn(model, N_CLASSES))):
        out.update(numeric(f"miou_{head}", TE.mIoU_evaluator_fused(
            model, 2, N_CLASSES, eval_batches(data), step=step, mesh=mesh)))
    out.update(numeric("entropy", TE.br_evaluator_entropy_fused(
        model, 2, N_CLASSES, eval_batches(data), tau, pallas_head=True, mesh=mesh)))
    out.update(numeric("similarity", TE.br_evaluator_similarity_fused(
        model, 2, N_CLASSES, eval_batches(data), "ssim", sim_tau, ignore=(N_CLASSES - 1,),
        pallas_head=True, mesh=mesh)))
    out.update(numeric("images", TE.br_evaluator_similarity(
        model, 2, N_CLASSES, eval_batches(data), "nmi", sim_tau, ignore=(N_CLASSES - 1,),
        image_level=True, mesh=mesh)))
    fn = make_masked_gated_apply(model, tau=tau, n_classes=N_CLASSES, pallas_head=True,
                                 mesh=mesh)
    for i, batch in enumerate(eval_batches(data)):
        labels, exits = fn(torch.from_numpy(batch["image"]))
        out[f"masked/labels{i}"], out[f"masked/exits{i}"] = labels.numpy(), exits.numpy()
    return out


def loader_case(mesh):
    """This process's batches of a shuffled ``shard_by_process`` loader."""
    ds = SyntheticSegDataset(size=8, n=LOADER["n"], seed=4)
    out = {}
    loader = DataLoader(ds, LOADER["batch"], shuffle=True, seed=LOADER["seed"],
                        shard_by_process=True, num_workers=1)
    for k, batch in enumerate(loader):
        out[f"loader/image{k}"] = batch["image"][: batch["count"]]
    return out


def replicate_case(directory, mesh):
    """A model built from a different seed on every rank, then replicated:
    its weights are rank 0's."""
    torch.manual_seed(100 + mesh.rank)
    model = load_model(directory, "eval", torch.float32)
    for p in model.parameters():
        p.data.normal_()
    pm.replicate(model, mesh)
    return {"replicate/" + k: v.numpy().copy() for k, v in model.state_dict().items()}


def trainer_case(directory, mesh):
    """Three epochs of ``train/trainer.train`` with validation, early
    stopping (patience 1) and ReduceLROnPlateau (patience 0): the tracker
    each rank keeps, and whether the best checkpoint is there."""
    from ee_semantic_segmentation_tpu_torch.train.schedulers import ReduceLROnPlateau
    from ee_semantic_segmentation_tpu_torch.train.trainer import train

    torch.manual_seed(0)
    model = load_model(directory, "eval", torch.float32)
    opt = TO.make_optimizer(model, TO.branchy_lr_multipliers(1, LR))
    step = make_train_step(model, make_loss("lovasz", {}, mesh), opt, mesh=mesh)
    train_set = SyntheticSegDataset(size=32, n=4, num_classes=N_CLASSES, seed=6)
    loader = DataLoader(train_set, 2, shuffle=True, seed=1, num_workers=1)
    val = DataLoader(SyntheticSegDataset(size=32, n=3, num_classes=N_CLASSES, seed=7), 3,
                     num_workers=1)
    scheduler = ReduceLROnPlateau(LR, factor=0.5, patience=0, mode="max", min_lr=1e-4)
    tracker, saved = train(model, opt, step, loader, 3, val_loader=val, n_exits=2,
                           nout_channels=N_CLASSES, patience=1, saveat=directory,
                           save_name="trained", scheduler=scheduler, lr=LR, mesh=mesh)
    out = {f"trainer/{k}": np.asarray(v, np.float64) for k, v in tracker.items()}
    out["trainer/saved"] = np.asarray(saved is not None and os.path.exists(saved + ".pt"))
    return out


TRAINER_CASES = {
    # name: (training images, global batch, accum_steps); 17 at batch 16 is
    # a full batch and a padded one, 12 at batch 6 in micro-batches of 3
    # splits each micro-batch 2 + 1 over 2 ranks
    "n17": (17, 16, 1),
    "accum2": (12, 6, 2),
}


def trainer_run(directory, name, mesh):
    """One epoch of ``train/trainer.train`` over case ``name``'s data, in
    float64 (the trainer's float32 images are cast on the way in) with
    dropout off -> (tracker, state dict after it)."""
    from ee_semantic_segmentation_tpu_torch.train.trainer import train

    n, batch, accum = TRAINER_CASES[name]
    model = load_model(directory, "eval", torch.float64, head_dropout=0.0)
    model.register_forward_pre_hook(lambda module, args: (args[0].double(),))
    opt = TO.make_optimizer(model, TO.branchy_lr_multipliers(1, LR))
    step = make_train_step(model, make_loss("lovasz", {}, mesh), opt, accum_steps=accum,
                           mesh=mesh)
    loader = DataLoader(SyntheticSegDataset(size=32, n=n, num_classes=N_CLASSES, seed=8), batch,
                        shuffle=True, seed=2, num_workers=1)
    tracker, _ = train(model, opt, step, loader, 1, n_exits=2, nout_channels=N_CLASSES,
                       lr=LR, mesh=mesh)
    return tracker, model.state_dict()


def trainer_vs_one_case(directory, mesh):
    """Each trainer case at world W, and on rank 0 in one process beside
    it: the epoch loss and the largest differences of the state."""
    out = {}
    for name in TRAINER_CASES:
        tracker, state = trainer_run(directory, name, mesh)
        out[f"trainer_{name}/loss"] = np.asarray(tracker["train_loss"], np.float64)
        if mesh.rank == 0:
            tracker_one, state_one = trainer_run(directory, name, None)
            out[f"trainer_{name}/loss_one"] = np.asarray(tracker_one["train_loss"], np.float64)
            out.update(max_errors(f"trainer_{name}/one", state, state_one))
    return out


def run_group(group, directory, mesh):
    out = {}
    if group == "train":
        for name in TRAIN_CASES:
            out.update({f"train/{name}/{k}": v
                        for k, v in train_case(directory, name, mesh).items()})
    else:
        data = np.load(os.path.join(directory, "data.npz"))
        out.update(eval_cases(directory, data, mesh))
        if mesh.rank == 0:
            out.update({f"one/{k}": v for k, v in eval_cases(directory, data, None).items()})
        out.update(loader_case(mesh))
        out.update(replicate_case(directory, mesh))
        out.update(trainer_case(directory, mesh))
        out.update(trainer_vs_one_case(directory, mesh))
    out.update({f"collectives/{k}": np.asarray(v) for k, v in pm.COLLECTIVES.items()})
    return out


def cli_args(directory, tau):
    """The CLI runs of the data-parallel CLI case: CSV name -> (CLI module,
    argv), the same argv in one process and under the launcher."""
    ckpt = os.path.join(directory, "tiny")
    ev = ["-M", ckpt, "-c", str(N_CLASSES), "-D", "32", "32", "-d", "synthetic", "-b", "5",
          "--device", "cpu"]
    return {
        "miou.csv": ("eval_miou", ev + ["-s", "miou", "--pallas_head"]),
        "ent.csv": ("eval_br_ent", ev + ["-t", repr(tau), "-s", "ent", "--pallas_head"]),
        "img.csv": ("eval_br_images", ev + ["-m", "nmi", "-t", "0.5", "-s", "img"]),
        "ee_1_ent_lw_m2_res.csv": ("ee_dnn_op_ne", [
            "-M", ckpt, "-m", "ent", "-t", repr(tau), "-s", "32", "32", "-d", "synthetic",
            "-n", str(N_CLASSES), "--engine", "masked", "-b", "5", "--pallas_head",
            "--device", "cpu"]),
    }


def run_clis(directory):
    """Every CLI of :func:`cli_args` in this process, in the current folder."""
    import importlib

    tau = float(np.load(os.path.join(directory, "data.npz"))["ent_tau"])
    for module, argv in cli_args(directory, tau).values():
        importlib.import_module(f"ee_semantic_segmentation_tpu_torch.cli.{module}").main(argv)


def main(group, rank, world, directory):
    torch.set_num_threads(1)
    mesh = pm.initialize_multihost(f"file://{os.path.join(directory, 'store')}", world, rank,
                                   device="cpu")
    out = run_group(group, directory, mesh)
    np.savez(os.path.join(directory, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        torch.set_num_threads(1)
        run_clis(sys.argv[2])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
