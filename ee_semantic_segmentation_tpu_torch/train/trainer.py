"""Training engine and experiment orchestration.

Port of ``ee_semantic_segmentation_tpu/train/trainer.py`` (the reference's
train_funcs.py:60-269 and deepv3_funcs.py:19-279):

* the epoch loop runs ``parallel/train_step.make_train_step``'s step over
  the loader's batches; the loss is summed on the device and read to the
  host once per epoch;
* per-epoch validation is the per-exit mIoU of the port's
  ``mIoU_evaluator_fused`` (plain head) with ``empty_class="one"``; early
  stopping follows the mean of the per-exit values (weighted with
  ``max2min``), with the reference's counter semantics: reset to 1 on an LR
  change instead of incrementing, ``start_counting`` grace epochs, the
  ``minimize`` direction;
* the best checkpoint (model, optimizer state, validation values) is saved
  on improvement and reloaded at the end; ``start_from`` / ``auto_resume``
  resume from one;
* scheduling: ``ReduceLROnPlateau`` fed the tracked metric with early
  stopping, else polynomial decay with the ``min_lr`` horizon;
* message-file logging in the reference's format, the training curve
  ``{net_id}_tr.csv`` and the final test-mIoU row appended to
  ``./mIoU_{n}_branches_results.csv``, both in the JAX package's column
  layout (written with the ``csv`` module).

As in the JAX package, ``num_epochs`` means what it says (the reference
trains one epoch fewer, SURVEY.md bug #7).  Metrics other than mIoU go
through the JAX package's generic metric registry, which is not ported.

Data parallelism: :func:`eval_deepv3` joins the process group of a
``torchrun`` launch through ``parallel/mesh.initialize_multihost`` (the
counterpart of the JAX trainer's ``mesh or make_mesh()``); without a
launcher it runs the one-process path.  With a mesh every rank builds the
same model, which rank 0's weights then overwrite (``replicate``), draws
the one-process loader's batches of ``batch_size`` (the same permutation
on every rank), and hands each whole to the global-batch train step
(``parallel/train_step.py``), which runs this rank's rows of it, as the
JAX trainer's ``shard_batch`` does; every rank so takes the same steps on
the same global batches.  Validation and the final test evaluation shard
each batch over the ranks.  The loss, the validation counts and so the
early-stopping and LR decisions come out equal on every rank without a
broadcast.  Rank 0 alone writes checkpoints (the others wait at a
barrier, then load), CSVs and messages.
"""

from __future__ import annotations

import csv
import os
import time
from collections import defaultdict

import numpy as np
import torch

from ee_semantic_segmentation_tpu_torch.ee.batch_eval import mIoU_evaluator_fused
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm
from ee_semantic_segmentation_tpu_torch.parallel.train_step import make_train_step
from ee_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from ee_semantic_segmentation_tpu_torch.train.optim import branchy_lr_multipliers, make_optimizer
from ee_semantic_segmentation_tpu_torch.train.schedulers import PolynomialLR, ReduceLROnPlateau
from ee_semantic_segmentation_tpu_torch.utils.logging import log_msg

REGISTRY_TODO = ("validation metric {!r}: only mIoU is ported; the generic metric registry "
                 "(ee/generic_eval.py, registry.py) is ROADMAP.md queue A item 8")


def _to_device(batch, device):
    """(images, labels) tensors of a host batch on ``device`` (None: left on
    the host)."""
    images = torch.from_numpy(np.ascontiguousarray(batch["image"], np.float32))
    labels = torch.from_numpy(np.ascontiguousarray(batch["label"], np.int32))
    if device is None:
        return images, labels
    return images.to(device), labels.to(device)


def _write_tracker_csv(tracker: dict, path: str) -> None:
    """``pd.DataFrame.from_dict(tracker).to_csv(path, index=False)``: one
    column per key, one row per epoch, NaN as an empty field."""
    cols = list(tracker)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(cols)
        for row in zip(*(tracker[c] for c in cols)):
            w.writerow(["" if isinstance(v, float) and np.isnan(v) else repr(float(v))
                         for v in row])


def train(
    model,
    optimizer,
    step_fn,
    train_loader,
    num_epochs,
    *,
    val_loader=None,
    n_exits=1,
    nout_channels=21,
    metrics=("mIoU",),
    patience=None,
    saveat=None,
    save_name="model",
    start_from=None,
    verbose=False,
    scheduler=None,
    lr=0.01,
    use_file=None,
    minimize=False,
    max2min=False,
    start_counting=0,
    name=None,
    config=None,
    mesh=None,
):
    """Epoch loop with early stopping; returns (tracker dict, best checkpoint
    path or None).  ``model`` and ``optimizer`` are updated in place.
    ``mesh``: the data-parallel group ``step_fn`` was built with; validation
    shards over it and rank 0 writes the checkpoints."""
    for met in metrics:
        if met != "mIoU":
            raise NotImplementedError(REGISTRY_TODO.format(met))
    follow = f"val_{metrics[0]}"
    tracker = defaultdict(list)
    name = name or "unspecified"
    device = next(model.parameters()).device

    counter = 0
    last_lr = 0.0
    best_val = np.inf if minimize else 0.0
    cur_lr = lr
    n_steps = 0

    if patience:
        log_msg(
            f"<< {name} progress update >> Earlystopping will follow {follow} "
            f"with patience set to {patience}.",
            use_file, verbose,
        )
    else:
        log_msg(f"<< {name} progress update >> Earlystopping not set.", use_file, verbose)

    if start_from:
        extra = ckpt.load_checkpoint(start_from, model, optimizer)
        if patience and follow in extra:
            best_val = extra[follow]

    branchy = n_exits > 1
    saved_path = None

    for epoch in range(1, (num_epochs or 0) + 1):
        t0 = time.perf_counter()
        log_msg(
            f"<< {name} progress update >> starting #{epoch} training epoch; "
            f"lr = {cur_lr:.6g}, no updates since {counter} epochs",
            use_file, verbose,
        )
        # the loss sums on the device: one host read per epoch, not per step
        loss_dev = None
        n_batches = 0
        for batch in train_loader:
            # with a mesh the step moves only this rank's rows to its device
            images, labels = _to_device(batch, device if mesh is None else None)
            loss = step_fn(images, labels, cur_lr)
            loss_dev = loss if loss_dev is None else loss_dev + loss
            n_batches += 1
        n_steps += n_batches
        # the read also waits for the device, so the epoch time is honest
        epoch_loss = float(loss_dev) if n_batches else 0.0
        dt = time.perf_counter() - t0
        log_msg(
            f"<< {name} progress update >> finished #{epoch} training epoch "
            f"after {int(dt // 60)} mins and {dt % 60:.2f} s",
            use_file, verbose,
        )
        tracker["train_loss"].append(epoch_loss / max(n_batches, 1))

        # ----------------------------------------------------- validation
        branch_val = []
        if val_loader is not None:
            # 'one' = the reference's intended empty-class guard value
            res = mIoU_evaluator_fused(model, n_exits, nout_channels, val_loader,
                                       empty_class="one", mesh=mesh)
            if branchy:
                for key, value in res.items():
                    tracker[f"val_mIoU_{key}"].append(value)
                branch_val = [tracker[k][-1] for k in tracker if k.startswith(follow)]
                if max2min:
                    weights = np.arange(len(branch_val), 0, -1, dtype=np.float64)
                    cur_val = float(np.average(branch_val, weights=weights / weights.max()))
                else:
                    cur_val = float(np.average(branch_val))
            else:
                tracker["val_mIoU"].append(res["mIoU"])
                cur_val = tracker[follow][-1]
        else:
            cur_val = tracker["train_loss"][-1]

        tracker["lr"].append(cur_lr)
        if scheduler is not None:
            cur_lr = scheduler(epoch, cur_val)

        # -------------------------------------------------- early stopping
        improved = (best_val > cur_val) if minimize else (best_val < cur_val)
        if improved:
            if saveat:
                extra = {follow: cur_val, "epoch": epoch}
                for k in tracker:
                    if k.startswith("val_"):
                        extra[k] = tracker[k][-1]
                saved_path = ckpt.save_checkpoint(saveat, save_name, model, config, extra,
                                                  optimizer=optimizer, step=n_steps, mesh=mesh)
            best_val = cur_val
            counter = 0
            msg = f"<< {name} progress update >> saved @ {epoch} epoch. Best score: {best_val:.5g}"
            if branchy and branch_val:
                msg += "\nFor each branch:\n\t" + "\n\t".join(
                    f"b{i + 1} = {v:.5g}" for i, v in enumerate(branch_val)
                )
            log_msg(msg, use_file, verbose)
        elif last_lr != cur_lr:
            # LR just changed: give the new LR a fresh chance (train_funcs.py:230-241)
            counter = 1
            last_lr = cur_lr
        else:
            counter += 1

        if patience and counter >= patience and epoch > start_counting:
            break

    return dict(tracker), saved_path


def train_deepv3(model, num_epochs, kwargs):
    """Orchestration (deepv3_funcs.py:19-197): optimizer groups, scheduler,
    loaders, train, best-reload, curve CSV.  Returns the checkpoint path;
    ``model`` holds the best weights afterwards."""
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader

    mesh = kwargs.get("mesh")

    net_id = kwargs.get("name", kwargs.get("net_id", "model"))
    use_file = kwargs.get("use_file")
    res_dir = kwargs.get("mod_dir", ".")
    lr = kwargs["lr"]
    min_lr = kwargs.get("min_lr", 0)
    base_lr = kwargs.get("base_lr") or lr
    patience = kwargs.get("patience")
    minimize = kwargs.get("minimize", True)
    metrics = tuple(kwargs.get("metrics", ("mIoU",)))
    n_branches = model.config.n_branches
    batch_size = kwargs.get("batch_sizes", 32)
    if isinstance(batch_size, (list, tuple)):
        # the reference's own multi-size loop is broken (deepv3_funcs.py:177)
        if len(set(batch_size)) > 1:
            raise ValueError(
                f"multi-batch-size training is not supported (got "
                f"batch_sizes={list(batch_size)}); the reference's own "
                "multi-size loop is broken (deepv3_funcs.py:177) — pass a "
                "single batch size"
            )
        batch_size = batch_size[0]

    mult = branchy_lr_multipliers(
        n_branches,
        lr,
        base_lr=base_lr,
        weighted_lr=kwargs.get("weighted_lr", False),
        freeze_backbone=kwargs.get("freeze_backbone", False),
        freeze_from=kwargs.get("freeze_from"),
    )
    optimizer = make_optimizer(model, mult)

    scheduler = None
    if kwargs.get("use_scheduler"):
        if patience:
            scheduler = ReduceLROnPlateau(
                lr, factor=0.75, patience=int(patience * 0.5),
                mode="min" if minimize else "max", eps=1e-6, min_lr=lr * 0.01,
            )
        else:
            scheduler = PolynomialLR(lr, num_epochs, min_lr=min_lr)

    step_fn = make_train_step(model, kwargs["loss"], optimizer,
                              accum_steps=kwargs.get("accum_steps", 1), mesh=mesh)
    train_loader = DataLoader(
        kwargs["train_set"], batch_size, shuffle=True,
        num_workers=kwargs.get("num_workers", 4),
    )
    val_loader = kwargs.get("val_loader")

    # failure recovery: pick up our own previous best checkpoint when the
    # process restarts (opt-in; the reference has no equivalent)
    start_from = kwargs.get("start_from")
    if start_from is None and kwargs.get("auto_resume"):
        candidate = os.path.join(res_dir, net_id)
        if os.path.exists(candidate + ".json"):
            start_from = candidate
            log_msg(f"<< {net_id} progress update >> auto-resuming from {candidate}",
                    use_file, True)

    log_msg(f"--> Started training {net_id}", use_file, True)
    tracker, saved = train(
        model, optimizer, step_fn, train_loader, num_epochs,
        val_loader=val_loader, n_exits=n_branches + 1,
        nout_channels=kwargs.get("nout_channels", 21), metrics=metrics,
        patience=patience, saveat=res_dir, save_name=net_id,
        start_from=start_from, verbose=True,
        scheduler=scheduler, lr=lr, use_file=use_file, minimize=minimize,
        max2min=kwargs.get("max2min", False),
        start_counting=kwargs.get("start_counting", 0), name=net_id,
        config=model.config, mesh=mesh,
    )

    # training-curve CSV (deepv3_funcs.py:182-183)
    if pm.is_primary():
        _write_tracker_csv(tracker, os.path.join(res_dir, f"{net_id}_tr.csv"))

    if saved:
        ckpt.load_checkpoint(saved, model, optimizer)
    else:
        # no epoch improved the tracked metric: keep the final weights so
        # that the evaluation below still has a checkpoint to load
        saved = ckpt.save_checkpoint(res_dir, net_id, model, model.config,
                                     optimizer=optimizer, mesh=mesh)
    log_msg(f"--> Finished training {net_id}", use_file, True)
    return saved


def eval_deepv3(kwargs):
    """Experiment entry (deepv3_funcs.py:200-279): build the model (weights
    from ``torch.manual_seed(seed)`` on the CPU, then moved to
    ``kwargs["device"]``), renegotiate the branch count with the loss,
    train, then append the final test mIoU row to
    ``./mIoU_{n}_branches_results.csv``.  Returns the checkpoint path.
    ``kwargs["mesh"]``, when given (None: one process), is the data-parallel
    group; else it comes from ``initialize_multihost``."""
    from ee_semantic_segmentation_tpu_torch.cli.common import append_csv
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import (
        BranchyDeepLabV3,
        build_branchy_deeplabv3,
    )

    name = kwargs["name"]
    res_dir = kwargs.get("res_dir", ".")
    saveat = os.path.join(res_dir, name)
    os.makedirs(saveat, exist_ok=True)
    kwargs["mod_dir"] = saveat
    use_file = kwargs.get("use_file")
    n_branches = kwargs["n_branches"]
    device = torch.device(kwargs.get("device", "cuda"))
    if "mesh" not in kwargs:
        kwargs["mesh"] = pm.initialize_multihost(device=device.type)
    mesh = kwargs["mesh"]
    if mesh is not None:
        device = mesh.device
        kwargs["loss"].mesh = mesh

    torch.manual_seed(kwargs.get("seed", 0))
    fine_tune = kwargs.get("fine_tune")
    if fine_tune:
        cfg = ckpt.load_config(fine_tune)
        model = BranchyDeepLabV3(cfg)
    else:
        model = build_branchy_deeplabv3(
            depth=kwargs.get("depth", 101),
            n=n_branches,
            img_dim=kwargs["input_dim"],
            count_branches=kwargs.get("count_branches", True),
            skip=kwargs.get("skip", 0),
            branch_params=kwargs.get("branch_params"),
            num_classes=kwargs.get("nout_channels", 21),
            backbone=kwargs.get("backbone", "resnet"),
            classifier_mid=kwargs.get("classifier_mid", 256),
        )
    # NHWC images viewed as NCHW are channels-last: keep the weights so too
    model = model.to(device, memory_format=torch.channels_last)
    if mesh is not None:
        pm.replicate(model, mesh)
        if mesh.rank:
            # dropout: a stream of its own on every rank, as the JAX package's
            # one mask over the global batch differs from row to row (rank 0
            # keeps the one-process stream)
            torch.manual_seed(kwargs.get("seed", 0) * 1_000_003 + mesh.rank)

    if n_branches and n_branches != model.config.n_branches:
        n_branches = model.config.n_branches
        kwargs["loss"].update_n(n_branches)
        kwargs["n_branches"] = n_branches
        log_msg(
            f"<< {name} progress update >> Number of branches is different "
            f"then antecipated: {n_branches} branches",
            use_file, True,
        )

    num_epochs = kwargs.get("num_epochs", 0)
    saved = None
    if num_epochs:
        kwargs["val_loader"] = DataLoader(kwargs["val_set"], kwargs.get("val_batch", 5))
        if fine_tune:
            kwargs["start_from"] = fine_tune
        saved = train_deepv3(model, num_epochs, kwargs)
    else:
        if fine_tune:
            ckpt.load_checkpoint(fine_tune, model)
        saved = ckpt.save_checkpoint(saveat, name, model, model.config, mesh=mesh)

    # final test evaluation (deepv3_funcs.py:264-277)
    test_loader = DataLoader(kwargs["test_set"], kwargs.get("test_batch", 5))
    res_vals = mIoU_evaluator_fused(model, n_branches + 1, kwargs.get("nout_channels", 21),
                                    test_loader, mesh=mesh)
    res = defaultdict(list)
    res["net_id"].append(name)
    for k, v in res_vals.items():
        res[k].append(v)
    append_csv(res, f"./mIoU_{n_branches}_branches_results.csv")
    return saved
