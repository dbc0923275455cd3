"""The port's checkpoints, trainer and training CLIs, on the CPU.

``train/checkpoint.py`` (optimizer state, resume, partial restore) and
``train/trainer.py`` driven through ``cli/main_bradeepv3.py`` and
``cli/main_bradeepv3_ce.py`` on the synthetic set at 32 px, with the JAX
package's file layouts: the JSON sidecar its ``load_config`` reads, the
curve CSV and the test-mIoU CSV.
"""

import csv
import importlib
import json

import numpy as np
import pytest
import torch

from ee_semantic_segmentation_tpu_torch.models import branchy_deepv3 as TB
from ee_semantic_segmentation_tpu_torch.ops import branchy as TBr
from ee_semantic_segmentation_tpu_torch.parallel.train_step import make_train_step
from ee_semantic_segmentation_tpu_torch.train import checkpoint as TC
from ee_semantic_segmentation_tpu_torch.train import optim as TO
from test_torch_port import removes_tmp_path  # noqa: F401 (a fixture)

VOID = 5
TRAIN_ARGS = ["-t", "resnet50", "-n", "2", "-D", "32", "-b", "4", "-e", "1", "-d", "synthetic",
              "-l", "0.01"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: a full-width
    ResNet on 8 intra-op threads per process oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)

def _read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


@pytest.mark.usefixtures("removes_tmp_path")
def test_checkpoint_with_optimizer_state_resumes_the_same_trajectory(tmp_path):
    """Save after one step, restore into a fresh model and optimizer: the
    next step lands where the uninterrupted run's does (dropout's RNG
    seeded alike before it).  Restoring "params" alone leaves the
    BatchNorm buffers as they were."""
    def fresh(seed):
        torch.manual_seed(seed)
        model = TB.build_branchy_deeplabv3(depth=50, n=1, img_dim=32, num_classes=5).double()
        opt = TO.make_optimizer(model, TO.branchy_lr_multipliers(1, 0.05))
        loss = TBr.LovaszSoftmax(ignore=VOID, n_branches=1)
        return model, opt, make_train_step(model, loss, opt)

    rng = np.random.RandomState(8)
    b1, b2 = [(torch.from_numpy(rng.rand(2, 32, 32, 3)),
               torch.from_numpy(rng.randint(0, VOID + 1, (2, 32, 32)).astype(np.int32)))
              for _ in range(2)]
    model, opt, step = fresh(0)
    step(*b1, 0.05)
    path = TC.save_checkpoint(str(tmp_path), "ck", model, model.config, {"val_mIoU": 0.25},
                              optimizer=opt, step=1)
    torch.manual_seed(5)
    step(*b2, 0.05)
    want = {k: v.clone() for k, v in model.state_dict().items()}

    model2, opt2, step2 = fresh(1)
    assert TC.load_checkpoint(path, model2, opt2) == {"val_mIoU": 0.25}
    assert torch.load(path + ".opt.pt", weights_only=True)["step"] == 1
    torch.manual_seed(5)
    step2(*b2, 0.05)
    for k, v in model2.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-12, atol=1e-14)

    TC.load_checkpoint(path, model, components=("params",))
    saved = torch.load(path + ".pt", weights_only=True)
    params = {n for n, _ in model.named_parameters()}
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k] if k in params else want[k]), k
    with pytest.raises(ValueError, match="unknown checkpoint components"):
        TC.load_checkpoint(path, model, components=("weights",))


@pytest.mark.parametrize("cli_name,extra", [("main_bradeepv3", []),
                                            ("main_bradeepv3_ce", []),
                                            ("main_bradeepv3", ["-G", "1024"]),
                                            ("main_bradeepv3", ["-G", "16384"])],
                         ids=["main_bradeepv3", "main_bradeepv3_ce", "main_bradeepv3-G",
                              "main_bradeepv3-G16384"])
@pytest.mark.usefixtures("removes_tmp_path")
def test_training_cli_end_to_end_on_cpu(tmp_path, monkeypatch, cli_name, extra):
    """One epoch of the synthetic set at 32 px: checkpoint (.pt, .opt.pt,
    .json with the JAX package's schema), the curve CSV and the test-mIoU
    row in the JAX layouts, and a checkpoint the eval CLI loads; with -G,
    the histogram Lovász (16384 bins: above the 8192 that kernel E keeps in
    one block, every 128 * 2^k of the JAX package is taken)."""
    from ee_semantic_segmentation_tpu.train.checkpoint import load_config as j_load_config
    from ee_semantic_segmentation_tpu_torch.cli import eval_miou

    cli = importlib.import_module(f"ee_semantic_segmentation_tpu_torch.cli.{cli_name}")
    monkeypatch.chdir(tmp_path)
    ckpt = cli.main(TRAIN_ARGS + extra + ["-N", "tiny", "--device", "cpu"])
    assert ckpt == str(tmp_path / "synthetic_results" / "tiny" / "tiny")
    for suffix in (".pt", ".opt.pt", ".json"):
        assert (tmp_path / "synthetic_results" / "tiny" / f"tiny{suffix}").exists(), suffix
    cfg = j_load_config(ckpt)
    assert cfg.n_branches == 2 and cfg.img_dim == 32
    meta = json.loads((tmp_path / "synthetic_results" / "tiny" / "tiny.json").read_text())
    assert set(meta) == {"extra", "config"}
    tr = _read_csv(tmp_path / "synthetic_results" / "tiny" / "tiny_tr.csv")
    assert len(tr) == 1 and list(tr[0]) == [
        "train_loss", "val_mIoU_b1_mIoU", "val_mIoU_b2_mIoU", "val_mIoU_mIoU", "lr"]
    assert np.isfinite(float(tr[0]["train_loss"])) and float(tr[0]["lr"]) == 0.01
    res = _read_csv(tmp_path / "mIoU_2_branches_results.csv")
    assert len(res) == 1 and list(res[0]) == ["net_id", "b1_mIoU", "b2_mIoU", "mIoU"]
    assert res[0]["net_id"] == "tiny"
    assert "Finished training" in (tmp_path / "synthetic_deepv3_msgs.txt").read_text()
    eval_miou.main(["-M", ckpt, "-c", "21", "-D", "32", "32", "-d", "synthetic", "-b", "8",
                    "-s", "ev", "--device", "cpu"])
    assert len(_read_csv(tmp_path / "ev.csv")) == 1


def test_training_cli_raises_for_what_is_not_there(tmp_path, monkeypatch):
    from ee_semantic_segmentation_tpu_torch.cli import main_bradeepv3, main_bradeepv3_ce

    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        for cli in (main_bradeepv3, main_bradeepv3_ce):
            with pytest.raises(RuntimeError, match="--device cpu"):
                cli.main(TRAIN_ARGS)
    with pytest.raises(NotImplementedError, match="A6b"):
        main_bradeepv3_ce.main(TRAIN_ARGS + ["--sp", "2", "--device", "cpu"])
