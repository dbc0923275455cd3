"""The port's early-exit and per-exit CLIs end to end on the CPU:
``ee_dnn_op`` (similarity gate), ``ee_dnn_op_ne`` (entropy gate), both
engines, ``--pallas_head``, ``eval_flops`` and ``eval_image``, on a
two-branch 21-class checkpoint at 32 px and the 16 images of the synthetic
test split; and ``union_mIoU`` against the JAX package's numpy one.

The JAX CLIs load Orbax checkpoints, not the port's, so the expected CSV
headers are the JAX CLIs' column lists written out: the row keys of
``ee_semantic_segmentation_tpu/cli/ee_dnn_op.py:229-255`` sorted, with
``net_id`` first (``append_csv`` indexes by it).  Each split tau lies in
the widest gap of the first gated exit's gate values on the test split.
"""

import csv
import shutil

import numpy as np
import pytest
import torch

N_IMG = 16  # the synthetic test split
ENT_HEADER = ["net_id", "avg_flops", "e_1", "e_2", "edge_flops", "mIoU", "metric", "n_imgs",
              "out", "t", "x", "y"]
SIM_HEADER = ["net_id", "avg_flops", "avg_flops_2", "e_1", "e_2", "edge_flops", "edge_flops_2",
              "ig_bk", "mIoU", "metric", "n_imgs", "out", "t", "x", "y"]
FLOPS_RTOL = 1e-12  # avg FLOPs summed image by image (seq) or from the histogram (masked)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A two-branch 21-class checkpoint at 32 px (the flagship's placement
    rule, count_branches=False: exits after blocks 12 and 15), written once
    for the module and removed after its last test: it is ~250 MB."""
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    torch.manual_seed(0)
    model = build_branchy_deeplabv3(depth=50, n=2, img_dim=32, num_classes=21,
                                    count_branches=False)
    assert model.config.segment_ends == (12, 15)
    folder = tmp_path_factory.mktemp("ckpt")
    yield save_checkpoint(str(folder), "tiny21", model, model.config)
    shutil.rmtree(folder)


@pytest.fixture(scope="module")
def exits_out(ckpt):
    """Every exit's logits on the 16 test images, from the port model."""
    from ee_semantic_segmentation_tpu_torch.cli import common

    fwd = common.forward_fn(common.load_model(ckpt, torch.device("cpu")))
    images = np.concatenate([b["image"][:b["count"]] for b in _loader()])
    return fwd(images)


def _loader():
    from ee_semantic_segmentation_tpu_torch.cli.common import resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader

    return DataLoader(resolve_test_set("synthetic", 32), 12)


def _split(values):
    """(tau in the widest gap of the values, how many lie below it)."""
    v = sorted(values)
    gap, i = max((v[j + 1] - v[j], j) for j in range(len(v) - 1))
    assert gap > 1e-5, v
    return (v[i] + v[i + 1]) / 2, i + 1


def _rows(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def _assert_same_row(a, b, skip=()):
    for k in a:
        if k in skip:
            continue
        try:
            assert float(a[k]) == pytest.approx(float(b[k]), rel=FLOPS_RTOL, nan_ok=True), k
        except ValueError:
            assert a[k] == b[k], k


def _base(ckpt, metric, tau):
    return ["-M", ckpt, "-m", metric, "-t", repr(tau), "-s", "32", "32", "-d", "synthetic",
            "-n", "21", "--device", "cpu"]


def test_clis_ask_for_cpu_explicitly_without_cuda(ckpt):
    from ee_semantic_segmentation_tpu_torch.cli import ee_dnn_op, ee_dnn_op_ne, eval_image

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    args = ["-M", ckpt, "-t", "0.5", "-s", "32", "32", "-d", "synthetic", "-n", "21"]
    for main, extra in ((ee_dnn_op.main, ["-m", "ssim"]), (ee_dnn_op_ne.main, []),
                        (ee_dnn_op_ne.main, ["--engine", "masked", "--pallas_head"])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(args + extra)
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_image.main(["-M", ckpt, "-i", "probe.png"])


def test_ee_dnn_op_similarity_gate_both_engines(ckpt, exits_out, tmp_path, monkeypatch):
    """ssim with -i: the sequential path names its CSV after the metric as
    given, the masked path after it lowercased; both give the same row."""
    from ee_semantic_segmentation_tpu_torch.cli import ee_dnn_op
    from ee_semantic_segmentation_tpu_torch.ops.gating import batched_similarity

    monkeypatch.chdir(tmp_path)
    sims = batched_similarity(exits_out[:2].argmax(-1), "ssim", 21, (0, 20))[0].tolist()
    tau, below = _split(sims)
    ee_dnn_op.main(_base(ckpt, "SSIM", tau) + ["-i"])
    ee_dnn_op.main(_base(ckpt, "ssim", tau) + ["-i", "--engine", "masked", "-b", "12"])
    header, (seq,) = _rows("ee_2_SSIM_lw_m2_res.csv")
    header_m, (masked,) = _rows("ee_2_ssim_lw_m2_res.csv")
    assert header == header_m == SIM_HEADER
    _assert_same_row(seq, masked)
    # the first gated exit only seeds: ssim fires on sim > tau at exit 2
    assert (seq["metric"], seq["ig_bk"], seq["e_1"]) == ("ssim", "True", "0")
    assert int(seq["e_2"]) == N_IMG - below and int(seq["out"]) == below
    assert int(seq["n_imgs"]) == N_IMG
    assert float(seq["avg_flops_2"]) < float(seq["avg_flops"])


def test_ee_dnn_op_ne_engines_and_heads(ckpt, exits_out, tmp_path, monkeypatch, capsys):
    """ent: the sequential engine, the masked engine with the plain head and
    with --pallas_head (kernels B and C: their plain versions here) give the
    same row; -m max -p 2 runs the plain head, and says so."""
    from ee_semantic_segmentation_tpu_torch.cli import ee_dnn_op_ne
    from ee_semantic_segmentation_tpu_torch.ops.gating import batched_norm_entropy

    monkeypatch.chdir(tmp_path)
    tau, below = _split(batched_norm_entropy(exits_out[:1], 21)[0].tolist())
    base = _base(ckpt, "ent", tau)
    masked = ["--engine", "masked", "-b", "12"]
    ee_dnn_op_ne.main(base)
    capsys.readouterr()
    ee_dnn_op_ne.main(base + masked)
    assert "masked engine: plain head" in capsys.readouterr().out
    ee_dnn_op_ne.main(base + masked + ["--pallas_head"])
    assert "masked engine: kernel head" in capsys.readouterr().out
    header, rows = _rows("ee_2_ent_lw_m2_res.csv")
    assert header == ENT_HEADER and len(rows) == 3
    for row in rows[1:]:
        _assert_same_row(rows[0], row)
    seq = rows[0]
    assert int(seq["e_1"]) == below
    assert int(seq["e_1"]) + int(seq["e_2"]) + int(seq["out"]) == int(seq["n_imgs"]) == N_IMG

    max_tau, _ = _split(batched_norm_entropy(exits_out[:1], 21, "max", 2)[0].tolist())
    ee_dnn_op_ne.main(_base(ckpt, "max", max_tau) + ["-p", "2"] + masked + ["--pallas_head"])
    assert "masked engine: plain head (--pallas_head" in capsys.readouterr().out
    ee_dnn_op_ne.main(_base(ckpt, "max", max_tau) + ["-p", "2"])
    header, (m, s) = _rows("ee_2_max_lw_m2_res.csv")
    assert header == ENT_HEADER
    _assert_same_row(m, s)
    assert sum(int(m[k]) for k in ("e_1", "e_2", "out")) == N_IMG and 0 < int(m["e_1"]) < N_IMG
    with pytest.raises(ValueError, match="ent, max, min"):
        ee_dnn_op_ne.main(_base(ckpt, "ssim", 0.5))


def test_ignore_branch_is_a_skip_in_the_masked_engine(ckpt, tmp_path, monkeypatch):
    """-I 1 leaves the first branch out (0-based 0 in the sequential engine,
    skip 1 in the masked one): at tau = inf everything leaves at exit 2;
    the masked engine refuses a -I that is not a leading prefix."""
    from ee_semantic_segmentation_tpu_torch.cli import ee_dnn_op_ne

    monkeypatch.chdir(tmp_path)
    base = _base(ckpt, "ent", float("inf")) + ["-I", "1"]
    ee_dnn_op_ne.main(base)
    ee_dnn_op_ne.main(base + ["--engine", "masked", "-b", "12", "--pallas_head"])
    _, (seq, masked) = _rows("ee_2_ent_lw_m2_res.csv")
    _assert_same_row(seq, masked)
    assert (seq["e_1"], seq["e_2"], seq["out"]) == ("0", str(N_IMG), "0")
    with pytest.raises(SystemExit, match="leading -I prefix"):
        ee_dnn_op_ne.main(_base(ckpt, "ent", 0.5) + ["-I", "2", "--engine", "masked"])


def test_eval_flops_writes_the_flops_table(ckpt, tmp_path, monkeypatch):
    from ee_semantic_segmentation_tpu_torch.cli import eval_flops
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import BranchyDeepLabV3
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import load_config

    monkeypatch.chdir(tmp_path)
    eval_flops.main(["-M", ckpt, "-s", "32"])
    eval_flops.main(["-M", ckpt, "-s", "64", "48"])
    header, rows = _rows("2_branches_model_flops.csv")
    assert header == ["net_id", "x", "y", "b1_flops", "b2_flops", "b3_flops"]
    with torch.device("meta"):
        model = BranchyDeepLabV3(load_config(ckpt))
    for row, dim in zip(rows, (32, (64, 48))):
        assert row["net_id"] == "tiny21"
        assert [int(row[f"b{i}_flops"]) for i in (1, 2, 3)] == \
            model.flops_table(dim)["cumulative_exits"]
    assert (rows[1]["x"], rows[1]["y"]) == ("64", "48")


def test_eval_image_writes_a_palette_png_per_exit(ckpt, tmp_path, monkeypatch):
    """One PNG per exit at the input's size, mode P with the VOC
    pseudo-palette, its indices the argmax of that exit's logits (the JAX
    CLI's recipe: the map as mode P, resized, then the palette)."""
    from PIL import Image

    from ee_semantic_segmentation_tpu.cli.eval_image import voc_palette as j_palette
    from ee_semantic_segmentation_tpu_torch.cli import common, eval_image
    from ee_semantic_segmentation_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    monkeypatch.chdir(tmp_path)
    rgb = (np.random.RandomState(4).rand(24, 40, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save("probe.png")
    eval_image.main(["-M", ckpt, "-i", "probe.png", "--device", "cpu"])
    np.testing.assert_array_equal(eval_image.voc_palette(), j_palette())

    x = ((rgb.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)[None]
    preds = common.forward_fn(common.load_model(ckpt, torch.device("cpu")))(x)
    preds = preds.argmax(-1)[:, 0].to(torch.uint8).numpy()
    written = sorted(p.name for p in (tmp_path / "tiny21_images").iterdir())
    assert written == ["probe_b1.png", "probe_b2.png", "probe_b3.png"]
    for i in range(3):
        png = Image.open(tmp_path / "tiny21_images" / f"probe_b{i + 1}.png")
        assert png.mode == "P" and png.size == (40, 24)
        assert png.getpalette()[:63] == j_palette().reshape(-1).tolist()
        np.testing.assert_array_equal(np.asarray(png), preds[i])


def test_union_miou_matches_the_jax_accumulator_on_void_labels():
    """A void-labelled pixel (21, and 255) still counts in the union of the
    class it is predicted as; several calls accumulate, also with maps of
    several images at once and (1, H, W) labels."""
    from ee_semantic_segmentation_tpu.cli.ee_dnn_op import union_mIoU as JU
    from ee_semantic_segmentation_tpu_torch.cli.ee_dnn_op import union_mIoU as TU

    rng = np.random.RandomState(9)
    j, t = JU(21), TU(21)
    for _ in range(3):
        pred = rng.randint(0, 21, (17, 19)).astype(np.int32)
        label = rng.randint(0, 22, (1, 17, 19)).astype(np.int32)
        label[0, :2] = 255
        j(pred, label)
        t(torch.from_numpy(pred), torch.from_numpy(label))
    assert t.compute() == j.compute()
    np.testing.assert_array_equal(t.acc.numpy(), j.acc)
    preds = rng.randint(0, 5, (2, 8, 8)).astype(np.int32)  # classes 5..20 never occur
    labels = rng.randint(0, 22, (2, 8, 8)).astype(np.int32)
    j2, t2 = JU(21), TU(21)
    for p, g in zip(preds, labels):
        j2(p, g)
    t2(torch.from_numpy(preds), torch.from_numpy(labels))
    assert t2.compute() == j2.compute()
    assert TU(21).compute() == JU(21).compute() == 0.0
