"""Phases 4, 4c and 4d of one tree's ``chip_smoke.py`` alone, on one GPU.

Builds that tree's CUDA kernels, then runs its single-process eval phase
(4: ``eval_mIoU``, ``eval_br_ent``, ``eval_br_sim`` with both heads), its
early-exit phase (4c: the masked and sequential engines) and its
MobileNetV3 phase (4d), with the main paths' TF32 setting, and prints one
JSON line with their images/s and the card.  To compare two trees on one
card in one call, run them in turns (parent, change, change, parent)::

    for d in tree_check/parent . . tree_check/parent; do
        python3 tools/torch_smoke_phases.py $d; done

Each run is a process of its own, so each tree imports its own package.
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile
import time


def main(tree: str) -> int:
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
    from ee_semantic_segmentation_tpu_torch.ops.kernels import sort as S
    from ee_semantic_segmentation_tpu_torch.ops.kernels import upsample_argmax as U

    assert pathlib.Path(cs.__file__).resolve().parent == root, cs.__file__
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    _build.build()
    _build.load_library()
    torch.backends.cudnn.allow_tf32 = True  # as chip_smoke.py runs its main paths
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = cs.flagship_checkpoint(tmp, torch)
        _, eval_ips, _ = cs.main_path(U, torch, tmp, ckpt)
        _, ee_ips, _, _ = cs.ee_path(U, torch, ckpt)
    _, mnv3_ips = cs.mobilenet_path(U, S, torch)
    print(json.dumps({"tree": str(root), "card": card.splitlines()[0],
                      "seconds": time.perf_counter() - t0, "eval": eval_ips, "ee": ee_ips,
                      "mnv3": mnv3_ips}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
