"""Sequential early-exit engine: segment-at-a-time inference of one image
with per-exit FLOPs pricing.

Port of ``ee_semantic_segmentation_tpu/ee/sequential.py``: run trunk
segment ``i``, compute exit ``i``'s label map, evaluate the gate (normalized
entropy of the exit's softmax, or the similarity of its label map to the
previous exit's) and stop gating at the first exit that fires.

* The FLOPs come from the analytic table (``model.flops_table``), computed
  once.
* The only host read per gated stage is the gate's scalar (``.item()``);
  the label maps stay on the device.
* As in the reference, the final segment and classifier always run, so
  the ``'last'`` map and its FLOPs are reported beside the gated exit.

The control flow is host-side Python by design: this engine models
single-image edge serving, where later segments really never run.  For
batched policy evaluation use ``ee/masked.py`` or ``ee/batch_eval.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ee_semantic_segmentation_tpu_torch.ops.gating import norm_entropy, similarity


class EarlyExitRunner:
    """Callable: (H, W, 3) or (1, H, W, 3) image -> dict with the exit map,
    its FLOPs and the exit index.

    Args:
      model: the branchy model (its weights on the device it runs on).
      metric: 'ssim' | 'mse' | 'nmi' | 'vi' | 'h_xy' | 'h_yx' for the
        similarity gate (ee_dnn_op.py), or 'ent' | 'max' | 'min' for the
        entropy gate (ee_dnn_op_ne.py).
      threshold: gate threshold tau.
      less_than: the gate fires when value < tau (True) or > tau.
      ignore: 0-based branch indices to skip entirely (ee_dnn_op.py '-I').
      n_classes: class count (entropy base / similarity histogram size).
      pool_size: block-reduce size for 'max'/'min' entropy pooling.
      sim_ignore: labels ignored by the VI/seg_comp gates.
      img_dim: the size the FLOPs are priced at (the model's by default).
    """

    def __init__(
        self,
        model,
        *,
        metric: str = "ent",
        threshold: float = 0.5,
        less_than: bool = True,
        ignore: Sequence[int] = (),
        n_classes: int = 21,
        pool_size: int = 1,
        sim_ignore: Sequence[int] = (),
        img_dim: int | tuple[int, int] | None = None,
    ):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.metric = metric.lower()
        self.entropy_gate = self.metric in ("ent", "max", "min")
        self.pool = {"ent": "none", "max": "max", "min": "min"}.get(self.metric, "none")
        self.threshold = threshold
        self.less_than = less_than
        self.ignore = set(int(i) for i in ignore)
        self.n_classes = n_classes
        self.pool_size = pool_size
        self.sim_ignore = tuple(sim_ignore)
        self.n = model.config.n_branches
        non_ignored = [i for i in range(self.n) if i not in self.ignore]
        self.last_br = max(non_ignored) if non_ignored else -1

        table = model.flops_table(img_dim)
        self.segment_flops = table["segments"]
        self.branch_flops_table = table["branches"]

    def _gate_value(self, logits, y_ref, br_map) -> float:
        if self.entropy_gate:
            probs = torch.softmax(logits.float(), dim=-1)
            return norm_entropy(probs[0], self.n_classes, self.pool, self.pool_size).item()
        return similarity(y_ref[0], br_map[0], self.metric, self.n_classes,
                          self.sim_ignore).item()

    def _fires(self, value: float) -> bool:
        return value < self.threshold if self.less_than else value > self.threshold

    def __call__(self, image) -> dict:
        """image: (H, W, 3) or (1, H, W, 3) preprocessed input, numpy or a
        tensor.  The maps of the result are (H, W) int32 tensors on the
        model's device."""
        with torch.inference_mode():
            return self._run(torch.as_tensor(image, dtype=torch.float32).to(self.device))

    def _run(self, x) -> dict:
        model = self.model
        if x.ndim == 3:
            x = x[None]
        out_hw = tuple(x.shape[1:3])
        x = x.permute(0, 3, 1, 2)  # NCHW once; the segments take NCHW features

        output: dict = {}
        main_flops: list[float] = []
        branch_flops: list[float] = []
        y_ref = None
        left = False

        for i in range(self.n):
            main_flops.append(self.segment_flops[i])
            x = model.run_segment(i, x)

            if i not in self.ignore and not left:
                logits = model.run_branch(i, x, out_hw)
                br_map = logits.argmax(dim=-1).int()  # (1, H, W)
                branch_flops.append(self.branch_flops_table[i])

                # the similarity gate's first evaluated branch only seeds y_ref
                fired = (self.entropy_gate or y_ref is not None) and self._fires(
                    self._gate_value(logits, y_ref, br_map))
                if fired:
                    output["exit"] = br_map[0]
                    output["exit_flops"] = sum(branch_flops) + sum(main_flops)
                    output["exit_flops_2"] = sum(branch_flops[1:]) + sum(main_flops)
                    output["edge_flops"] = output["exit_flops"]
                    output["edge_flops_2"] = output["exit_flops_2"]
                    output["n"] = i + 1
                    left = True
                else:
                    y_ref = br_map
            if not left and i == self.last_br:
                output["edge_flops"] = sum(branch_flops) + sum(main_flops)
                output["edge_flops_2"] = sum(branch_flops[1:]) + sum(main_flops)

        # final segment + classifier: always computed for 'last'
        main_flops.append(self.segment_flops[-1])
        x = model.run_segment(self.n, x)
        main_flops.append(self.branch_flops_table[-1])
        y_map = model.run_classifier(x, out_hw).argmax(dim=-1).int()[0]
        output["last"] = y_map
        output["last_flops"] = sum(branch_flops) + sum(main_flops)
        output["last_flops_2"] = sum(branch_flops[1:]) + sum(main_flops)
        if not left:
            output["exit"] = y_map
            output["exit_flops"] = output["last_flops"]
            output["exit_flops_2"] = output["last_flops_2"]
            output.setdefault("edge_flops", output["last_flops"])
            output.setdefault("edge_flops_2", output["last_flops_2"])
            output["n"] = self.n + 1
        return output
