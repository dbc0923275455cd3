"""Batched early-exit serving: a stage pipeline with queues at a fixed
micro-batch size.

Port of ``ee_semantic_segmentation_tpu/ee/serving.py``:

* trunk segment ``k``, its branch head and the entropy gate run as one
  stage on a micro-batch of exactly B images (the last partial batch of a
  stage is padded with copies of its last item at ``flush()``), so the
  convolutions always see one batch shape;
* each stage has a queue.  An image that fails its gate passes its
  *features* on to the next stage's queue; an image that passes leaves the
  pipeline with its label map.  Images that exit early never occupy a
  later, more expensive stage;
* dispatch and resolve are split: a whole wave of ready micro-batches is
  launched before the first gate vector is read, and each stage copies only
  its (B,) gate vector to the host (into pinned memory, behind an event, on
  the card).  Survivors' features are gathered on the device, and exited
  images' label maps stay there until ``flush()`` fetches them.

The bookkeeping uses the analytic FLOPs table (``flops_table``): every
micro-batch pays its stage's segment and head for all B slots, padding
included, so ``avg_flops_per_image`` is the compute the server spent.
``stats()`` gives the per-stage runs, the share of filled slots, the padded
slots and the dispatch waves.

The stages run the plain PyTorch head (upsample, softmax entropy, argmax),
as the JAX server runs plain XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ee_semantic_segmentation_tpu_torch.ops.gating import norm_entropy


@dataclasses.dataclass
class _Item:
    uid: int
    data: torch.Tensor  # an NHWC image or NCHW features, without the batch dim


@dataclasses.dataclass
class _Pending:
    """A dispatched micro-batch: its stage, items and device results, and
    its gate vector on its way to the host."""

    k: int
    items: list
    feats: torch.Tensor
    labels: torch.Tensor
    gate: torch.Tensor  # host copy of the (B,) gate vector once ``ready``
    ready: torch.cuda.Event | None


class BatchedEarlyExitServer:
    """Entropy-gated streaming server over a branchy model.

    Usage::

        server = BatchedEarlyExitServer(model, tau=0.3, batch_size=8)
        server.submit(images)          # (N, H, W, 3), any N
        results = server.flush()       # uid -> {"label_map", "n" (1-based exit)}

    The model runs on its own device in its own parameter dtype; images are
    converted to both.
    """

    def __init__(self, model, *, tau: float, batch_size: int = 8, n_classes: int = 21,
                 skip: int = 0, img_hw: tuple[int, int] | None = None):
        self.model = model.eval()
        first = next(model.parameters())
        self.device, self.dtype = first.device, first.dtype
        self.tau = tau
        self.B = batch_size
        self.n_classes = n_classes
        self.skip = skip
        self.n = model.config.n_branches
        self.out_hw = tuple(img_hw or model.config.img_hw)

        table = model.flops_table(self.out_hw)
        self._seg_flops = table["segments"]
        self._br_flops = table["branches"]

        self._queues: list[list[_Item]] = [[] for _ in range(self.n + 1)]
        self._results: dict[int, dict] = {}
        # exited maps deferred on the device: (uids, exit index, maps)
        self._pending_maps: list[tuple[list[int], int, torch.Tensor]] = []
        self._next_uid = 0
        self.stage_runs = np.zeros(self.n + 1, np.int64)
        self.total_flops = 0.0
        self.padded_slots = 0
        self.filled_slots = 0
        self.wave_sizes: list[int] = []

    # ------------------------------------------------------------------
    def _stage(self, k: int, x: torch.Tensor):
        """Stage k on a micro-batch -> (features, (B, H, W) int32 labels,
        (B,) float32 gate).  An ungated branch position (k < skip) runs the
        trunk only and never lets an image out (gate +inf)."""
        m, B = self.model, x.shape[0]
        feats = m.run_segment(k, x.permute(0, 3, 1, 2) if k == 0 else x)
        if k == self.n:
            labels = m.run_classifier(feats, self.out_hw).argmax(dim=-1).int()
            return feats, labels, torch.zeros((B,), dtype=torch.float32, device=x.device)
        if k >= self.skip:
            logits = m.run_branch(k, feats, self.out_hw)
            probs = torch.softmax(logits.float(), dim=-1)
            return feats, logits.argmax(dim=-1).int(), norm_entropy(probs, self.n_classes)
        dummy = torch.zeros((B,) + self.out_hw, dtype=torch.int32, device=x.device)
        return feats, dummy, torch.full((B,), torch.inf, device=x.device)

    def submit(self, images) -> list[int]:
        """Enqueue (N, H, W, 3) images; returns their uids.  Stages run
        whenever a full micro-batch is queued."""
        images = torch.as_tensor(images).to(device=self.device, dtype=self.dtype)
        uids = []
        for i in range(images.shape[0]):
            uid = self._next_uid
            self._next_uid += 1
            self._queues[0].append(_Item(uid, images[i]))
            uids.append(uid)
        self._drain(full_only=True)
        return uids

    @torch.inference_mode()
    def _dispatch_stage(self, k: int, items: list[_Item]) -> _Pending:
        """Launch stage k on a micro-batch; nothing here waits for the
        device."""
        pad = self.B - len(items)
        xs = [it.data for it in items]
        x = torch.stack(xs + [xs[-1]] * pad)
        feats, labels, gate = self._stage(k, x)
        ready = None
        if gate.is_cuda:
            host = torch.empty(gate.shape, dtype=gate.dtype, pin_memory=True)
            host.copy_(gate, non_blocking=True)
            gate, ready = host, torch.cuda.Event()
            ready.record()
        self.stage_runs[k] += 1
        self.padded_slots += pad
        self.filled_slots += len(items)
        # realized compute: the whole micro-batch pays the stage's cost
        head = (self._br_flops[k] if self.skip <= k < self.n
                else self._br_flops[-1] if k == self.n else 0.0)
        self.total_flops += self.B * (self._seg_flops[k] + head)
        return _Pending(k, items, feats, labels, gate, ready)

    @torch.inference_mode()
    def _resolve(self, p: _Pending) -> None:
        """Wait for the gate vector alone, queue the survivors' features
        (a gather on the device) and park the exited images' label maps on
        the device."""
        if p.ready is not None:
            p.ready.synchronize()
        gate = p.gate[: len(p.items)].tolist()
        if p.k == self.n:
            exited = list(range(len(p.items)))
        elif p.k >= self.skip:
            exited = [j for j, g in enumerate(gate) if g < self.tau]
        else:
            exited = []
        survivors = [j for j in range(len(p.items)) if j not in set(exited)]
        dev = p.labels.device
        if exited:
            maps = p.labels.index_select(0, torch.tensor(exited, device=dev))
            self._pending_maps.append(([p.items[j].uid for j in exited], p.k + 1, maps))
        if survivors:
            surv = p.feats.index_select(0, torch.tensor(survivors, device=dev))
            for row, j in enumerate(survivors):
                self._queues[p.k + 1].append(_Item(p.items[j].uid, surv[row]))

    def _drain(self, full_only: bool = True) -> None:
        progressed = True
        while progressed:
            progressed = False
            # dispatch every runnable micro-batch before resolving any gate:
            # each resolve's wait then overlaps the other stages' compute
            wave = []
            for k in range(self.n + 1):
                q = self._queues[k]
                while len(q) >= self.B:
                    wave.append(self._dispatch_stage(k, [q.pop(0) for _ in range(self.B)]))
            if not wave and not full_only:
                for k in range(self.n + 1):
                    q = self._queues[k]
                    if q:
                        wave.append(self._dispatch_stage(k, [q.pop(0) for _ in range(len(q))]))
            if wave:
                self.wave_sizes.append(len(wave))
            for p in wave:
                self._resolve(p)
                progressed = True

    def _materialize(self) -> None:
        for uids, n_exit, maps in self._pending_maps:
            maps_np = maps.cpu().numpy()
            for row, uid in enumerate(uids):
                self._results[uid] = {"label_map": maps_np[row], "n": n_exit}
        self._pending_maps = []

    def flush(self) -> dict[int, dict]:
        """Run every remaining partial batch (padded); returns uid ->
        {"label_map": (H, W) int32 numpy, "n": 1-based exit}."""
        while any(self._queues):
            self._drain(full_only=False)
        self._materialize()
        out, self._results = self._results, {}
        return out

    def stats(self) -> dict:
        """Per-stage run counts, slot occupancy, padded slots and dispatch
        waves (a wave of more than one micro-batch overlaps stages)."""
        total_slots = self.filled_slots + self.padded_slots
        return {
            "stage_runs": self.stage_runs.tolist(),
            "occupancy": self.filled_slots / max(total_slots, 1),
            "padded_slots": self.padded_slots,
            "waves": len(self.wave_sizes),
            "mean_wave": float(np.mean(self.wave_sizes)) if self.wave_sizes else 0.0,
            "avg_flops_per_image": self.avg_flops_per_image,
        }

    @property
    def avg_flops_per_image(self) -> float:
        return self.total_flops / max(self._next_uid, 1)
