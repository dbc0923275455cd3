"""Per-exit palette PNGs of arbitrary images.

Port of ``ee_semantic_segmentation_tpu/cli/eval_image.py``: load the
model(s), run each image at its own size, and save one palette PNG per exit
as ``{net_id}_images/{img}_b{i}.png``, resized to the input's size (PIL's
default resampling for mode ``P``, nearest), with the same pseudo-palette
``(arange(21)[:, None] * [2^25-1, 2^15-1, 2^21-1]) % 255``.  Plus
``--device``.  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.eval_image -M <ckpt> -i a.jpg b.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def voc_palette(n: int = 21) -> np.ndarray:
    base = np.array([2**25 - 1, 2**15 - 1, 2**21 - 1], np.int64)
    colors = (np.arange(n)[:, None] * base) % 255
    return colors.astype(np.uint8)


def build_parser():
    from ee_semantic_segmentation_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="Evaluate trained models.")
    p.add_argument("-M", "--models", nargs="+", default=[])
    p.add_argument("-i", "--images", nargs="+", default=[])
    p.add_argument("-v", "--verbose", action="store_true", default=False)
    common.add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch
    from PIL import Image

    from ee_semantic_segmentation_tpu_torch.cli import common
    from ee_semantic_segmentation_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    device = common.resolve_device(args.device)
    colors = voc_palette()
    og_dir = os.getcwd()
    for model_path in args.models:
        net_id = common.net_id_of(model_path)
        if args.verbose:
            print(f"Started evaluation of {net_id}.")
        save_at = os.path.join(og_dir, f"{net_id}_images")
        os.makedirs(save_at, exist_ok=True)
        fwd = common.forward_fn(common.load_model(model_path, device))
        for img_path in args.images:
            if args.verbose:
                print(f"\tImage: {img_path}")
            pil = Image.open(os.path.join(og_dir, img_path)).convert("RGB")
            arr = np.asarray(pil, np.float32) / 255.0
            arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
            out = fwd(arr[None])  # (E, 1, H, W, C)
            preds = out.argmax(dim=-1)[:, 0].to(torch.uint8).cpu().numpy()  # (E, H, W)
            img_name = img_path.split("/")[-1].split(".")[0]
            for i in range(preds.shape[0]):
                r = Image.fromarray(preds[i])  # mode L: the pixels are the indices
                r.putpalette(colors.reshape(-1))  # L -> P, before the resize
                r = r.resize(pil.size)
                r.save(os.path.join(save_at, f"{img_name}_b{i + 1}.png"))
        if args.verbose:
            print(f"Finished {net_id} evalutation. Resulting images can be found @ {save_at}.")


if __name__ == "__main__":
    main()
