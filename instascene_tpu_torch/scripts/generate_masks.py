"""Offline 2D instance masks → <scene>/sam/mask/<image>.png.

    python -m instascene_tpu_torch.scripts.generate_masks -s <scene>
        --from_dir <label maps>

Port of scripts/generate_masks.py (`masks_from_dir`, `main`). The pipeline
reads integer label maps, one per training image with its base name (0
unlabeled, k > 0 instance k). --from_dir converts existing maps (e.g.
CropFormer's), each <name>.png (8- or 16-bit gray, or the first band of a
colour PNG) or <name>.npy, to 16-bit gray PNGs written with the port's
encoder. The JAX script's --hf_model path (a Mask2Former checkpoint) needs
downloaded weights and the transformers package; it is not ported, and the
flag exits with a message.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def masks_from_dir(image_paths, out_dir, src_dir):
    from ..utils.image import read_image, write_png
    for p in image_paths:
        base = os.path.basename(p).split(".")[0]
        for ext in (".png", ".npy"):
            src = os.path.join(src_dir, base + ext)
            if os.path.exists(src):
                arr = np.load(src) if ext == ".npy" else read_image(src)
                if arr.ndim == 3:
                    arr = arr[..., 0]
                write_png(os.path.join(out_dir, base + ".png"),
                          arr.astype(np.uint16))
                break
        else:
            print(f"warning: no mask source for {base}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source_path", "-s", required=True)
    ap.add_argument("--images", default="images")
    ap.add_argument("--hf_model", default="",
                    help="not ported: needs a checkpoint on local disk")
    ap.add_argument("--from_dir", default="",
                    help="directory of precomputed label maps to convert")
    ap.add_argument("--confidence", type=float, default=0.8)
    args = ap.parse_args(argv)

    if not args.from_dir:
        raise SystemExit(
            "provide --from_dir (see the docstring for the sam/mask "
            "contract); --hf_model needs Mask2Former weights on local disk "
            "and is served by the JAX package's script only")
    img_dir = os.path.join(args.source_path, args.images)
    out_dir = os.path.join(args.source_path, "sam/mask")
    os.makedirs(out_dir, exist_ok=True)
    image_paths = sorted(
        os.path.join(img_dir, f) for f in os.listdir(img_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    masks_from_dir(image_paths, out_dir, args.from_dir)
    return out_dir


if __name__ == "__main__":
    main()
