"""Offline corpus packer: ImageFolder layout → memory-mapped packed format
(counterpart of fr_tpu/tools/pack_dataset.py).

    python -m fr_tpu_torch.tools.pack_dataset --src <dir-with-imgs/> \
        --dst <packed-dir> --img_size 112

Training then uses `--packed_dir <packed-dir>` (fr_tpu_torch/cli/main.py)
and never touches a JPEG decoder on the hot path.
"""

from __future__ import annotations

import argparse

from fr_tpu_torch.data.packed import pack_image_folder


def main(argv=None):
    p = argparse.ArgumentParser(description="pack an image-folder corpus")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--img_size", type=int, default=112)
    args = p.parse_args(argv)
    n = pack_image_folder(args.src, args.dst, args.img_size)
    print(f"packed {n} images into {args.dst}")


if __name__ == "__main__":
    main()
