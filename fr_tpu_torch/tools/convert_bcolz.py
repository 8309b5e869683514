"""Offline converter: bcolz validation-set rootdir → npy layout
(counterpart of fr_tpu/tools/convert_bcolz.py).

    python -m fr_tpu_torch.tools.convert_bcolz --src <data_root>/lfw \
        --dst <out_root>/lfw

Reads the reference's bcolz carray rootdir (the LFW-family pair sets) and
writes `<dst>.npy` with the identical (N, C, H, W) tensor, plus a copy of
`<src>_list.npy` as `<dst>_list.npy`: the layout fr_tpu_torch/data/pairs.py
reads without bcolz. Uses bcolz when it imports, else the port's rootdir
reader (fr_tpu_torch/data/bcolz_reader.py: libblosc through ctypes).

PairDataset reads bcolz rootdirs directly through the same reader, so
conversion is optional: it trades a one-time decode for a memory-mapped
start.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

import numpy as np


def load_rootdir(src: str) -> np.ndarray:
    try:
        import bcolz
    except ImportError:
        from fr_tpu_torch.data.bcolz_reader import read_carray
        return read_carray(src)
    return np.asarray(bcolz.carray(rootdir=src, mode="r"))


def convert(src: str, dst: str) -> np.ndarray:
    arr = load_rootdir(src)
    dst_p = Path(dst)
    dst_p.parent.mkdir(parents=True, exist_ok=True)
    np.save(str(dst_p) + ".npy", arr)
    src_list = Path(str(Path(src)) + "_list.npy")
    if src_list.exists():
        shutil.copyfile(src_list, str(dst_p) + "_list.npy")
    return arr


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", required=True, help="bcolz carray rootdir")
    p.add_argument("--dst", required=True,
                   help="output prefix (writes <dst>.npy [+ <dst>_list.npy])")
    args = p.parse_args(argv)
    arr = convert(args.src, args.dst)
    print(f"converted {args.src} -> {args.dst}.npy "
          f"{arr.shape} {arr.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
