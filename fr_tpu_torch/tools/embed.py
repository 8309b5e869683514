"""Offline embedding export: images → L2-normalised face embeddings
(counterpart of fr_tpu/tools/embed.py, the same arguments and outputs).

    python -m fr_tpu_torch.tools.embed --ckpt save/.../10_epoch_encoder.npz \
        --network ResNet100 --input_dir /data/faces --out /tmp/emb \
        [--device cuda]

Reads fr_tpu ``.npz`` encoder snapshots and reference ``.pth`` checkpoints
(train/task.py ``load_encoder_snapshot``), loaded strictly. ``--input_dir``
may be a flat directory of images or a class-per-directory tree; images are
decoded and resized on the host, normalised with mean .5 / std .5 as the
evaluation sets are, and embedded by the embedding step of the validation
path (train/step.py ``make_embed_step``), the tail batch padded to the batch
size. Writes ``<out>.npy`` (N, emd_size) float32 and ``<out>.files.txt``
(one source path per row). ``--device cuda`` raises when no CUDA device is
present; ``--device cpu`` runs the encoder's plain versions.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_images(input_dir: str):
    """Flat dir of images, or any directory tree (class dirs included), in
    sorted order."""
    root = Path(input_dir)
    if not root.is_dir():
        raise FileNotFoundError(input_dir)
    files = sorted(str(p) for p in root.rglob("*")
                   if p.is_file() and p.suffix.lower() in IMG_EXTENSIONS)
    if not files:
        raise FileNotFoundError(f"no images under {input_dir}")
    return files


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help=".npz encoder snapshot or reference .pth")
    p.add_argument("--network", default="ResNet100")
    p.add_argument("--config", default="ms1m_arcface_122")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--out", required=True, help="output prefix")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--img_size", type=int, default=None,
                   help="default: config img_size (112, or 192 for AlterNet)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the encoder runs; cuda raises when absent")
    args = p.parse_args(argv)

    from fr_tpu_torch.configs import load_config
    from fr_tpu_torch.data.folder import _decode_resize
    from fr_tpu_torch.models import build_encoder
    from fr_tpu_torch.train.step import make_embed_step
    from fr_tpu_torch.train.task import load_encoder_snapshot, resolve_device

    conf = load_config(args.config, network=args.network)
    if args.img_size:
        conf.img_size = args.img_size
    device = resolve_device(args.device)
    encoder = build_encoder(conf)
    encoder.load_state_dict(load_encoder_snapshot(
        args.ckpt, args.network, conf.img_size), strict=True)
    encoder.to(device).eval()
    embed = make_embed_step(conf, encoder, device)

    files = list_images(args.input_dir)
    out = np.empty((len(files), conf.emd_size), np.float32)
    bs = args.batch
    for s in range(0, len(files), bs):
        sel = files[s:s + bs]
        imgs = np.empty((len(sel), conf.img_size, conf.img_size, 3),
                        np.float32)
        for j, f in enumerate(sel):
            imgs[j] = (_decode_resize(f, conf.img_size).astype(np.float32)
                       / 255.0 - 0.5) / 0.5
        # pad the tail so every call sees the same batch shape
        if len(sel) < bs:
            imgs = np.concatenate(
                [imgs, np.zeros((bs - len(sel),) + imgs.shape[1:],
                                np.float32)])
        emb = embed(imgs).cpu().numpy()
        out[s:s + len(sel)] = emb[:len(sel)]

    np.save(args.out + ".npy", out)
    with open(args.out + ".files.txt", "w") as fh:
        fh.write("\n".join(files) + "\n")
    print(f"embedded {len(files)} images ({args.network}, "
          f"{conf.emd_size}-d, {device}) -> {args.out}.npy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
