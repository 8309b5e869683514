"""Offline face detect → square-crop preprocessing tool (counterpart of
fr_tpu/tools/fd_processing.py, the same rules).

For every image under --input_dir (class-per-directory), detect the primary
face, square the box, crop, and write to a sibling `imgs_fd/` mirror that
the training folder loader reads.

- detector: OpenCV's Haar cascade from the system's OpenCV paths, or a
  centre-square crop where cv2 has no objdetect or no cascade is found (a
  warning says so); no detector model is fetched;
- the detector is built once, not per image;
- box selection: the largest detection.

Usage:
    python -m fr_tpu_torch.tools.fd_processing --input_dir <dir>/imgs \
        [--out_size 112] [--detector haar|center] [--margin 0.2]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


HAAR_PATHS = [
    "/usr/share/opencv4/haarcascades/haarcascade_frontalface_default.xml",
    "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt2.xml",
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="face detect + square crop")
    p.add_argument("--input_dir", required=True,
                   help="class-per-directory image root (…/imgs)")
    p.add_argument("--out_size", type=int, default=112)
    p.add_argument("--detector", choices=["haar", "center"], default="haar")
    p.add_argument("--margin", type=float, default=0.2,
                   help="relative margin added around the detected box")
    p.add_argument("--exts", default=".jpg,.jpeg,.png")
    return p.parse_args(argv)


def bbox2square(x0, y0, x1, y1, w, h, margin=0.0):
    """Expand a box to a square (with margin), clipped to the image."""
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    side = max(x1 - x0, y1 - y0) * (1.0 + margin)
    half = side / 2.0
    x0n, x1n = int(max(cx - half, 0)), int(min(cx + half, w))
    y0n, y1n = int(max(cy - half, 0)), int(min(cy + half, h))
    return x0n, y0n, x1n, y1n


def build_detector(kind: str):
    import cv2
    if kind == "center":
        return None
    if not hasattr(cv2, "CascadeClassifier"):
        # headless/minimal cv2 builds ship without objdetect
        print("warning: cv2 built without objdetect; falling back to "
              "center crop", file=sys.stderr)
        return None
    for path in HAAR_PATHS:
        if Path(path).exists():
            det = cv2.CascadeClassifier(path)
            if not det.empty():
                return det
    print("warning: no Haar cascade found; falling back to center crop",
          file=sys.stderr)
    return None


def detect_primary(det, gray):
    if det is None:
        return None
    faces = det.detectMultiScale(gray, scaleFactor=1.1, minNeighbors=4,
                                 minSize=(24, 24))
    if len(faces) == 0:
        return None
    # largest box = primary face
    x, y, w, h = max(faces, key=lambda f: f[2] * f[3])
    return int(x), int(y), int(x + w), int(y + h)


def process_tree(input_dir: str, out_size: int = 112, detector: str = "haar",
                 margin: float = 0.2, exts=(".jpg", ".jpeg", ".png")) -> dict:
    import cv2
    p = Path(input_dir)
    save_dir = p.parent / "imgs_fd"
    det = build_detector(detector)
    stats = {"total": 0, "detected": 0, "fallback": 0, "failed": 0}
    for img_path in sorted(p.glob("**/*")):
        if img_path.suffix.lower() not in exts:
            continue
        stats["total"] += 1
        img = cv2.imread(str(img_path), cv2.IMREAD_COLOR)
        if img is None:
            stats["failed"] += 1
            continue
        h, w = img.shape[:2]
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        box = detect_primary(det, gray)
        if box is None:
            # center square fallback
            side = min(h, w)
            x0 = (w - side) // 2
            y0 = (h - side) // 2
            box = (x0, y0, x0 + side, y0 + side)
            stats["fallback"] += 1
        else:
            stats["detected"] += 1
            box = bbox2square(*box, w=w, h=h, margin=margin)
        x0, y0, x1, y1 = box
        crop = img[y0:y1, x0:x1]
        crop = cv2.resize(crop, (out_size, out_size),
                          interpolation=cv2.INTER_LINEAR)
        out_path = save_dir / img_path.parent.name / img_path.name
        out_path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(out_path), crop)
    return stats


def main(argv=None):
    args = parse_args(argv)
    stats = process_tree(args.input_dir, args.out_size, args.detector,
                         args.margin, tuple(args.exts.split(",")))
    print(f"processed {stats['total']} images: {stats['detected']} detected, "
          f"{stats['fallback']} center-fallback, {stats['failed']} unreadable")


if __name__ == "__main__":
    main()
