"""Image comparison (port of trace_tpu/utils/compare.py): MSE, relative
MSE and PSNR, and a CLI that reads two PNGs with io/png.py:

    python -m trace_tpu_torch.utils.compare a.png b.png [--crop X0 Y0 X1 Y1]

It prints one JSON object {"mse", "rel_mse", "psnr"}.
"""
from __future__ import annotations

import numpy as np


def _to_float(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def mse(a, b) -> float:
    a, b = _to_float(a), _to_float(b)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} {b.shape}")
    return float(np.mean((a - b) ** 2))


def rel_mse(a, b, eps: float = 1e-2) -> float:
    """MSE relative to the reference image ``b``."""
    a, b = _to_float(a), _to_float(b)
    return float(np.mean(((a - b) ** 2) / (b * b + eps)))


def psnr(a, b) -> float:
    m = mse(a, b)
    return float("inf") if m == 0 else float(10.0 * np.log10(1.0 / m))


def compare(a, b) -> dict:
    return {"mse": mse(a, b), "rel_mse": rel_mse(a, b), "psnr": psnr(a, b)}


def main(argv=None) -> int:
    import argparse
    import json

    from ..io.png import read_png

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--crop", nargs=4, type=int,
                   metavar=("X0", "Y0", "X1", "Y1"))
    args = p.parse_args(argv)
    a, b = read_png(args.a), read_png(args.b)
    if args.crop:
        x0, y0, x1, y1 = args.crop
        a, b = a[y0:y1, x0:x1], b[y0:y1, x0:x1]
    print(json.dumps(compare(a, b)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
