"""The comparison that decides `correct`: each compared image of the
window against the reference's image of the same scene.

Numbers, each the worst over the compared images:
- image_rmse: RMSE of the image against the reference's, over the RMS of
  the reference's (non-finite pixels of the image taken as 0 here, and
  counted below);
- segments_gap: |segments - the reference's| / the reference's;
- nonfinite_px: the image's pixel values that are NaN or infinite (limit
  0: an exact comparison).
"""

from __future__ import annotations

import numpy as np

__all__ = ["NUMBERS", "image_numbers", "judge"]

NUMBERS = ("image_rmse", "segments_gap", "nonfinite_px")


def image_numbers(img, segments: int, ref, ref_segments: int) -> dict:
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    if img.shape != ref.shape:
        raise ValueError(f"image {img.shape} against reference {ref.shape}")
    finite = np.isfinite(img)
    diff = np.where(finite, img, 0.0) - ref
    rms = float(np.sqrt(np.mean(ref * ref)))
    return {"image_rmse": float(np.sqrt(np.mean(diff * diff))) / rms,
            "segments_gap": abs(int(segments) - int(ref_segments))
            / max(int(ref_segments), 1),
            "nonfinite_px": int((~finite).sum())}


def judge(per_image: list[dict], limits: dict) -> tuple[dict, int]:
    """(the worst of each number over the images, the images with a number
    over its limit)."""
    worst = {k: max(n[k] for n in per_image) for k in NUMBERS}
    failed = sum(any(n[k] > limits[k] for k in NUMBERS) for n in per_image)
    return worst, failed
