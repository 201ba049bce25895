"""Minimal dependency-free PNG writer: 8-bit RGB, zlib-compressed.

Copy of pathtracer_tpu/io/png.py (to_u8, write_png)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """Float [0,1] (H,W,3) -> uint8 by truncation, not rounding (the
    reference's image pipeline truncates; see the JAX copy's note)."""
    x = np.clip(np.asarray(img, np.float64), 0.0, 1.0)
    return np.clip(np.trunc(x * 255.0), 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float in [0,1] or uint8."""
    if img.dtype != np.uint8:
        img = to_u8(img)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    payload = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
               + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(payload)
