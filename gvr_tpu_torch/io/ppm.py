"""P6 PPM codec, byte-compatible with the reference (``include/image.h``)
and with ``gvr_tpu/io/ppm.py``.

Writer: header ``P6\\n<w> <h>\\n255\\n`` then raw RGB bytes with the
reference's truncating clamp ``(unsigned char) clamp(v*255, 0, 255)``
(image.h:62-84): no rounding, no gamma.
"""

from __future__ import annotations

import numpy as np


def quantize(img: np.ndarray) -> np.ndarray:
    """float [H,W,3] -> uint8 with the truncating clamp (image.h:65-67)."""
    return np.clip(np.asarray(img, np.float32) * 255.0, 0.0,
                   255.0).astype(np.uint8)


def rgba_buffer(img: np.ndarray) -> np.ndarray:
    """uint8 [H,W,4] frame, the quantized image with an opaque alpha
    (image.h:87-105)."""
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = quantize(img)
    out[..., 3] = 255
    return out


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write float [H,W,3] as P6."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(quantize(img).tobytes())


def decode_ppm(data: bytes) -> np.ndarray:
    """P6 bytes -> float32 [H,W,3] in [0,1] (image.h:24-45)."""
    if not data.startswith(b"P6"):
        raise ValueError("Not a P6 PPM file.")
    pos = 2
    vals = []
    while len(vals) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        vals.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = vals
    if maxval > 255:
        raise ValueError(f"P6 maxval {maxval} uses 2 bytes/sample; only "
                         f"8-bit PPMs are supported")
    raw = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos)
    return raw.reshape(h, w, 3).astype(np.float32) / float(maxval)


def read_ppm(path: str) -> np.ndarray:
    """Read a P6 PPM into float32 [H,W,3] in [0,1]."""
    with open(path, "rb") as f:
        return decode_ppm(f.read())
