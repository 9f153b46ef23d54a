"""GIF89a writer for turntable animations.

Counterpart of ``gvr_tpu/io/gif.py`` (the reference vendors ``gif-h``,
``tests/main.cpp:77-115``).  Every frame gets an adaptive palette (median
cut over its 15-bit colour histogram, each colour mapped to the nearest
palette entry through a 32^3 table) written as a local colour table.  Two
backends, the JAX package's:

* the full-LZW encoder of ``csrc/gif_native.cpp`` (the port's copy of the
  GIF part of ``gvr_tpu/native/gvr_native.cpp``), built at first use with
  the host C++ compiler (``kernels/_build.host_library``);
* where it cannot be built, numpy writing the *literal-code* LZW stream:
  every pixel its own 9-bit code, a clear code every 254, so the
  dictionary never grows and the bits pack with numpy alone.  Any decoder
  reads it; the files are larger.

Both give the JAX package's bytes for the same frames.  ``last_backend``
names the backend that wrote the last file ('native' or 'python').
"""

from __future__ import annotations

import ctypes

import numpy as np

from gvr_tpu_torch.io.ppm import quantize

last_backend = None

_native = None


def _native_library():
    """The GIF encoder's ctypes library, built at first use, or None where
    it cannot be built (no C++ compiler)."""
    global _native
    if _native is None:
        from gvr_tpu_torch.kernels import _build
        try:
            lib = _build.host_library("gif_native")
        except (OSError, RuntimeError):
            _native = False
            return None
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        lib.gvr_gif_begin.restype = ctypes.c_void_p
        lib.gvr_gif_begin.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
        lib.gvr_gif_frame_indexed.restype = ctypes.c_int
        lib.gvr_gif_frame_indexed.argtypes = [ctypes.c_void_p, u8p, u8p]
        lib.gvr_gif_end.restype = ctypes.c_int
        lib.gvr_gif_end.argtypes = [ctypes.c_void_p]
        _native = lib
    return _native or None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def write_gif(path: str, frames, delay_cs: int = 3) -> None:
    """Write float [H,W,3] frames in [0,1] as a looping GIF89a, through
    the native encoder where it is built, else the literal-code stream;
    ``last_backend`` says which.  Every frame must have the first's
    size."""
    global last_backend
    frames = [np.asarray(fr) for fr in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    if any(fr.shape != (h, w, 3) for fr in frames):
        raise ValueError(f"every frame must be [{h}, {w}, 3]")
    lib = _native_library()
    handle = lib.gvr_gif_begin(str(path).encode(), w, h, delay_cs) \
        if lib is not None else None
    if handle:
        ok = True
        for fr in frames:
            u8 = quantize(fr)
            pal = np.ascontiguousarray(adaptive_palette(u8))
            idx = np.ascontiguousarray(palette_indices(u8, pal), np.uint8)
            ok = ok and lib.gvr_gif_frame_indexed(handle, _u8p(idx),
                                                  _u8p(pal)) == 0
        ok = lib.gvr_gif_end(handle) == 0 and ok
        if ok:
            last_backend = "native"
            return
    _write_gif_python(path, frames, w, h, delay_cs)
    last_backend = "python"


# -----------------------------------------------------------------------------
# Adaptive palette (median cut), the gif-h quality model
# -----------------------------------------------------------------------------

def adaptive_palette(u8: np.ndarray, n_colors: int = 256) -> np.ndarray:
    """Median-cut palette [256,3] uint8 of one uint8 [H,W,3] frame.

    Over the 15-bit (5/5/5) colour histogram, the box with the largest
    extent times count is split at the count-weighted median of its widest
    axis until there are n_colors boxes; each box's colour is its
    count-weighted mean.  The JAX package's splits, in its order; each
    box's score is computed once, when the box is made, where the JAX
    package recomputes every box's at every split (the same numbers)."""
    q = (u8.reshape(-1, 3) >> 3).astype(np.int32)
    codes = (q[:, 0] << 10) | (q[:, 1] << 5) | q[:, 2]
    uniq, counts = np.unique(codes, return_counts=True)
    cols = np.stack([(uniq >> 10) & 31, (uniq >> 5) & 31, uniq & 31],
                    axis=-1).astype(np.float32)
    w = counts.astype(np.float64)

    def score(b):
        """(score, widest axis) of box b, or (0, 0) where it cannot
        split."""
        if b.size < 2:
            return 0.0, 0
        ext = cols[b].max(axis=0) - cols[b].min(axis=0)
        axis = int(ext.argmax())
        return float(ext[axis]) * float(w[b].sum()), axis

    boxes = [np.arange(uniq.size)]
    scores = [score(boxes[0])]
    while len(boxes) < n_colors:
        best, best_score = -1, 0.0
        for i, (s, _) in enumerate(scores):
            if s > best_score:
                best, best_score = i, s
        if best < 0:
            break
        b, axis = boxes[best], scores[best][1]
        order = b[np.argsort(cols[b, axis], kind="stable")]
        cw = np.cumsum(w[order])
        split = int(np.searchsorted(cw, cw[-1] * 0.5)) + 1
        split = min(max(split, 1), b.size - 1)
        boxes[best] = order[:split]
        boxes.append(order[split:])
        scores[best] = score(boxes[best])
        scores.append(score(boxes[-1]))

    pal = np.zeros((256, 3), np.uint8)
    for i, b in enumerate(boxes):
        c = (cols[b] * w[b, None]).sum(axis=0) / w[b].sum()
        pal[i] = np.clip(c * 8.0 + 4.0, 0, 255).astype(np.uint8)
    return pal


def palette_indices(u8: np.ndarray, pal: np.ndarray) -> np.ndarray:
    """Nearest-palette-colour indices [H,W] uint8 through a 32^3 table
    (one [32768, 256] distance table a frame, then a lookup)."""
    grid = np.stack(np.meshgrid(*([np.arange(32)] * 3), indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float32) * 8.0 + 4.0
    # |g - p|^2 = |g|^2 - 2 g.p + |p|^2 by one [32768,3] @ [3,256] product
    palf = pal.astype(np.float32)
    d = ((grid * grid).sum(-1, keepdims=True) - 2.0 * (grid @ palf.T)
         + (palf * palf).sum(-1)[None])
    lut = d.argmin(axis=1).astype(np.uint8)                   # [32768]
    q = (u8 >> 3).astype(np.int32)
    return lut[(q[..., 0] << 10) | (q[..., 1] << 5) | q[..., 2]]


# -----------------------------------------------------------------------------
# The numpy backend
# -----------------------------------------------------------------------------

def _palette_676() -> np.ndarray:
    """The 6x7x6 RGB cube: 252 colours, padded to 256."""
    r = np.linspace(0, 255, 6).round().astype(np.uint8)
    g = np.linspace(0, 255, 7).round().astype(np.uint8)
    b = np.linspace(0, 255, 6).round().astype(np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    grid = np.stack(np.meshgrid(r, g, b, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    pal[: grid.shape[0]] = grid
    return pal


def _lzw_literal_stream(indices: np.ndarray) -> bytes:
    """8-bit palette indices as a 9-bit literal LZW code stream.

    min_code_size 8: CLEAR = 256, END = 257.  A CLEAR every 254 literals
    keeps every code at 9 bits (the dictionary never reaches 512), so the
    bits pack with numpy."""
    px = indices.reshape(-1).astype(np.uint32)
    n = px.size
    block = 254
    nblocks = (n + block - 1) // block
    # codes: CLEAR, px[0:254], CLEAR, px[254:508], ..., END
    codes = np.empty(n + nblocks + 1, np.uint32)
    pos = 0
    for i in range(nblocks):
        codes[pos] = 256
        chunk = px[i * block:(i + 1) * block]
        codes[pos + 1:pos + 1 + chunk.size] = chunk
        pos += 1 + chunk.size
    codes[pos] = 257
    codes = codes[:pos + 1]

    bitpos = np.arange(codes.size, dtype=np.int64) * 9
    byte_idx = bitpos >> 3
    val = codes << (bitpos & 7).astype(np.uint32)          # < 2^16
    buf = np.zeros(int((codes.size * 9 + 7) // 8) + 1, np.uint8)
    np.add.at(buf, byte_idx, (val & 0xFF).astype(np.uint8))
    np.add.at(buf, byte_idx + 1, (val >> 8).astype(np.uint8))
    return buf[:(codes.size * 9 + 7) // 8].tobytes()


def _sub_blocks(data: bytes) -> bytes:
    """GIF data sub-blocks: a length byte before each 255-byte piece, then
    a zero."""
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def _write_gif_python(path, frames, w, h, delay_cs):
    """The numpy backend: the JAX package's bytes for the same frames."""
    with open(path, "wb") as f:
        f.write(b"GIF89a")
        # logical screen descriptor: global colour table, 8 bits, 256
        # entries
        f.write(np.array([w, h], "<u2").tobytes())
        f.write(bytes([0xF7, 0, 0]))
        f.write(_palette_676().tobytes())
        # the Netscape looping extension
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        for fr in frames:
            u8 = quantize(np.asarray(fr))
            pal = adaptive_palette(u8)
            idx = palette_indices(u8, pal)
            # graphic control extension
            f.write(b"\x21\xf9\x04\x04")
            f.write(np.array([delay_cs], "<u2").tobytes())
            f.write(b"\x00\x00")
            # image descriptor with a local colour table
            f.write(b"\x2c")
            f.write(np.array([0, 0, w, h], "<u2").tobytes())
            f.write(bytes([0x87]))
            f.write(pal.tobytes())
            # LZW minimum code size, then the data sub-blocks
            f.write(bytes([8]))
            f.write(_sub_blocks(_lzw_literal_stream(idx)))
        f.write(b"\x3b")
