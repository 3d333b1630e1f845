"""Minimal PNG codec (pure Python/NumPy).

The port's own copy of ``nrc_hpm_tpu/utils/png.py`` (the port imports
nothing of the JAX package): the same decoder and the same bytes on
write.  It covers the textures of the model renderer's assets:
non-interlaced 8/16-bit gray, gray+alpha, RGB, RGBA and palette PNGs in,
8-bit gray/RGB/RGBA out.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_png(path: str) -> np.ndarray:
    """-> (H, W, C) uint8 (palette expanded, 16-bit downshifted)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError("not a PNG file")
    off = len(_SIG)
    width = height = None
    bit_depth = color_type = None
    palette = None
    idat = []
    while off < len(data):
        (length,) = struct.unpack_from(">I", data, off)
        ctype = data[off + 4:off + 8]
        chunk = data[off + 8:off + 8 + length]
        off += 12 + length
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if interlace:
                raise NotImplementedError("interlaced PNG unsupported")
            if bit_depth not in (8, 16):
                raise NotImplementedError(f"bit depth {bit_depth}")
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))
    nch = _CHANNELS[color_type]
    bpp = nch * (bit_depth // 8)
    stride = width * bpp
    out = np.zeros((height, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        filt = raw[pos]
        pos += 1
        line = np.frombuffer(raw[pos:pos + stride], np.uint8).astype(np.int32)
        pos += stride
        if filt == 0:
            rec = line
        elif filt == 1:  # Sub
            rec = line.copy()
            for i in range(bpp, stride):
                rec[i] = (rec[i] + rec[i - bpp]) & 0xFF
        elif filt == 2:  # Up
            rec = (line + prev) & 0xFF
        elif filt == 3:  # Average
            rec = line.copy()
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                rec[i] = (rec[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            rec = line.copy()
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[i] = (rec[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {filt}")
        out[y] = rec.astype(np.uint8)
        prev = rec
    img = out.reshape(height, width, bpp)
    if bit_depth == 16:
        img = img.reshape(height, width, nch, 2)[..., 0]  # high byte
    else:
        img = img.reshape(height, width, nch)
    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        img = palette[img[..., 0]]
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 1|3|4) uint8 (or float in [0,1]) as a PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    lines = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        body = ctype + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(lines, 6)))
        f.write(chunk(b"IEND", b""))
