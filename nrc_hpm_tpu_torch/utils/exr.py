"""Minimal OpenEXR scanline codec and Radiance .hdr reader (numpy).

The port's own copy of ``nrc_hpm_tpu/utils/exr.py`` (the port imports
nothing of the JAX package): the same reader and the same byte layout on
write, so a file written by either package is byte-identical at the same
arguments.  The reference stores golden images and render exports as
RGBA float EXRs.  Read: single-part scanline EXRs, NO/ZIPS/ZIP
compression, HALF/FLOAT/UINT channels, increasing line order.  Write:
RGBA FLOAT scanlines, ZIPS-compressed or raw.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}

NO_COMPRESSION = 0
RLE_COMPRESSION = 1
ZIPS_COMPRESSION = 2
ZIP_COMPRESSION = 3

_LINES_PER_BLOCK = {NO_COMPRESSION: 1, ZIPS_COMPRESSION: 1,
                    ZIP_COMPRESSION: 16}


def _read_cstr(buf: bytes, off: int):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("ascii"), end + 1


def _unpredict(t: np.ndarray) -> np.ndarray:
    """EXR zip post-inflate decode: integrate the delta predictor then
    de-interleave the two byte lanes."""
    t = t.astype(np.int64)
    t = (np.cumsum(t - 128) + 128 * 1) % 256  # d[i] += d[i-1] - 128
    t = t.astype(np.uint8)
    n = t.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out


def _predict(data: np.ndarray) -> np.ndarray:
    """Inverse of _unpredict for writing (interleave split + delta)."""
    n = data.size
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = data[0::2]
    t[half:] = data[1::2]
    d = t.astype(np.int16)
    d[1:] = d[1:] - t[:-1].astype(np.int16) + 128
    return d.astype(np.uint8)


def read_exr(path: str):
    """Read an EXR file -> dict of channel name -> (H, W) float32 array."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise NotImplementedError("multi-part EXR not supported")
    off = 8

    channels = []  # (name, pixel_type)
    compression = NO_COMPRESSION
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            break
        type_name, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while payload[coff] != 0:
                cname, coff = _read_cstr(payload, coff)
                ptype, = struct.unpack_from("<i", payload, coff)
                coff += 16  # pixel type + pLinear/reserved + x/y sampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)

    if compression not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {compression} unsupported")
    xmin, ymin, xmax, ymax = data_window
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    lines_per_block = _LINES_PER_BLOCK[compression]
    n_blocks = (height + lines_per_block - 1) // lines_per_block

    # channels are stored per scanline in the header (alphabetical) order
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)

    out = {name: np.zeros((height, width), np.float32)
           for name, _ in channels}
    bytes_per_px = {0: 4, 1: 2, 2: 4}
    line_bytes = sum(bytes_per_px[pt] for _, pt in channels) * width

    for bi, boff in enumerate(offsets):
        y, packed = struct.unpack_from("<ii", buf, boff)
        raw = buf[boff + 8: boff + 8 + packed]
        n_lines = min(lines_per_block, ymax - y + 1)
        expect = line_bytes * n_lines
        if compression in (ZIPS_COMPRESSION, ZIP_COMPRESSION) \
                and packed < expect:
            data = np.frombuffer(zlib.decompress(raw), np.uint8)
            data = _unpredict(data)
        else:
            data = np.frombuffer(raw, np.uint8)
        pos = 0
        for li in range(n_lines):
            yy = y - ymin + li
            for cname, ptype in channels:
                nb = bytes_per_px[ptype] * width
                vals = np.frombuffer(
                    data[pos:pos + nb].tobytes(), _PIXEL_DTYPES[ptype])
                out[cname][yy] = vals.astype(np.float32)
                pos += nb
    return out


def read_exr_rgba(path: str) -> np.ndarray:
    """(H, W, 4) float32 RGBA; missing channels are zero-filled."""
    ch = read_exr(path)
    h, w = next(iter(ch.values())).shape
    img = np.zeros((h, w, 4), np.float32)
    for i, name in enumerate("RGBA"):
        if name in ch:
            img[..., i] = ch[name]
    return img


def write_exr(path: str, img: np.ndarray, compress: bool = True):
    """Write (H, W, 3|4) float32 as an RGBA scanline EXR (ZIPS or raw)."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("expected (H, W, 3|4) image")
    h, w = img.shape[:2]
    if img.shape[2] == 3:
        img = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=-1)
    names = ["A", "B", "G", "R"]  # alphabetical storage order
    chans = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2],
             "A": img[..., 3]}

    def attr(name, type_name, payload):
        return (name.encode() + b"\x00" + type_name.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    chlist += b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    comp = ZIPS_COMPRESSION if compress else NO_COMPRESSION

    header = struct.pack("<iI", _MAGIC, 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([comp]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    blocks = []
    for y in range(h):
        line = b"".join(chans[n][y].astype("<f4").tobytes() for n in names)
        if compress:
            packed = zlib.compress(
                _predict(np.frombuffer(line, np.uint8)).tobytes())
            if len(packed) >= len(line):
                packed = line
        else:
            packed = line
        blocks.append(struct.pack("<ii", y, len(packed)) + packed)

    table_off = len(header) + 8 * h
    offsets = []
    pos = table_off
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for b in blocks:
            f.write(b)


def read_any_hdr(path: str) -> np.ndarray:
    """Load an HDR image (EXR or Radiance .hdr) as (H, W, >=3) float32."""
    if path.lower().endswith(".exr"):
        return read_exr_rgba(path)
    if path.lower().endswith(".hdr"):
        return read_radiance_hdr(path)
    raise NotImplementedError(f"unsupported HDR format: {path}")


def read_radiance_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader — the stbi_loadf path the
    reference's HDR env maps would use (src/read_file.cpp:95).  Supports
    the common -Y H +X W layout with new-style RLE scanlines."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        # header lines until blank
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise NotImplementedError(f"unsupported HDR layout {dims}")
        h, w = int(dims[1]), int(dims[3])
        data = np.frombuffer(f.read(), np.uint8)

    out = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (data[pos] == 2 and data[pos + 1] == 2
                and (int(data[pos + 2]) << 8 | int(data[pos + 3])) == w):
            # new-style RLE: per-channel runs
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(data[pos])
                    pos += 1
                    if count > 128:  # run
                        out[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        out[y, x:x + count, c] = data[pos:pos + count]
                        pos += count
                        x += count
        else:  # flat scanline
            row = data[pos:pos + w * 4].reshape(w, 4)
            out[y] = row
            pos += w * 4

    rgbe = out.astype(np.float32)
    exp = np.ldexp(1.0, out[..., 3].astype(np.int32) - 136)  # 2^(e-128-8)
    rgb = rgbe[..., :3] * exp[..., None]
    rgb[out[..., 3] == 0] = 0.0
    return rgb
