"""Minimal pure-Python OpenVDB (.vdb) reader for float fog volumes.

Port of ``nrc_hpm_tpu/utils/vdb.py``, a copy of its numpy parser so the
port imports nothing of the JAX package.  The reference copies the active
voxels of the first FloatGrid into a dense array bounded by the
``file_bbox_min``/``file_bbox_max`` metadata; this module does the same
for ``Tree_float_5_4_3`` grids directly from the file format:

  header / grid descriptors  -> openvdb::io::Archive
  per-grid compression flags -> io::readGridCompression (file version >= 222)
  topology + buffers         -> RootNode/InternalNode/LeafNode::readTopology/
                                readBuffers with io::readCompressedValues
                                (COMPRESS_NONE / COMPRESS_ZIP /
                                 COMPRESS_ACTIVE_MASK, optional half floats)

Supported: file versions 220..224 (blosc-compressed files are rejected),
single- or multi-grid files, root tiles, internal-node active tiles, leaf
buffers.  ``load_vdb`` reads through the native decoder
(``utils/native.py``, the port's copy of the JAX package's
``native/nrcio.cpp``) first, as the JAX package does where its library
is built, and parses here what the decoder refuses.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import BinaryIO, Optional

import numpy as np

OPENVDB_MAGIC = 0x56444220  # " BDV" little-endian

# Compression flags (openvdb/io/Compression.h)
COMPRESS_NONE = 0
COMPRESS_ZIP = 0x1
COMPRESS_ACTIVE_MASK = 0x2
COMPRESS_BLOSC = 0x4

# readCompressedValues metadata codes (openvdb/io/Compression.h)
NO_MASK_OR_INACTIVE_VALS = 0
NO_MASK_AND_MINUS_BG = 1
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_NO_INACTIVE_VALS = 3
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

# Known transform map types -> number of serialized doubles.
_MAP_DOUBLES = {
    "UniformScaleMap": 15,      # scale, voxelSize, invScale, invScaleSqr, inv2x
    "ScaleMap": 15,
    "UniformScaleTranslateMap": 18,  # + translation
    "ScaleTranslateMap": 18,
    "TranslationMap": 3,
    "UnitaryMap": 16,           # affine 4x4
    "AffineMap": 16,
}


@dataclasses.dataclass
class GridDescriptor:
    name: str
    grid_type: str
    instance_parent: str
    grid_pos: int
    block_pos: int
    end_pos: int


@dataclasses.dataclass
class VdbGrid:
    """A dense view of a VDB float grid."""

    name: str
    metadata: dict
    # Index-space inclusive bounding box of the dense array.
    bbox_min: np.ndarray  # (3,) int32
    bbox_max: np.ndarray  # (3,) int32
    # Dense voxel data indexed [x, y, z] relative to bbox_min.
    data: np.ndarray  # float32
    voxel_size: float = 1.0


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<I", f.read(4))
    return f.read(n).decode("ascii", errors="replace")


def _read_metadata(f: BinaryIO) -> dict:
    (count,) = struct.unpack("<I", f.read(4))
    meta = {}
    for _ in range(count):
        name = _read_string(f)
        type_name = _read_string(f)
        (nbytes,) = struct.unpack("<I", f.read(4))
        raw = f.read(nbytes)
        if type_name == "string":
            meta[name] = raw.decode("ascii", errors="replace")
        elif type_name == "vec3i":
            meta[name] = np.frombuffer(raw, dtype="<i4").copy()
        elif type_name == "vec3d":
            meta[name] = np.frombuffer(raw, dtype="<f8").copy()
        elif type_name == "int64":
            meta[name] = struct.unpack("<q", raw)[0]
        elif type_name == "int32":
            meta[name] = struct.unpack("<i", raw)[0]
        elif type_name == "bool":
            meta[name] = bool(raw[0])
        elif type_name == "float":
            meta[name] = struct.unpack("<f", raw)[0]
        elif type_name == "double":
            meta[name] = struct.unpack("<d", raw)[0]
        else:
            meta[name] = raw
        # value size was explicit, so unknown types are safely skipped
    return meta


def _load_mask(f: BinaryIO, log2dim: int) -> np.ndarray:
    """NodeMask<Log2Dim>::load — raw little-endian word array; bit i of the
    flat mask corresponds to local offset i = x<<2L | y<<L | z."""
    nbits = 1 << (3 * log2dim)
    raw = np.frombuffer(f.read(nbits // 8), dtype=np.uint8)
    # openvdb stores Word=uint64 little-endian; unpacking uint8 LSB-first
    # yields the same global bit order.
    return np.unpackbits(raw, bitorder="little").astype(bool)


class _GridReader:
    """Reads one Tree_float_5_4_3 grid starting at its stream position."""

    # Node layout for Tree_float_5_4_3 (root -> internal5 -> internal4 -> leaf3)
    L_UPPER, L_LOWER, L_LEAF = 5, 4, 3
    # total log2 edge length covered by each node type
    TOT_LEAF = 3           # leaf: 8^3 voxels
    TOT_LOWER = 4 + 3      # internal4: 128^3
    TOT_UPPER = 5 + 4 + 3  # internal5: 4096^3

    def __init__(self, f: BinaryIO, file_version: int):
        self.f = f
        self.version = file_version
        self.compression = COMPRESS_NONE
        self.half = False
        # (origin(3,), leaf_mask(512,), values(512,)) tuples
        self.leaves: list = []
        # (origin(3,), edge_len, value) filled boxes from active tiles
        self.tiles: list = []

    # -- value decompression ------------------------------------------------
    def _read_values(self, count: int) -> np.ndarray:
        dt = np.float16 if self.half else np.float32
        if self.compression & COMPRESS_BLOSC:
            raise NotImplementedError("blosc-compressed VDB not supported")
        if self.compression & COMPRESS_ZIP:
            (nbytes,) = struct.unpack("<q", self.f.read(8))
            if nbytes <= 0:
                # negative size => uncompressed fallback of -nbytes bytes
                raw = self.f.read(-nbytes)
            else:
                raw = zlib.decompress(self.f.read(nbytes))
            vals = np.frombuffer(raw, dtype=dt)[:count]
        else:
            vals = np.frombuffer(
                self.f.read(count * np.dtype(dt).itemsize), dtype=dt)
        return vals.astype(np.float32)

    def _read_compressed_values(
            self, count: int, value_mask: np.ndarray) -> np.ndarray:
        """io::readCompressedValues for float values."""
        meta = NO_MASK_AND_ALL_VALS
        if self.version >= 222:
            (meta,) = struct.unpack("<b", self.f.read(1))
        inactive0 = inactive1 = 0.0
        if meta in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL,
                    MASK_AND_TWO_INACTIVE_VALS):
            (inactive0,) = struct.unpack("<f", self.f.read(4))
            if meta == MASK_AND_TWO_INACTIVE_VALS:
                (inactive1,) = struct.unpack("<f", self.f.read(4))
        selection = None
        if meta in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL,
                    MASK_AND_TWO_INACTIVE_VALS):
            nbytes = count // 8
            raw = np.frombuffer(self.f.read(nbytes), dtype=np.uint8)
            selection = np.unpackbits(raw, bitorder="little").astype(bool)

        mask_compressed = bool(self.compression & COMPRESS_ACTIVE_MASK) \
            and meta != NO_MASK_AND_ALL_VALS and self.version >= 222
        if mask_compressed:
            n_stored = int(value_mask.sum())
        else:
            n_stored = count
        stored = self._read_values(n_stored)

        out = np.zeros(count, dtype=np.float32)
        if mask_compressed:
            out[value_mask] = stored
            if inactive0 != 0.0 or inactive1 != 0.0:
                off = ~value_mask
                if selection is not None:
                    out[off & ~selection] = inactive0
                    out[off & selection] = inactive1
                else:
                    out[off] = inactive0
        else:
            out[:count] = stored[:count]
        return out

    # -- topology -----------------------------------------------------------
    def read_grid(self, grid_pos: int, want_buffers: bool = True):
        f = self.f
        f.seek(grid_pos)
        if self.version >= 222:
            (self.compression,) = struct.unpack("<I", f.read(4))
        self.grid_meta = _read_metadata(f)
        self.half = bool(self.grid_meta.get("is_saved_as_half_float", False))
        self.voxel_size = self._read_transform()
        self._read_topology()
        if want_buffers:
            self._read_buffers()

    def _read_transform(self) -> float:
        map_type = _read_string(self.f)
        if map_type not in _MAP_DOUBLES:
            raise NotImplementedError(f"unsupported VDB map type {map_type!r}")
        doubles = np.frombuffer(
            self.f.read(8 * _MAP_DOUBLES[map_type]), dtype="<f8")
        if "Scale" in map_type:
            return float(doubles[3])  # mVoxelSize.x
        return 1.0

    def _read_topology(self):
        f = self.f
        (buffer_count,) = struct.unpack("<I", f.read(4))  # TreeBase: always 1
        if buffer_count != 1:
            raise NotImplementedError("multi-buffer trees not supported")
        # RootNode::readTopology
        (self.background,) = struct.unpack("<f", f.read(4))
        (num_tiles,) = struct.unpack("<I", f.read(4))
        (num_children,) = struct.unpack("<I", f.read(4))
        for _ in range(num_tiles):
            x, y, z, value = struct.unpack("<iiif", f.read(16))
            (active,) = struct.unpack("<?", f.read(1))
            if active:
                self.tiles.append((np.array([x, y, z], np.int64),
                                   1 << self.TOT_UPPER, value))
        self._upper_nodes = []
        for _ in range(num_children):
            origin = np.array(struct.unpack("<iii", f.read(12)), np.int64)
            self._read_internal_topology(origin, self.L_UPPER, self.TOT_LOWER)

    def _read_internal_topology(self, origin, log2dim, child_tot_log2):
        f = self.f
        child_mask = _load_mask(f, log2dim)
        value_mask = _load_mask(f, log2dim)
        n_values = 1 << (3 * log2dim)
        values = self._read_compressed_values(n_values, value_mask)
        child_dim = 1 << child_tot_log2

        # Record active tiles (value on, no child) as filled boxes.
        tile_bits = np.flatnonzero(value_mask & ~child_mask)
        dim_mask = (1 << log2dim) - 1
        for n in tile_bits:
            v = float(values[n])
            ox = (n >> (2 * log2dim)) & dim_mask
            oy = (n >> log2dim) & dim_mask
            oz = n & dim_mask
            torigin = origin + np.array([ox, oy, oz], np.int64) * child_dim
            self.tiles.append((torigin, child_dim, v))

        # Recurse into children in increasing bit order.
        for n in np.flatnonzero(child_mask):
            ox = (n >> (2 * log2dim)) & dim_mask
            oy = (n >> log2dim) & dim_mask
            oz = n & dim_mask
            corigin = origin + np.array([ox, oy, oz], np.int64) * child_dim
            if child_tot_log2 == self.TOT_LEAF:
                leaf_mask = _load_mask(f, self.L_LEAF)
                self.leaves.append([corigin, leaf_mask, None])
            else:
                self._read_internal_topology(
                    corigin, self.L_LOWER, self.TOT_LEAF)

    def _read_buffers(self):
        # Buffer pass revisits leaves in the same depth-first order.
        for leaf in self.leaves:
            mask = _load_mask(self.f, self.L_LEAF)
            if self.version < 222:
                self.f.read(12)  # origin
                self.f.read(1)   # numBuffers
            values = self._read_compressed_values(512, mask)
            leaf[1] = mask
            leaf[2] = values

    # -- dense assembly -----------------------------------------------------
    def to_dense(self, bbox_min: np.ndarray, bbox_max: np.ndarray
                 ) -> np.ndarray:
        """Dense [x, y, z] array of ACTIVE values over the inclusive bbox,
        exactly like the reference's cbeginValueOn loop
        (src/Texture3D.cpp:59-73): inactive voxels stay 0."""
        extent = (bbox_max - bbox_min + 1).astype(np.int64)
        dense = np.zeros(tuple(extent), dtype=np.float32)

        for origin, edge, value in self.tiles:
            lo = np.maximum(origin - bbox_min, 0)
            hi = np.minimum(origin + edge - bbox_min, extent)
            if np.any(hi <= lo):
                continue
            dense[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = value

        for origin, mask, values in self.leaves:
            if values is None:
                continue
            lo = origin - bbox_min
            hi = lo + 8
            if np.any(hi <= 0) or np.any(lo >= extent):
                continue
            block = np.where(mask, values, 0.0).reshape(8, 8, 8)
            # clip to bbox
            slo = np.maximum(lo, 0)
            shi = np.minimum(hi, extent)
            dense[slo[0]:shi[0], slo[1]:shi[1], slo[2]:shi[2]] = \
                block[slo[0] - lo[0]:shi[0] - lo[0],
                      slo[1] - lo[1]:shi[1] - lo[1],
                      slo[2] - lo[2]:shi[2] - lo[2]]
        return dense


def _read_header(f: BinaryIO):
    (magic,) = struct.unpack("<q", f.read(8))
    if magic != OPENVDB_MAGIC:
        raise ValueError("not an OpenVDB file")
    (version,) = struct.unpack("<I", f.read(4))
    if not (220 <= version <= 224):
        raise NotImplementedError(f"unsupported VDB file version {version}")
    struct.unpack("<II", f.read(8))  # library major/minor
    (has_offsets,) = struct.unpack("<?", f.read(1))
    if not has_offsets:
        raise NotImplementedError("VDB files without grid offsets unsupported")
    f.read(36)  # uuid string
    if version >= 224:
        # file-level compression flag exists from the blosc era onward
        (compression,) = struct.unpack("<I", f.read(4))
        if compression & COMPRESS_BLOSC:
            raise NotImplementedError("blosc-compressed VDB not supported")
    file_meta = _read_metadata(f)
    (grid_count,) = struct.unpack("<I", f.read(4))
    descriptors = []
    for _ in range(grid_count):
        name = _read_string(f)
        grid_type = _read_string(f)
        instance_parent = _read_string(f) if version >= 214 else ""
        grid_pos, block_pos, end_pos = struct.unpack("<qqq", f.read(24))
        descriptors.append(GridDescriptor(
            name, grid_type, instance_parent, grid_pos, block_pos, end_pos))
    return version, file_meta, descriptors


def load_vdb(path: str, grid_name: Optional[str] = None,
             prefer_native: bool = True) -> VdbGrid:
    """Load the first float grid (or the named grid) from ``path`` as a dense
    array over its ``file_bbox`` metadata (or, without it, over the union
    of its leaf and tile boxes), matching the reference's
    vk::Texture3D::FromVDB.

    With ``prefer_native`` and no ``grid_name`` the native decoder reads
    the first ``Tree_float_5_4_3`` grid (the same data bitwise; as in the
    JAX package, its grid is named "density" and carries no metadata),
    unless ``NRC_HPM_NATIVE=0``; a file it refuses (blosc, another tree
    type, no bbox metadata, not a VDB) is parsed here.  A decoder that
    fails to build raises."""
    if prefer_native and grid_name is None:
        from . import native
        if native.enabled():
            try:
                arr, bbox_min, voxel = native.vdb_load_native(path)
            except ValueError:
                pass  # parsed below
            else:
                bbox_max = bbox_min + np.array(arr.shape, np.int32) - 1
                return VdbGrid(name="density", metadata={},
                               bbox_min=bbox_min, bbox_max=bbox_max,
                               data=arr, voxel_size=voxel)
    with open(path, "rb") as f:
        version, _file_meta, descriptors = _read_header(f)
        chosen = None
        for gd in descriptors:
            if not gd.grid_type.startswith("Tree_float"):
                continue
            if grid_name is None or gd.name == grid_name:
                chosen = gd
                break
        if chosen is None:
            raise ValueError(f"no float grid found in {path}")
        if chosen.grid_type != "Tree_float_5_4_3":
            raise NotImplementedError(
                f"unsupported tree type {chosen.grid_type}")
        reader = _GridReader(f, version)
        reader.read_grid(chosen.grid_pos)

    meta = reader.grid_meta
    if "file_bbox_min" in meta:
        bbox_min = meta["file_bbox_min"].astype(np.int64)
        bbox_max = meta["file_bbox_max"].astype(np.int64)
    else:
        # fall back to the union of leaf/tile boxes
        los = [o for o, *_ in reader.tiles] + [o for o, _, _ in reader.leaves]
        his = ([o + e - 1 for o, e, _ in reader.tiles]
               + [o + 7 for o, _, _ in reader.leaves])
        bbox_min = np.min(np.stack(los), axis=0)
        bbox_max = np.max(np.stack(his), axis=0)

    dense = reader.to_dense(bbox_min, bbox_max)
    return VdbGrid(
        name=chosen.name, metadata=meta,
        bbox_min=bbox_min.astype(np.int32), bbox_max=bbox_max.astype(np.int32),
        data=dense, voxel_size=reader.voxel_size)
