"""Write small OpenVDB (.vdb) files of float grids, for tests.

The repository holds no .vdb file, so the VDB parsers (the JAX package's
``utils/vdb.py`` and the port's copy) are fed files written here, in the
layout OpenVDB 3.x writes: the archive header and grid descriptors, then
per grid its compression flags, metadata, a ``UniformScaleMap`` transform
and a ``Tree_float_5_4_3`` tree (root, 32^3 and 16^3 internal nodes,
8^3 leaves) as topology followed by the leaf buffers, values through
``io::writeCompressedValues``.  Numpy, ``struct`` and ``zlib`` only: the
GPU machine's ``chip_smoke.py`` imports it too, where there is no JAX.

``write_vdb(path, [Grid(...), ...])`` writes one file; ``Grid`` carries a
dense [x, y, z] array placed at ``origin`` (index space).  Voxels with a
nonzero value are active; with ``inactive`` values, inactive voxels of a
leaf carry them (the active-mask compression then stores their metadata
and selection mask).  ``tiles`` adds active tiles: at the root (a 4096^3
box) or in an internal node (a 128^3 or 8^3 box), which replace the
voxels they cover.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

MAGIC = 0x56444220
COMPRESS_NONE, COMPRESS_ZIP, COMPRESS_ACTIVE_MASK, COMPRESS_BLOSC = 0, 1, 2, 4
# io::writeCompressedValues metadata codes
NO_MASK_OR_INACTIVE_VALS = 0
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

# log2 edge of each node level's children: upper 32^3 of 128^3 lower
# nodes, lower 16^3 of 8^3 leaves, leaves 8^3 voxels
_UPPER, _LOWER, _LEAF = 5, 4, 3
_LOWER_TOTAL, _UPPER_TOTAL = _LOWER + _LEAF, _UPPER + _LOWER + _LEAF


@dataclasses.dataclass
class Grid:
    """A float grid: ``data`` [x, y, z] at index-space ``origin``.

    ``tiles``: (level, index origin, value) active tiles, level 0 a root
    tile (4096^3), 1 an upper-node tile (128^3), 2 a lower-node tile
    (8^3); the origin is aligned to the tile's edge."""

    data: np.ndarray
    origin: tuple = (0, 0, 0)
    name: str = "density"
    grid_type: str = "Tree_float_5_4_3"
    bbox_metadata: bool = True
    inactive: tuple = ()
    tiles: tuple = ()
    voxel_size: float = 1.0


def _string(s: str) -> bytes:
    b = s.encode("ascii")
    return struct.pack("<I", len(b)) + b


def _metadata(items: list) -> bytes:
    out = struct.pack("<I", len(items))
    for name, type_name, raw in items:
        out += _string(name) + _string(type_name)
        out += struct.pack("<I", len(raw)) + raw
    return out


def _mask(bits: np.ndarray) -> bytes:
    return np.packbits(bits.astype(bool), bitorder="little").tobytes()


def _values(values: np.ndarray, mask: np.ndarray, compression: int,
            version: int, inactive: tuple) -> bytes:
    """io::writeCompressedValues of float32 ``values`` under value
    ``mask``.  ``inactive`` holds the values the inactive entries carry
    (none, one, or two: the second marked by the selection mask)."""
    out = b""
    off = ~mask
    masked = bool(compression & COMPRESS_ACTIVE_MASK) and version >= 222
    if not masked:
        meta = NO_MASK_AND_ALL_VALS
    elif len(inactive) == 0:
        meta = NO_MASK_OR_INACTIVE_VALS
    elif len(inactive) == 1:
        meta = NO_MASK_AND_ONE_INACTIVE_VAL
    else:
        meta = MASK_AND_TWO_INACTIVE_VALS
    if version >= 222:
        out += struct.pack("<b", meta)
        if masked and inactive:
            out += struct.pack(f"<{len(inactive)}f", *inactive)
        if meta == MASK_AND_TWO_INACTIVE_VALS:
            # every other inactive entry takes the second value
            out += _mask(off & (np.arange(values.size) % 2 == 1))
    stored = values[mask] if masked else values
    raw = stored.astype("<f4").tobytes()
    if compression & COMPRESS_ZIP:
        z = zlib.compress(raw)
        out += struct.pack("<q", len(z)) + z
    else:
        out += raw
    return out


def _inactive_row(inactive: tuple) -> np.ndarray:
    """The value each entry of a leaf carries while inactive: none (0),
    one value, or two alternating (the second on odd entries, as the
    selection mask of ``_values`` marks them)."""
    row = np.zeros(512, np.float32)
    if inactive:
        row[:] = inactive[0]
        row[1::2] = inactive[-1]
    return row


def _child_index(local, log2dim: int, child_total: int) -> int:
    x, y, z = (np.asarray(local) >> child_total).tolist()
    return (x << (2 * log2dim)) | (y << log2dim) | z


class _Tree:
    """The nodes of one grid, keyed by their index-space origins."""

    def __init__(self, grid: Grid):
        self.grid = grid
        data = np.asarray(grid.data, np.float32)
        idx = np.argwhere(data != 0)
        pos = np.asarray(grid.origin, np.int64) + idx
        leaf = (pos >> _LEAF) << _LEAF
        local = pos - leaf
        n = (local[:, 0] << 6) | (local[:, 1] << 3) | local[:, 2]
        keys, inv = np.unique(leaf, axis=0, return_inverse=True)
        masks = np.zeros((len(keys), 512), bool)
        values = np.tile(_inactive_row(grid.inactive), (len(keys), 1))
        masks[inv.reshape(-1), n] = True
        values[inv.reshape(-1), n] = data[tuple(idx.T)]
        # origin -> (mask (512,), values (512,))
        self.leaves = {tuple(k.tolist()): (m, v)
                       for k, m, v in zip(keys, masks, values)}
        self.tiles = {0: {}, 1: {}, 2: {}}
        for level, origin, value in grid.tiles:
            self.tiles[level][tuple(origin)] = float(value)

    def uppers(self) -> list:
        keys = set()
        for o in list(self.leaves) + list(self.tiles[1]) + list(self.tiles[2]):
            keys.add(tuple((np.asarray(o) >> _UPPER_TOTAL) << _UPPER_TOTAL))
        return sorted(keys)

    def _under(self, origin, total: int, items) -> list:
        o = np.asarray(origin)
        return [k for k in items
                if np.all((np.asarray(k) >> total) << total == o)]

    def internal(self, origin, log2dim: int, child_total: int,
                 compression: int, version: int, buffers: list) -> bytes:
        """InternalNode::writeTopology of the node at ``origin``; its
        leaves are appended to ``buffers`` in the reader's order."""
        n = 1 << (3 * log2dim)
        total = log2dim + child_total
        child = np.zeros(n, bool)
        value_mask = np.zeros(n, bool)
        tile_level = 1 if log2dim == _UPPER else 2
        tiles = {}
        for k in self._under(origin, total, self.tiles[tile_level]):
            i = _child_index(np.asarray(k) - origin, log2dim, child_total)
            tiles[i] = self.tiles[tile_level][k]
        children = {}
        kids = (self.leaves if child_total == _LEAF
                else list(self.leaves) + list(self.tiles[2]))
        for k in self._under(origin, total, kids):
            c = tuple((np.asarray(k) >> child_total) << child_total)
            i = _child_index(np.asarray(c) - origin, log2dim, child_total)
            if i not in tiles:
                children[i] = c
        child[list(children)] = True
        value_mask[list(tiles)] = True
        vals = np.zeros(n, np.float32)
        vals[list(tiles)] = list(tiles.values())
        out = _mask(child) + _mask(value_mask)
        out += _values(vals, value_mask, compression, version, ())
        for i in sorted(children):
            c = children[i]
            if child_total == _LEAF:
                mask, values = self.leaves[c]
                out += _mask(mask)
                buffers.append((mask, values))
            else:
                out += self.internal(c, _LOWER, _LEAF, compression, version,
                                     buffers)
        return out


def _grid_bytes(grid: Grid, compression: int, version: int) -> bytes:
    tree = _Tree(grid)
    meta = [("class", "string", b"fog volume"),
            ("is_saved_as_half_float", "bool", b"\x00"),
            ("name", "string", grid.name.encode())]
    if grid.bbox_metadata:
        lo = np.asarray(grid.origin, np.int32)
        hi = lo + np.asarray(grid.data.shape, np.int32) - 1
        meta += [("file_bbox_min", "vec3i", lo.astype("<i4").tobytes()),
                 ("file_bbox_max", "vec3i", hi.astype("<i4").tobytes())]
    meta.append(("file_voxel_count", "int64",
                 struct.pack("<q", int((grid.data != 0).sum()))))
    out = struct.pack("<I", compression) if version >= 222 else b""
    out += _metadata(meta)
    s = float(grid.voxel_size)
    out += _string("UniformScaleMap") + struct.pack(
        "<15d", s, s, s, s, s, s, 1 / s, 1 / s, 1 / s,
        1 / s ** 2, 1 / s ** 2, 1 / s ** 2, 0.5 / s, 0.5 / s, 0.5 / s)
    out += struct.pack("<I", 1)                    # buffer count
    roots = tree.tiles[0]
    uppers = [u for u in tree.uppers() if u not in roots]
    out += struct.pack("<fII", 0.0, len(roots), len(uppers))
    for origin, value in roots.items():
        out += struct.pack("<iiif?", *origin, value, True)
    buffers: list = []
    for origin in uppers:
        out += struct.pack("<iii", *origin)
        out += tree.internal(origin, _UPPER, _LOWER_TOTAL, compression,
                             version, buffers)
    for mask, values in buffers:
        out += _mask(mask)
        if version < 222:
            out += b"\x00" * 13                    # origin, buffer count
        out += _values(values, mask, compression, version, grid.inactive)
    return out


def write_vdb(path: str, grids: list, version: int = 223,
              compression: int = COMPRESS_ZIP | COMPRESS_ACTIVE_MASK) -> None:
    """Write ``grids`` (a list of Grid) to ``path``, every grid with the
    same compression flags."""
    bodies = [_grid_bytes(g, compression, version) for g in grids]
    head = struct.pack("<qIII?", MAGIC, version, 3, 0, True)
    head += b"0" * 36                              # uuid
    head += _metadata([("creator", "string", b"tests/torch_vdb_writer")])
    head += struct.pack("<I", len(grids))
    descs = [_string(g.name) + _string(g.grid_type) + _string("")
             for g in grids]
    pos = len(head) + sum(len(d) + 24 for d in descs)
    for d, body in zip(descs, bodies):
        head += d + struct.pack("<qqq", pos, pos, pos + len(body))
        pos += len(body)
    with open(path, "wb") as f:
        f.write(head + b"".join(bodies))
