"""Triangle-mesh scene assets: Model / Mesh / Material.

Port of ``nrc_hpm_tpu/models/mesh.py``: PNT vertices (position, normal,
uv), meshes with a per-mesh material (a diffuse colour and an optional
texture), a model as a list of meshes with a model-to-world transform.
``load_obj`` reads the common OBJ subset with its MTL ``Kd``/``map_Kd``;
``flatten_model`` turns a model into the flat triangle tensors of
``models/raster.py`` on ``device``.  Assets stay numpy until then.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Material:
    """Diffuse material: colour and an optional (H, W, 3) float32
    texture."""

    diffuse_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    diffuse_texture: Optional[np.ndarray] = None


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh with PNT vertices."""

    positions: np.ndarray  # (V, 3)
    normals: np.ndarray    # (V, 3)
    uvs: np.ndarray        # (V, 2)
    indices: np.ndarray    # (F, 3) int32
    material: Material = dataclasses.field(default_factory=Material)


@dataclasses.dataclass
class Model:
    """A list of meshes and a model-to-world transform."""

    meshes: List[Mesh]
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))

    def transformed(self, m: np.ndarray) -> "Model":
        return Model(self.meshes, (np.asarray(m, np.float32) @
                                   self.transform))


def load_obj(path: str) -> Model:
    """OBJ (+ MTL diffuse ``Kd`` and ``map_Kd``): v/vt/vn, faces as v,
    v/vt, v//vn or v/vt/vn, usemtl/mtllib; polygons fan-triangulated; one
    mesh per material, its vertices deduplicated by (v, vt, vn)."""
    positions, uvs, normals = [], [], []
    mats: Dict[str, Material] = {}
    soup: Dict[str, list] = {}   # per-material triangle soup
    cur_name = ""

    def parse_mtl(mtl_path):
        if not os.path.exists(mtl_path):
            return
        name = None
        for line in open(mtl_path):
            t = line.split()
            if not t:
                continue
            if t[0] == "newmtl":
                name = t[1]
                mats[name] = Material()
            elif t[0] == "Kd" and name:
                mats[name].diffuse_color = np.asarray(
                    [float(x) for x in t[1:4]], np.float32)
            elif t[0] == "map_Kd" and name:
                tex_path = os.path.join(os.path.dirname(mtl_path), t[-1])
                try:
                    from ..utils.texture import load_image
                    mats[name].diffuse_texture = load_image(tex_path)
                except (FileNotFoundError, ValueError) as e:
                    print(f"warning: could not load texture {tex_path}: {e}")

    for line in open(path):
        t = line.split()
        if not t:
            continue
        if t[0] == "v":
            positions.append([float(x) for x in t[1:4]])
        elif t[0] == "vt":
            uvs.append([float(t[1]), float(t[2])])
        elif t[0] == "vn":
            normals.append([float(x) for x in t[1:4]])
        elif t[0] == "mtllib":
            parse_mtl(os.path.join(os.path.dirname(path), t[1]))
        elif t[0] == "usemtl":
            cur_name = t[1]
        elif t[0] == "f":
            corners = []
            for tok in t[1:]:
                parts = tok.split("/")
                vi = int(parts[0])
                ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                corners.append((vi, ti, ni))
            for i in range(1, len(corners) - 1):  # fan triangulation
                soup.setdefault(cur_name, []).append(
                    (corners[0], corners[i], corners[i + 1]))

    meshes = []
    for mat_name, tris in soup.items():
        vmap: Dict[tuple, int] = {}
        P, N, U, F = [], [], [], []
        for tri in tris:
            face = []
            for key in tri:
                vi, ti, ni = key
                if key not in vmap:
                    vmap[key] = len(P)
                    P.append(positions[vi - 1])
                    U.append(uvs[ti - 1] if ti else [0.0, 0.0])
                    N.append(normals[ni - 1] if ni else [0.0, 0.0, 1.0])
                face.append(vmap[key])
            F.append(face)
        meshes.append(Mesh(
            positions=np.asarray(P, np.float32),
            normals=np.asarray(N, np.float32),
            uvs=np.asarray(U, np.float32),
            indices=np.asarray(F, np.int32),
            material=mats.get(mat_name, Material())))
    return Model(meshes)


def make_cube(size: float = 1.0) -> Model:
    """An axis-aligned cube of side ``size``: 6 quads, 12 triangles, uvs
    spanning each face."""
    s = size / 2.0
    corners = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                        for z in (-s, s)], np.float32)
    quads = [  # (corner indices, normal)
        ((0, 1, 3, 2), (-1, 0, 0)), ((4, 6, 7, 5), (1, 0, 0)),
        ((0, 4, 5, 1), (0, -1, 0)), ((2, 3, 7, 6), (0, 1, 0)),
        ((0, 2, 6, 4), (0, 0, -1)), ((1, 5, 7, 3), (0, 0, 1)),
    ]
    P, N, U, F = [], [], [], []
    for quad, n in quads:
        base = len(P)
        for k, c in enumerate(quad):
            P.append(corners[c])
            N.append(n)
            U.append([(k in (1, 2)) * 1.0, (k in (2, 3)) * 1.0])
        F.append([base, base + 1, base + 2])
        F.append([base, base + 2, base + 3])
    mesh = Mesh(np.asarray(P, np.float32), np.asarray(N, np.float32),
                np.asarray(U, np.float32), np.asarray(F, np.int32))
    return Model([mesh])


def flatten_model(model: Model, textures: Optional[list] = None,
                  device="cuda"):
    """Model -> the renderer's flat triangle tensors on ``device``: (v0,
    e1, e2 (F, 3), per-corner normals (F, 3, 3), uv (F, 3, 2), colour
    (F, 3), tex_idx (F,) int32 into ``textures`` or -1 for untextured).
    Positions go through the transform, normals through the inverse
    transpose of its rotation.  Pass a shared ``textures`` list to gather
    the texture images of several models (deduplicated by identity)."""
    v0s, e1s, e2s, ns, uvs_, cols, tids = [], [], [], [], [], [], []
    m4 = model.transform
    rot = m4[:3, :3]
    for mesh in model.meshes:
        P = (mesh.positions @ rot.T) + m4[:3, 3]
        Nrm = mesh.normals @ np.linalg.inv(rot).T
        idx = mesh.indices
        tri = P[idx]                       # (F, 3, 3)
        v0s.append(tri[:, 0])
        e1s.append(tri[:, 1] - tri[:, 0])
        e2s.append(tri[:, 2] - tri[:, 0])
        ns.append(Nrm[idx])
        uvs_.append(mesh.uvs[idx])
        cols.append(np.broadcast_to(mesh.material.diffuse_color,
                                    (len(idx), 3)))
        tid = -1
        tex = mesh.material.diffuse_texture
        if tex is not None and textures is not None:
            for k, existing in enumerate(textures):
                if existing is tex:
                    tid = k
                    break
            else:
                tid = len(textures)
                textures.append(tex)
        tids.append(np.full((len(idx),), tid, np.int32))
    return tuple(torch.as_tensor(np.concatenate(a), device=device) for a in
                 (v0s, e1s, e2s, ns, uvs_, cols, tids))
