"""Minimal PLY / OBJ mesh readers, numpy only (a copy of
``scflow_tpu/rendering/meshio.py``, whose arrays it returns bit for bit).

Covers the formats the reference consumes through pytorch3d/trimesh
(models/utils/rendering.py:64-68, BOP ``models*/obj_XXXXXX.ply`` and the
fork's LUMI ``.obj`` meshes): ascii + binary_little_endian PLY with optional
per-vertex color/normal/UV, and OBJ with optional material Kd colors /
texture maps. UV textures are baked to per-vertex colors so downstream
shapes stay static. Textures (PNG or JPEG) are read with the port's own
decoders (``data.imageio``), so a GPU host needs neither cv2 nor PIL; a
form they do not decode raises their ``ValueError``.
"""
from __future__ import annotations

import os
import re

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> dict:
    """Parse a PLY file → dict(verts, faces, vert_colors, vert_uv?).

    Supports ascii 1.0 and binary_little_endian 1.0, vertex properties in
    any order, uchar/float color, and int-list face properties.
    """
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ('list', idx_t, cnt_t, name)])
        cur = None
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = {"name": parts[1], "count": int(parts[2]), "props": []}
                elements.append(cur)
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    cur["props"].append(("list", parts[2], parts[3], parts[4]))
                else:
                    # (name, type)
                    cur["props"].append((parts[2], parts[1]))

        data = {}
        if fmt == "ascii":
            text = f.read().decode("ascii")
            tokens = text.split()
            pos = 0
            for el in elements:
                rows = []
                for _ in range(el["count"]):
                    row = {}
                    for p in el["props"]:
                        if p[0] == "list":
                            n = int(float(tokens[pos])); pos += 1
                            row[p[3]] = [float(tokens[pos + i]) for i in range(n)]
                            pos += n
                        else:
                            row[p[0]] = float(tokens[pos]); pos += 1
                    rows.append(row)
                data[el["name"]] = rows
        elif fmt == "binary_little_endian":
            for el in elements:
                has_list = any(p[0] == "list" for p in el["props"])
                if not has_list:
                    dt = np.dtype([(p[0], "<" + _PLY_DTYPES[p[1]])
                                   for p in el["props"]])
                    arr = np.frombuffer(f.read(dt.itemsize * el["count"]), dt)
                    data[el["name"]] = arr
                else:
                    rows = []
                    for _ in range(el["count"]):
                        row = {}
                        for p in el["props"]:
                            if p[0] == "list":
                                idx_dt = np.dtype("<" + _PLY_DTYPES[p[1]])
                                cnt_dt = np.dtype("<" + _PLY_DTYPES[p[2]])
                                n = int(np.frombuffer(f.read(idx_dt.itemsize),
                                                      idx_dt)[0])
                                vals = np.frombuffer(f.read(cnt_dt.itemsize * n),
                                                     cnt_dt)
                                row[p[3]] = vals.tolist()
                            else:
                                pdt = np.dtype("<" + _PLY_DTYPES[p[1]])
                                row[p[0]] = float(np.frombuffer(
                                    f.read(pdt.itemsize), pdt)[0])
                        rows.append(row)
                    data[el["name"]] = rows
        else:
            raise ValueError(f"unsupported PLY format {fmt!r} in {path}")

    # vertices
    vel = data.get("vertex")
    if vel is None:
        raise ValueError(f"no vertex element in {path}")

    def col(name, default=None):
        if isinstance(vel, np.ndarray):
            if name in vel.dtype.names:
                return np.asarray(vel[name], np.float32)
            return default
        if vel and name in vel[0]:
            return np.asarray([r[name] for r in vel], np.float32)
        return default

    verts = np.stack([col("x"), col("y"), col("z")], axis=-1)
    colors = None
    r = col("red")
    if r is not None:
        colors = np.stack([r, col("green"), col("blue")], axis=-1)
        if colors.max() > 1.0 + 1e-6:
            colors = colors / 255.0
    uv = None
    u = col("texture_u")
    if u is None:
        u = col("s")
    if u is not None:
        v = col("texture_v")
        if v is None:
            v = col("t")
        uv = np.stack([u, v], axis=-1)

    # faces (triangulate fans)
    faces = []
    fel = data.get("face", [])
    key = None
    for row in fel:
        if key is None:
            key = ("vertex_indices" if "vertex_indices" in row
                   else "vertex_index")
        idx = row[key]
        for i in range(1, len(idx) - 1):
            faces.append([idx[0], idx[i], idx[i + 1]])
    faces = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)

    out = {"verts": verts.astype(np.float32), "faces": faces,
           "vert_colors": colors}
    if uv is not None:
        out["vert_uv"] = uv
        tex = _find_ply_texture(path)
        if tex is not None:
            out["vert_colors"] = _sample_texture(tex, uv)
    return out


def _find_ply_texture(path: str):
    """The same-name png/jpg texture of a PLY, if there is one."""
    base = os.path.splitext(path)[0]
    for ext in (".png", ".jpg", ".jpeg"):
        cand = base + ext
        if os.path.exists(cand):
            return _read_image(cand)
    return None


def _read_image(path: str):
    from ..data.imageio import imread

    return imread(path).astype(np.float32) / 255.0


def _sample_texture(tex: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Nearest-sample a texture image at (V, 2) UVs (v up, BOP convention)."""
    h, w = tex.shape[:2]
    x = np.clip((uv[:, 0] * (w - 1)).round().astype(int), 0, w - 1)
    y = np.clip(((1.0 - uv[:, 1]) * (h - 1)).round().astype(int), 0, h - 1)
    return tex[y, x]


def load_obj(path: str) -> dict:
    """Parse an OBJ file → dict(verts, faces, vert_colors).

    Supports v/vt/f lines (f with v, v/vt, v/vt/vn, v//vn forms), and bakes
    mtl map_Kd textures or Kd colors into per-vertex colors when present.
    """
    verts, uvs, faces, face_uvs = [], [], [], []
    mtl_path = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path), parts[1])
            elif parts[0] == "f":
                idx = []
                tidx = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    idx.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        tidx.append(int(comps[1]) - 1)
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
                    if len(tidx) == len(idx):
                        face_uvs.append([tidx[0], tidx[i], tidx[i + 1]])

    verts = np.asarray(verts, np.float32)
    faces_np = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
    colors = None

    tex, kd = _load_mtl(mtl_path) if mtl_path else (None, None)
    if tex is not None and face_uvs and uvs:
        uvs = np.asarray(uvs, np.float32)
        colors = np.full((len(verts), 3), 0.7, np.float32)
        fuv = np.asarray(face_uvs, np.int32)
        vert_uv = np.zeros((len(verts), 2), np.float32)
        vert_uv[faces_np.ravel()] = uvs[fuv.ravel()]
        colors = _sample_texture(tex, vert_uv)
    elif kd is not None:
        colors = np.tile(np.asarray(kd, np.float32), (len(verts), 1))
    return {"verts": verts, "faces": faces_np, "vert_colors": colors}


def _load_mtl(mtl_path: str):
    """Return (texture image or None, Kd color or None) from a .mtl file."""
    if not os.path.exists(mtl_path):
        return None, None
    tex, kd = None, None
    with open(mtl_path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "map_Kd":
                cand = os.path.join(os.path.dirname(mtl_path), parts[-1])
                if os.path.exists(cand):
                    tex = _read_image(cand)
            elif parts[0] == "Kd" and len(parts) >= 4:
                kd = [float(parts[1]), float(parts[2]), float(parts[3])]
    return tex, kd
