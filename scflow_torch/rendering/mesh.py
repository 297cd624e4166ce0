"""Static-shape mesh banks (port of ``scflow_tpu/rendering/mesh.py:20-263``).

All class meshes are padded to a common (Vmax, Fmax) budget and stacked,
so a batch render is one gather by label followed by fixed-shape compute.
Banks come from procedural test meshes or from a directory of PLY/OBJ
files (:func:`load_mesh_dir`).
"""
from __future__ import annotations

import dataclasses
from glob import glob
from os import path as osp

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class MeshBank:
    """Stacked, padded per-class mesh tensors (C classes).

    verts (C, V, 3) f32; faces (C, F, 3) int64 (padding faces 0, 0, 0);
    face_valid (C, F) bool; vert_normals (C, V, 3); vert_colors (C, V, 3);
    diameters (C,); tri_pos (C, F, 3, 3) and tri_attr (C, F, 3, 9)
    (position | normal | albedo per face vertex) once ``with_tri_tables``
    has filled them.
    """
    verts: torch.Tensor
    faces: torch.Tensor
    face_valid: torch.Tensor
    vert_normals: torch.Tensor
    vert_colors: torch.Tensor
    diameters: torch.Tensor
    tri_pos: torch.Tensor | None = None
    tri_attr: torch.Tensor | None = None

    @property
    def num_classes(self) -> int:
        return self.verts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def to(self, device: str | torch.device) -> "MeshBank":
        """The bank with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})

    def gather(self, labels: torch.Tensor):
        """Per-sample mesh tensors for a batch of class labels (N,)."""
        return (self.verts[labels], self.faces[labels],
                self.face_valid[labels], self.vert_normals[labels],
                self.vert_colors[labels])

    def gather_tris(self, labels: torch.Tensor):
        """Per-sample face-vertex tables (N, F, 3, 3) and (N, F, 3, 9)."""
        bank = self.with_tri_tables()
        return bank.tri_pos[labels], bank.tri_attr[labels]

    def with_tri_tables(self) -> "MeshBank":
        """Bank with the per-class face-vertex tables filled in."""
        if self.tri_pos is not None:
            return self
        cls = torch.arange(self.num_classes, device=self.device)[:, None, None]

        def index(v):
            return v[cls, self.faces]                       # (C, F, 3, 3)

        tri_pos = index(self.verts)
        tri_attr = torch.cat([tri_pos, index(self.vert_normals),
                              index(self.vert_colors)], dim=-1)
        return dataclasses.replace(self, tri_pos=tri_pos, tri_attr=tri_attr)


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    vn = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def _diameter(verts: np.ndarray, sample: int = 1000) -> float:
    """Approximate mesh diameter: max pairwise distance over sampled verts
    (the same fixed numpy sample as the JAX package, for equal results)."""
    if len(verts) > sample:
        idx = np.random.default_rng(0).choice(len(verts), sample, replace=False)
        verts = verts[idx]
    d2 = np.sum((verts[:, None] - verts[None]) ** 2, axis=-1)
    return float(np.sqrt(d2.max()))


def build_mesh_bank(meshes: list[dict], pad_verts: int | None = None,
                    pad_faces: int | None = None,
                    device: str | torch.device = "cuda") -> MeshBank:
    """MeshBank from dicts with ``verts (V, 3)``, ``faces (F, 3)`` and
    optional ``vert_colors (V, 3)``, placed on ``device``."""
    dev = resolve_device(device)
    vmax = pad_verts or max(m["verts"].shape[0] for m in meshes)
    fmax = pad_faces or max(m["faces"].shape[0] for m in meshes)
    c = len(meshes)
    verts = np.zeros((c, vmax, 3), np.float32)
    faces = np.zeros((c, fmax, 3), np.int64)
    valid = np.zeros((c, fmax), bool)
    normals = np.zeros((c, vmax, 3), np.float32)
    colors = np.full((c, vmax, 3), 0.7, np.float32)
    diam = np.zeros((c,), np.float32)
    for i, m in enumerate(meshes):
        v = np.asarray(m["verts"], np.float32)
        f = np.asarray(m["faces"], np.int64)
        nv, nf = v.shape[0], f.shape[0]
        if nv > vmax or nf > fmax:
            raise ValueError(f"mesh {i} exceeds budget ({nv}>{vmax} or {nf}>{fmax})")
        verts[i, :nv] = v
        faces[i, :nf] = f
        valid[i, :nf] = True
        normals[i, :nv] = _vertex_normals(v, f)
        if m.get("vert_colors") is not None:
            colors[i, :nv] = np.asarray(m["vert_colors"], np.float32)
        diam[i] = _diameter(v)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return MeshBank(verts=t(verts), faces=t(faces), face_valid=t(valid),
                    vert_normals=t(normals), vert_colors=t(colors),
                    diameters=t(diam))


def load_mesh_file(path: str) -> dict:
    """One .ply/.obj mesh in the bank input format (verts, faces,
    vert_colors; UV textures baked to vertex colors)."""
    from . import meshio

    if path.lower().endswith(".ply"):
        return meshio.load_ply(path)
    if path.lower().endswith(".obj"):
        return meshio.load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_mesh_dir(mesh_dir: str, ext: str = "ply",
                  pad_verts: int | None = None,
                  pad_faces: int | None = None,
                  device: str | torch.device = "cuda") -> MeshBank:
    """Every ``*.{ext}`` mesh of a directory, sorted by name, as a MeshBank
    on ``device``; the reference's labels: ``obj_000001.ply`` → label 0
    (models/utils/rendering.py:141-147)."""
    dev = resolve_device(device)
    paths = sorted(glob(osp.join(mesh_dir, f"*.{ext}")))
    if not paths:
        raise FileNotFoundError(f"no *.{ext} meshes under {mesh_dir}")
    return build_mesh_bank([load_mesh_file(p) for p in paths],
                           pad_verts=pad_verts, pad_faces=pad_faces,
                           device=dev)


def icosphere(subdivisions: int = 2, radius: float = 1.0):
    """Procedural icosphere: (verts (V, 3) f32, faces (F, 3) i32) arrays."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        cache: dict = {}
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                cache[key] = len(verts)
                verts.append((np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0)
            return cache[key]

        new_faces = []
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = np.asarray(new_faces, np.int64)
        verts = np.asarray(verts)
    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True) * radius
    return verts.astype(np.float32), faces.astype(np.int32)


def box(extents=(1.0, 1.0, 1.0)):
    """Procedural axis-aligned box centered at the origin: (verts, faces)."""
    ex, ey, ez = [e / 2.0 for e in extents]
    verts = np.array([[sx * ex, sy * ey, sz * ez]
                      for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                     np.float32)
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return verts, faces


def make_test_meshes(num_classes: int = 2, subdivisions: int = 2,
                     radius: float = 60.0,
                     device: str | torch.device = "cuda") -> MeshBank:
    """Procedural meshes (icospheres for even labels, boxes for odd ones)
    with seeded vertex colors, as the JAX package builds them."""
    meshes = []
    for i in range(num_classes):
        if i % 2 == 0:
            v, f = icosphere(subdivisions=subdivisions,
                             radius=radius * (1 + 0.2 * i))
        else:
            v, f = box(extents=(radius * 1.5, radius, radius * 0.7))
        rng = np.random.default_rng(i)
        colors = rng.uniform(0.2, 1.0, size=(len(v), 3)).astype(np.float32)
        meshes.append({"verts": v, "faces": f, "vert_colors": colors})
    return build_mesh_bank(meshes, device=device)
