"""Per-class point banks for the pose losses (port of
``scflow_tpu/training/points_bank.py``): one (C, P, 3) tensor of sampled
mesh vertices with validity masks, gathered by label."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..rendering.mesh import MeshBank


@dataclasses.dataclass
class PointsBank:
    points: torch.Tensor        # (C, P, 3)
    valid: torch.Tensor         # (C, P) bool
    diameters: torch.Tensor     # (C,)
    symmetric: torch.Tensor     # (C,) bool

    def gather(self, labels: torch.Tensor):
        """(points (N, P, 3), valid (N, P), symmetric (N,), diameters (N,))."""
        return (self.points[labels], self.valid[labels],
                self.symmetric[labels], self.diameters[labels])

    def to(self, device: str | torch.device) -> "PointsBank":
        return PointsBank(*(t.to(device) for t in dataclasses.astuple(self)))


def build_points_bank(mesh_bank: MeshBank, symmetric_classes=(),
                      num_points: int = 512, diameters=None,
                      seed: int = 0) -> PointsBank:
    """Sample ``num_points`` used vertices per class with numpy's
    ``default_rng(seed)``, the JAX package's draws, so one seed gives the
    same points bit for bit. On the mesh bank's device."""
    c = mesh_bank.num_classes
    verts = mesh_bank.verts.cpu().numpy()
    face_valid = mesh_bank.face_valid.cpu().numpy()
    faces = mesh_bank.faces.cpu().numpy()
    pts = np.zeros((c, num_points, 3), np.float32)
    valid = np.zeros((c, num_points), bool)
    rng = np.random.default_rng(seed)
    for i in range(c):
        used = np.unique(faces[i][face_valid[i]].ravel())
        if len(used) == 0:
            continue
        take = min(num_points, len(used))
        sel = rng.choice(used, size=take, replace=len(used) < take)
        pts[i, :take] = verts[i][sel]
        valid[i, :take] = True
    sym = np.zeros((c,), bool)
    for s in symmetric_classes:
        sym[s] = True
    diam = (np.asarray(diameters, np.float32) if diameters is not None
            else mesh_bank.diameters.cpu().numpy())
    dev = mesh_bank.device
    return PointsBank(points=torch.from_numpy(pts).to(dev),
                      valid=torch.from_numpy(valid).to(dev),
                      diameters=torch.from_numpy(diam).to(dev),
                      symmetric=torch.from_numpy(sym).to(dev))
