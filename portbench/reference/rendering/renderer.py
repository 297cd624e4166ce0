"""Plain batched renderer: per-class mesh tables gathered by label,
projection, backface culling, the plain tile pass and Phong shading with a
point light up the viewing axis (OpenCV cameras, mask = a face covers the
pixel). The face-vertex tables are worked out here from the meshes'
vertices, faces, normals and colors."""
from __future__ import annotations

import dataclasses

import torch

from ..geometry.se3 import matvec3
from ..ops.tile_pass import rasterize
from .shading import PhongParams, phong_shade


@dataclasses.dataclass
class MeshTables:
    """verts (C, V, 3), faces (C, F, 3) int64, face-vertex tables tri_pos
    (C, F, 3, 3) and tri_attr (C, F, 3, 9) = position | normal | color."""
    verts: torch.Tensor
    faces: torch.Tensor
    tri_pos: torch.Tensor
    tri_attr: torch.Tensor

    @classmethod
    def build(cls, verts, faces, normals, colors) -> "MeshTables":
        faces = faces.long()
        c = torch.arange(verts.shape[0], device=verts.device)[:, None, None]
        tri_pos = verts[c, faces]
        tri_attr = torch.cat([tri_pos, normals[c, faces], colors[c, faces]],
                             dim=-1)
        return cls(verts, faces, tri_pos, tri_attr)


def render(mesh: MeshTables, rotations, translations, k, labels,
           image_size, background=(0.5, 0.5, 0.5), light_offset=400.0):
    """dict(images (N, H, W, 3) in [0, 1], depth (N, H, W), mask (N, H, W)
    bool) at poses (N, 3, 3) / (N, 3), intrinsics (N, 3, 3), labels (N,)."""
    h, w = image_size
    dev = rotations.device
    verts = mesh.verts[labels]
    tri_pos, tri_attr = mesh.tri_pos[labels], mesh.tri_attr[labels]
    tri_cam = (matvec3(rotations[:, None, None], tri_pos)
               + translations[:, None, None, :])
    uvw = matvec3(k[:, None, None], tri_cam)
    tri_z = uvw[..., 2]
    tri_xy = uvw[..., :2] / (tri_z[..., None] + 1e-8)
    # back faces of closed outward-wound meshes never win the z-test
    fn = torch.linalg.cross(tri_cam[:, :, 1] - tri_cam[:, :, 0],
                            tri_cam[:, :, 2] - tri_cam[:, :, 0], dim=-1)
    fvalid = (fn * tri_cam.mean(dim=2)).sum(-1) < 0.0
    cam_obj = -matvec3(rotations.transpose(1, 2), translations)
    zmin = ((verts * rotations[:, None, 2, :]).sum(-1)
            + translations[:, None, 2]).amin(dim=1)
    loc = (zmin - light_offset).clamp_min(0.0)
    light_obj = rotations[:, :, 2] * loc[:, None]
    frag = rasterize(tri_xy, tri_z, fvalid, h, w, tri_attr)
    mask = frag["face_id"] >= 0
    interp = frag["attrs"]
    images = phong_shade(
        interp[..., 0:3], interp[..., 3:6], interp[..., 6:9], mask,
        light_obj, cam_obj, params=PhongParams().on(dev),
        background_color=torch.tensor(background, dtype=torch.float32,
                                      device=dev))
    return {"images": images, "depth": frag["zbuf"], "mask": mask}
