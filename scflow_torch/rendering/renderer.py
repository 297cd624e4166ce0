"""Batched mesh renderer (port of ``scflow_tpu/rendering/renderer.py``).

Renders a batch of (pose, intrinsics, class label) tuples into RGB, depth
and mask: one gather of face-vertex tables from the MeshBank, projection,
backface culling, the tile rasterizer (``ops/rasterize_fast``) and
Phong/Gouraud/flat shading. OpenCV-convention cameras, point lights in the
object frame, mask = depth > 0.
"""
from __future__ import annotations

import dataclasses

import torch

from ..geometry.se3 import matvec3
from ..ops.rasterize_fast import rasterize_fast
from .mesh import MeshBank
from .shading import PhongParams, phong_color, phong_shade


@dataclasses.dataclass
class Renderer:
    """Stateless batched renderer over a MeshBank.

    Same options as the JAX ``Renderer`` except the rasterizer choice: the
    port has one rasterizer, the tile path, which needs H and W to be
    multiples of 32. ``shader_type`` is 'phong' (per pixel), 'gouraud'
    (colors at face vertices, interpolated) or 'flat' (one color per face).
    """
    mesh_bank: MeshBank
    image_size: tuple[int, int]
    background_color: tuple = (0.5, 0.5, 0.5)
    shading: PhongParams = dataclasses.field(default_factory=PhongParams)
    separate_lights: bool = True
    light_offset: float = 400.0
    shader_type: str = "phong"

    def __post_init__(self):
        self.mesh_bank = self.mesh_bank.with_tri_tables()
        # constants on the bank's device, made once: a render copies
        # nothing from the host, so it never waits for the device
        dev = self.mesh_bank.device
        self._shading = self.shading.on(dev)
        self._background = torch.tensor(self.background_color,
                                        dtype=torch.float32, device=dev)
        self._up_light = torch.tensor([0.0, 1.0, 0.0], device=dev)

    def __call__(self, rotations: torch.Tensor, translations: torch.Tensor,
                 k: torch.Tensor, labels: torch.Tensor) -> dict:
        """rotations (N, 3, 3) object→camera, translations (N, 3), k
        (N, 3, 3) intrinsics, labels (N,) class ids, on the bank's device.

        Returns dict(images (N, H, W, 3) in [0, 1], depth (N, H, W), mask
        (N, H, W) bool)."""
        h, w = self.image_size
        inp = self.rasterizer_inputs(rotations, translations, k, labels)
        frag = rasterize_fast(inp["tri_xy"], inp["tri_z"], inp["face_valid"],
                              h, w, tri_attrs=inp["tri_attrs"])
        mask = frag["face_id"] >= 0
        interp = frag["attrs"]
        if self.shader_type == "phong":
            images = phong_shade(
                interp[..., 0:3], interp[..., 3:6], interp[..., 6:9], mask,
                inp["light_obj"], inp["cam_obj"], params=self._shading,
                background_color=self._background)
        else:
            images = torch.where(mask[..., None], interp,
                                 self._background).clamp(0.0, 1.0)
        return {"images": images, "depth": frag["zbuf"], "mask": mask}

    def rasterizer_inputs(self, rotations: torch.Tensor,
                          translations: torch.Tensor, k: torch.Tensor,
                          labels: torch.Tensor) -> dict:
        """Projected faces and shading inputs of a batch: tri_xy
        (N, F, 3, 2), tri_z (N, F, 3), face_valid (N, F) after backface
        culling, tri_attrs (N, F, 3, D), and the object-frame
        light_obj/cam_obj (N, 3)."""
        verts, _, fvalid, _, _ = self.mesh_bank.gather(labels)  # (N, V|F, …)
        tri_pos, tri_attr = self.mesh_bank.gather_tris(labels)  # (N, F, 3, ·)

        rot = rotations[:, None, None]                          # (N,1,1,3,3)
        tri_cam = matvec3(rot, tri_pos) + translations[:, None, None, :]
        uvw = matvec3(k[:, None, None], tri_cam)
        tri_z = uvw[..., 2]
        tri_xy = uvw[..., :2] / (tri_z[..., None] + 1e-8)
        # back faces of closed outward-wound meshes never win the z-test
        fn = torch.linalg.cross(tri_cam[:, :, 1] - tri_cam[:, :, 0],
                                tri_cam[:, :, 2] - tri_cam[:, :, 0], dim=-1)
        centroid = tri_cam.mean(dim=2)
        fvalid = fvalid & ((fn * centroid).sum(-1) < 0.0)

        # camera center in the object frame: -Rᵀ t
        cam_obj = -matvec3(rotations.transpose(1, 2), translations)
        if self.separate_lights:
            # light up the viewing axis at the object's nearest depth minus
            # the offset, expressed in the mesh frame
            zmin = ((verts * rotations[:, None, 2, :]).sum(-1)
                    + translations[:, None, 2]).amin(dim=1)
            loc = (zmin - self.light_offset).clamp_min(0.0)
            light_obj = rotations[:, :, 2] * loc[:, None]
        else:
            light_obj = self._up_light.expand(verts.shape[0], 3)

        if self.shader_type == "phong":
            attr_table = tri_attr
        elif self.shader_type == "gouraud":
            attr_table = phong_color(
                tri_attr[..., 0:3], tri_attr[..., 3:6], tri_attr[..., 6:9],
                light_obj[:, None, None], cam_obj[:, None, None],
                params=self._shading)
        elif self.shader_type == "flat":
            fn_obj = torch.linalg.cross(tri_pos[:, :, 1] - tri_pos[:, :, 0],
                                        tri_pos[:, :, 2] - tri_pos[:, :, 0],
                                        dim=-1)
            face_color = phong_color(
                tri_pos.mean(dim=2), fn_obj, tri_attr[..., 6:9].mean(dim=2),
                light_obj[:, None], cam_obj[:, None], params=self._shading)
            attr_table = face_color[:, :, None, :].expand(-1, -1, 3, -1)
        else:
            raise ValueError(f"unknown shader_type {self.shader_type!r}")

        return {"tri_xy": tri_xy, "tri_z": tri_z, "face_valid": fvalid,
                "tri_attrs": attr_table,
                "light_obj": light_obj, "cam_obj": cam_obj}
