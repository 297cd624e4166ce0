"""Batched mesh renderer (port of ``scflow_tpu/rendering/renderer.py``).

Renders a batch of (pose, intrinsics, class label) tuples into RGB, depth
and mask, and optionally a silhouette: one gather of face-vertex tables
from the MeshBank, projection, backface culling, a rasterizer (the tile
kernel ``ops/rasterize_fast`` by default; the dense scan or the
tile-binned pass of ``rendering/rasterizer``) and Phong/Gouraud/flat
shading. OpenCV-convention cameras, point lights in the object frame,
mask = depth > 0.
"""
from __future__ import annotations

import dataclasses

import torch

from ..geometry.se3 import matvec3
from ..ops.rasterize_fast import rasterize_fast
from .mesh import MeshBank
from .rasterizer import project_vertices, rasterize, rasterize_binned
from .shading import PhongParams, phong_color, phong_shade, silhouette_alpha

RASTERIZERS = ("auto", "pallas", "binned", "scan")
SHADERS = ("phong", "gouraud", "flat")


@dataclasses.dataclass
class Renderer:
    """Stateless batched renderer over a MeshBank, with the JAX
    ``Renderer``'s options, names and defaults.

    ``rasterizer``: 'pallas' is the tile path, K1's CUDA kernel on the card
    and its plain version on the CPU (H and W multiples of 32); 'auto' is
    the tile path on both (the JAX package's 'auto' takes 'binned' on the
    CPU); 'binned' and 'scan' are the plain PyTorch passes of
    ``rendering/rasterizer`` (``face_chunk`` faces per scan step).
    ``cull_backfaces``: drop faces turned away from the camera before the
    z-test (exact for closed outward-wound meshes). ``shader_type`` is
    'phong' (per pixel), 'gouraud' (colors at face vertices, interpolated)
    or 'flat' (one color per face). ``render_image=False`` leaves out
    ``images`` and rasterizes no attributes (K1's no-attribute form);
    ``render_mask`` adds a float ``masks`` silhouette, hard, or with
    ``soft_blending`` the sigmoid alpha of ``sigma``.
    """
    mesh_bank: MeshBank
    image_size: tuple[int, int]
    background_color: tuple = (0.5, 0.5, 0.5)
    shading: PhongParams = dataclasses.field(default_factory=PhongParams)
    separate_lights: bool = True
    light_offset: float = 400.0
    face_chunk: int = 256
    rasterizer: str = "auto"
    cull_backfaces: bool = True
    shader_type: str = "phong"
    render_image: bool = True
    render_mask: bool = False
    soft_blending: bool = False
    sigma: float = 1e-4

    def __post_init__(self):
        if self.rasterizer not in RASTERIZERS:
            raise ValueError(f"unknown rasterizer {self.rasterizer!r}")
        if self.shader_type not in SHADERS:
            raise ValueError(f"unknown shader_type {self.shader_type!r}")
        self.mesh_bank = self.mesh_bank.with_tri_tables()
        # constants on the bank's device, made once: a render copies
        # nothing from the host, so it never waits for the device
        dev = self.mesh_bank.device
        self._shading = self.shading.on(dev)
        self._background = torch.tensor(self.background_color,
                                        dtype=torch.float32, device=dev)
        self._up_light = torch.tensor([0.0, 1.0, 0.0], device=dev)

    def __call__(self, rotations: torch.Tensor, translations: torch.Tensor,
                 k: torch.Tensor, labels: torch.Tensor,
                 mesh_bank: MeshBank | None = None) -> dict:
        """rotations (N, 3, 3) object→camera, translations (N, 3), k
        (N, 3, 3) intrinsics, labels (N,) class ids, on the bank's device;
        ``mesh_bank`` overrides the renderer's bank for this call.

        Returns dict(images (N, H, W, 3) in [0, 1] unless
        ``render_image=False``, depth (N, H, W), mask (N, H, W) bool
        [, masks (N, H, W) float silhouette with ``render_mask``])."""
        h, w = self.image_size
        inp = self.rasterizer_inputs(rotations, translations, k, labels,
                                     mesh_bank)
        attr_table = inp["tri_attrs"]
        if self.rasterizer in ("auto", "pallas"):
            frag = rasterize_fast(inp["tri_xy"], inp["tri_z"],
                                  inp["face_valid"], h, w,
                                  tri_attrs=attr_table, return_bary=False)
        else:
            xy, z = project_vertices(inp["verts"], rotations, translations, k)
            if self.rasterizer == "binned":
                frag = rasterize_binned(xy, z, inp["faces"], inp["face_valid"],
                                        h, w, tri_attrs=attr_table,
                                        return_bary=False)
            else:
                frag = rasterize(xy, z, inp["faces"], inp["face_valid"], h, w,
                                 chunk=self.face_chunk)
        mask = frag["face_id"] >= 0
        out = {"depth": frag["zbuf"], "mask": mask}
        if self.render_image:
            if "attrs" in frag:
                interp = frag["attrs"]
            else:
                rows = torch.arange(mask.shape[0], device=mask.device)
                tri = attr_table[rows[:, None, None],
                                 frag["face_id"].clamp_min(0).long()]
                interp = (frag["bary"][..., None] * tri).sum(-2)
                interp = torch.where(mask[..., None], interp, 0.0)
            if self.shader_type == "phong":
                out["images"] = phong_shade(
                    interp[..., 0:3], interp[..., 3:6], interp[..., 6:9],
                    mask, inp["light_obj"], inp["cam_obj"],
                    params=self._shading, background_color=self._background)
            else:
                out["images"] = torch.where(mask[..., None], interp,
                                            self._background).clamp(0.0, 1.0)
        if self.render_mask:
            out["masks"] = silhouette_alpha(frag["face_id"], inp["tri_xy"],
                                            (h, w), sigma=self.sigma,
                                            soft=self.soft_blending)
        return out

    def rasterizer_inputs(self, rotations: torch.Tensor,
                          translations: torch.Tensor, k: torch.Tensor,
                          labels: torch.Tensor,
                          mesh_bank: MeshBank | None = None) -> dict:
        """Projected faces and shading inputs of a batch: tri_xy
        (N, F, 3, 2), tri_z (N, F, 3), face_valid (N, F) after backface
        culling (with ``cull_backfaces``), tri_attrs (N, F, 3, D) (None
        with ``render_image=False``), the object-frame light_obj/cam_obj
        (N, 3), and the meshes' verts (N, V, 3) and faces (N, F, 3)."""
        bank = (self.mesh_bank if mesh_bank is None
                else mesh_bank.with_tri_tables())
        verts, faces, fvalid, _, _ = bank.gather(labels)        # (N, V|F, …)
        tri_pos, tri_attr = bank.gather_tris(labels)            # (N, F, 3, ·)

        rot = rotations[:, None, None]                          # (N,1,1,3,3)
        tri_cam = matvec3(rot, tri_pos) + translations[:, None, None, :]
        uvw = matvec3(k[:, None, None], tri_cam)
        tri_z = uvw[..., 2]
        tri_xy = uvw[..., :2] / (tri_z[..., None] + 1e-8)
        if self.cull_backfaces:
            # back faces of closed outward-wound meshes never win the z-test
            fn = torch.linalg.cross(tri_cam[:, :, 1] - tri_cam[:, :, 0],
                                    tri_cam[:, :, 2] - tri_cam[:, :, 0],
                                    dim=-1)
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

        if not self.render_image:
            attr_table = None
        elif self.shader_type == "phong":
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
                "light_obj": light_obj, "cam_obj": cam_obj,
                "verts": verts, "faces": faces}
