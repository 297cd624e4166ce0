"""Phong shading with point lights (port of
``scflow_tpu/rendering/shading.py``): pytorch3d's HardPhongShader
formula, two-sided normals, clamp to [0, 1] at the end; and the
SoftSilhouetteShader's alpha from the z-test winner."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PhongParams:
    """pytorch3d PointLights + Materials defaults. The colors are tuples,
    or (3,) tensors on the shade points' device (:meth:`on`)."""
    ambient_color: tuple = (0.5, 0.5, 0.5)
    diffuse_color: tuple = (0.3, 0.3, 0.3)
    specular_color: tuple = (0.2, 0.2, 0.2)
    shininess: float = 64.0

    def on(self, device: torch.device) -> "PhongParams":
        """These parameters with f32 color tensors on ``device``, made
        once, so shading copies nothing from the host."""
        return dataclasses.replace(self, **{
            name: torch.tensor(getattr(self, name), dtype=torch.float32,
                               device=device)
            for name in ("ambient_color", "diffuse_color", "specular_color")})


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def phong_color(points_obj: torch.Tensor, normals_obj: torch.Tensor,
                albedo: torch.Tensor, light_location_obj: torch.Tensor,
                camera_location_obj: torch.Tensor,
                params: PhongParams = PhongParams()) -> torch.Tensor:
    """Unclipped Phong color at (..., 3) shade points; light and camera
    locations broadcast against the leading shape."""
    def vec(c):
        return torch.as_tensor(c, dtype=albedo.dtype, device=albedo.device)

    n = _unit(normals_obj)
    l_dir = _unit(light_location_obj - points_obj)
    v_dir = _unit(camera_location_obj - points_obj)
    # two-sided: flip normals that face away from the viewer
    n = torch.where((n * v_dir).sum(-1, keepdim=True) < 0, -n, n)
    ndotl_raw = (n * l_dir).sum(-1, keepdim=True)
    diffuse = vec(params.diffuse_color) * ndotl_raw.clamp_min(0.0)
    r_dir = 2.0 * ndotl_raw * n - l_dir
    rdotv = (r_dir * v_dir).sum(-1).clamp_min(0.0)
    specular = vec(params.specular_color) * (rdotv ** params.shininess)[..., None]
    return albedo * (vec(params.ambient_color) + diffuse) + specular


def phong_shade(points_obj: torch.Tensor, normals_obj: torch.Tensor,
                albedo: torch.Tensor, mask: torch.Tensor,
                light_location_obj: torch.Tensor,
                camera_location_obj: torch.Tensor,
                params: PhongParams = PhongParams(),
                background_color=(0.5, 0.5, 0.5)) -> torch.Tensor:
    """Shade (..., H, W, 3) rasterized pixels; ``mask`` (..., H, W) selects
    the foreground, lights and camera are (..., 3); the background is a
    tuple or a (3,) tensor on the pixels' device. Returns RGB in [0, 1]."""
    color = phong_color(points_obj, normals_obj, albedo,
                        light_location_obj[..., None, None, :],
                        camera_location_obj[..., None, None, :], params)
    bg = torch.as_tensor(background_color, dtype=color.dtype,
                         device=color.device)
    return torch.where(mask[..., None], color, bg).clamp(0.0, 1.0)


def silhouette_alpha(face_id: torch.Tensor, tri_xy: torch.Tensor,
                     image_size: tuple, sigma: float = 1e-4,
                     soft: bool = True) -> torch.Tensor:
    """Silhouette coverage from rasterizer fragments (port of
    ``scflow_tpu/rendering/shading.py:92-137``): pytorch3d's
    SoftSilhouetteShader with one face per pixel and no blur, which is
    ``sigmoid(d² / sigma)`` on covered pixels and 0 elsewhere, d² the
    squared distance of the pixel centre (x + 0.5, y + 0.5) to the nearest
    edge of the z-test winner, in NDC units (2 / min(H, W) per pixel).

    face_id (N, H, W), -1 for background; tri_xy (N, F, 3, 2) per-face
    projected vertex pixel coordinates; ``soft=False`` returns the hard
    coverage as float. Returns (N, H, W) float32 alpha in [0, 1].
    """
    covered = face_id >= 0
    if not soft:
        return covered.to(torch.float32)
    h, w = image_size
    ys, xs = torch.meshgrid(
        torch.arange(h, device=face_id.device),
        torch.arange(w, device=face_id.device), indexing="ij")
    p = torch.stack([xs + 0.5, ys + 0.5], dim=-1).to(torch.float32)
    rows = torch.arange(face_id.shape[0], device=face_id.device)[:, None, None]
    tri = tri_xy[rows, face_id.clamp_min(0).long()]              # (N,H,W,3,2)

    d2_min = torch.full(face_id.shape, torch.inf, dtype=torch.float32,
                        device=face_id.device)
    for e in range(3):
        a, b = tri[..., e, :], tri[..., (e + 1) % 3, :]
        ab = b - a
        t = (((p - a) * ab).sum(-1)
             / (ab * ab).sum(-1).clamp_min(1e-12)).clamp(0.0, 1.0)
        proj = a + t[..., None] * ab
        d2_min = torch.minimum(d2_min, ((p - proj) ** 2).sum(-1))

    ndc_per_pix = 2.0 / min(h, w)
    alpha = torch.sigmoid(d2_min * (ndc_per_pix * ndc_per_pix) / sigma)
    return torch.where(covered, alpha, 0.0)
