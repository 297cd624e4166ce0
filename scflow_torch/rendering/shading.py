"""Phong shading with point lights (port of
``scflow_tpu/rendering/shading.py:21-89``): pytorch3d's HardPhongShader
formula, two-sided normals, clamp to [0, 1] at the end."""
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
