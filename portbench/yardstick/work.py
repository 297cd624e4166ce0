"""The work the hand-written kernels' bounds are made of, whatever runs
them, and the step's FLOPs counted on the plain reference.

K1 (the tile pass): 22 operations per (pixel, listed face) pair of the
tiles' filled slots, this data's face selection; each face's 14 used
coefficients and 3·d_attr attribute floats read once, face ids, z and
attributes written once. K2 (instance norm): 8 operations an element
forward (sum, centred square, normalise, affine) and 16 backward; x read
and y written once forward, x and g read and dx written once backward
with the scale read and the two parameter gradients written."""
from __future__ import annotations

import torch

from ..reference.ops import tile_pass
from ..reference.rendering.renderer import MeshTables

K1_OPS_PER_PAIR = 22
K1_COEFF_USED = 14
K2_OPS_PER_ELEM, K2_BWD_OPS_PER_ELEM = 8, 16
RENDER_ATTRS = 9         # position | normal | color per face vertex


def tile_pass_work(coeff, bbox, height: int, width: int, d_attr: int,
                   k_faces: int) -> tuple[int, int]:
    """(operations, bytes) of one tile pass over (N, F, 16) coefficients
    and (N, F, 4) boxes."""
    n, f = coeff.shape[:2]
    sel = tile_pass._select_tiles(bbox.unbind(-1), coeff[..., 14] > 0,
                                  height, width, k_faces)
    pairs = int((sel >= 0).sum()) * tile_pass.TILE * tile_pass.TILE
    moved = (n * f * (K1_COEFF_USED + 3 * d_attr) * 4
             + n * height * width * (2 + d_attr) * 4)
    return pairs * K1_OPS_PER_PAIR, moved


def render_work(tables: MeshTables, batch: dict, image_size) -> tuple:
    """(operations, bytes) of the tile pass that renders ``batch`` at its
    reference pose, from the same projection the plain renderer makes."""
    from ..reference.geometry.se3 import matvec3

    h, w = image_size
    labels = batch["labels"].long()
    r, t, k = batch["ref_rotations"], batch["ref_translations"], batch["k"]
    tri_cam = (matvec3(r[:, None, None], tables.tri_pos[labels])
               + t[:, None, None, :])
    uvw = matvec3(k[:, None, None], tri_cam)
    tri_z = uvw[..., 2]
    tri_xy = uvw[..., :2] / (tri_z[..., None] + 1e-8)
    fn = torch.linalg.cross(tri_cam[:, :, 1] - tri_cam[:, :, 0],
                            tri_cam[:, :, 2] - tri_cam[:, :, 0], dim=-1)
    fvalid = (fn * tri_cam.mean(dim=2)).sum(-1) < 0.0
    coeff, bbox, _, d_attr, kf = tile_pass.tile_inputs(
        tri_xy, tri_z, fvalid, h, w, tables.tri_attr[labels])
    return tile_pass_work(coeff, bbox, h, w, d_attr, kf)


def norm_work(shape, element_size: int, backward: bool) -> tuple[int, int]:
    """(operations, bytes) of one instance-norm launch on an NCHW plane
    stack of ``shape``."""
    numel = 1
    for s in shape:
        numel *= s
    if backward:
        return (numel * K2_BWD_OPS_PER_ELEM,
                3 * numel * element_size + 3 * shape[1] * 4)
    return numel * K2_OPS_PER_ELEM, 2 * numel * element_size


def bound_seconds(work: tuple[int, int], peak: dict) -> float:
    """The least time of (operations, bytes) at f32 without TF32 and HBM
    peaks: the larger of the two."""
    ops, moved = work
    return max(ops / peak["float32"], moved / peak["bytes"])
