"""The dense and tile-binned z-buffer rasterizers in plain PyTorch (port of
``scflow_tpu/rendering/rasterizer.py``), batched over a leading sample
axis.

These are the JAX package's XLA paths, not its Pallas kernel: they stay
plain PyTorch on the card too. The renderer's default is the tile kernel
(``ops/rasterize_fast``); ``Renderer(rasterizer="scan" | "binned")`` runs
these. Conventions, as in the JAX module:

- OpenCV camera: ``p_cam = R p_obj + t``, pixel = K p_cam / z, +z in front;
  pixel (x, y) is sampled at its integer coordinates.
- Screen-space (not perspective-correct) barycentric interpolation.
- zbuf is the winning face's interpolated camera z, 0 on background;
  face_id is -1 there.
- The z-test is an integer min over packed keys: the top bits of
  bitcast(max(z, 1e-30)) with the low ``id_bits`` replaced by the face id,
  ``0x7F7F0000`` where no face covers. The face ids of both packages agree
  exactly.
"""
from __future__ import annotations

import torch

from ..geometry.se3 import matvec3
from ..ops.rasterize_fast import winner_barycentrics

BIG_KEY = 0x7F7F0000          # bitcast key of a huge positive float
# elements of one (samples × faces × pixels) temporary, a bound on memory
_BLOCK = 1 << 24


def project_vertices(verts: torch.Tensor, rotation: torch.Tensor,
                     translation: torch.Tensor, k: torch.Tensor,
                     eps: float = 1e-8):
    """Object-frame verts (..., V, 3) → (pixel xy (..., V, 2), camera z
    (..., V)); rotation and k are (..., 3, 3), translation (..., 3). The
    products are the renderer's (``Renderer.rasterizer_inputs``), so a
    face's vertices project to the same bits in both."""
    p_cam = matvec3(rotation[..., None, :, :], verts) + translation[..., None, :]
    uvw = matvec3(k[..., None, :, :], p_cam)
    z = uvw[..., 2]
    return uvw[..., :2] / (z[..., None] + eps), z


def _gather_faces(v: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-face vertex rows: v (N, V, ...) at faces (N, F, 3) → (N, F, 3, ...)."""
    rows = torch.arange(v.shape[0], device=v.device)[:, None, None]
    return v[rows, faces.long()]


def _id_bits(fcount: int) -> int:
    bits = max(14, (fcount - 1).bit_length())
    if bits >= 24:
        raise ValueError(f"face budget {fcount} too large for packed keys")
    return bits


def _pack(z: torch.Tensor, ids: torch.Tensor, inside: torch.Tensor,
          id_bits: int) -> torch.Tensor:
    zkey = z.clamp_min(1e-30).view(torch.int32)
    key = ((zkey >> id_bits) << id_bits) | ids
    return torch.where(inside, key, BIG_KEY)


def rasterize(verts_xy: torch.Tensor, verts_z: torch.Tensor,
              faces: torch.Tensor, face_valid: torch.Tensor, height: int,
              width: int, chunk: int = 256) -> dict:
    """Dense z-buffer rasterization: every face against every pixel, in
    chunks of ``chunk`` faces (the JAX ``lax.scan`` steps).

    verts_xy (N, V, 2) pixel coordinates, verts_z (N, V) camera z, faces
    (N, F, 3) vertex ids, face_valid (N, F). Returns dict(zbuf (N, H, W),
    face_id (N, H, W) int32, bary (N, H, W, 3) screen-space barycentrics
    of the winner, 0 on background). The winner's z and barycentrics are
    recomputed from its vertices after the z-test.
    """
    n, f = face_valid.shape
    dev, dt = verts_xy.device, verts_xy.dtype
    pad = (-f) % chunk
    if pad:
        faces = torch.cat([faces, faces.new_zeros(n, pad, 3)], 1)
        face_valid = torch.cat([face_valid, face_valid.new_zeros(n, pad)], 1)
    id_bits = _id_bits(f + pad)
    tri_xy = _gather_faces(verts_xy, faces)                      # (N, F, 3, 2)
    tri_z = _gather_faces(verts_z, faces)                        # (N, F, 3)
    py, px = torch.meshgrid(torch.arange(height, dtype=dt, device=dev),
                            torch.arange(width, dtype=dt, device=dev),
                            indexing="ij")
    key_buf = torch.full((n, height, width), BIG_KEY, dtype=torch.int32,
                         device=dev)
    group = max(1, _BLOCK // (chunk * height * width))           # samples
    for s0 in range(0, n, group):
        ss = slice(s0, s0 + group)
        for c0 in range(0, f + pad, chunk):
            cs = slice(c0, c0 + chunk)
            xy = tri_xy[ss, cs][:, :, None, None]                # (G,C,1,1,3,2)
            ax, ay = xy[..., 0, 0], xy[..., 0, 1]
            bx, by = xy[..., 1, 0], xy[..., 1, 1]
            cx, cy = xy[..., 2, 0], xy[..., 2, 1]
            area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)

            def edge(x0, y0, x1, y1):
                return (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)

            inv_area = torch.where(area.abs() > 1e-12, 1.0 / area, 0.0)
            w0 = edge(bx, by, cx, cy) * inv_area                 # (G,C,H,W)
            w1 = edge(cx, cy, ax, ay) * inv_area
            w2 = edge(ax, ay, bx, by) * inv_area
            z = tri_z[ss, cs][:, :, None, None]
            zi = w0 * z[..., 0] + w1 * z[..., 1] + w2 * z[..., 2]
            ok = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                  & face_valid[ss, cs, None, None]
                  & (area.abs() > 1e-12)
                  & (z > 1e-6).all(dim=-1))
            ids = torch.arange(c0, c0 + chunk, dtype=torch.int32,
                               device=dev)[:, None, None]
            key = _pack(zi, ids, ok, id_bits).amin(dim=1)
            key_buf[ss] = torch.minimum(key_buf[ss], key)

    bg = key_buf >= BIG_KEY
    face_id = torch.where(bg, -1, key_buf & ((1 << id_bits) - 1))
    # the winner's barycentrics and z, exactly
    bary = winner_barycentrics(tri_xy, face_id)
    rows = torch.arange(n, device=dev)[:, None, None]
    zbuf = (bary * tri_z[rows, face_id.clamp_min(0).long()]).sum(-1)
    return {"zbuf": torch.where(bg, 0.0, zbuf), "face_id": face_id,
            "bary": bary}


def _first_overlapping(overlap: torch.Tensor, slots: int) -> torch.Tensor:
    """Indices (..., slots) of the first ``slots`` True entries of
    ``overlap`` (..., M) in order; -1 past the last one."""
    count = overlap.cumsum(dim=-1)
    want = torch.arange(1, slots + 1, device=overlap.device).expand(
        *overlap.shape[:-1], slots).contiguous()
    idx = torch.searchsorted(count, want)
    return torch.where(idx < overlap.shape[-1], idx, -1)


def rasterize_binned(verts_xy: torch.Tensor, verts_z: torch.Tensor,
                     faces: torch.Tensor, face_valid: torch.Tensor,
                     height: int, width: int, tile: int = 32,
                     k_faces: int = 256,
                     tri_attrs: torch.Tensor | None = None,
                     return_bary: bool = True) -> dict:
    """Tile-binned rasterization: each (tile × tile) pixel tile against
    only the first ``k_faces`` faces whose bounding box overlaps it (within
    half a pixel), faces beyond that budget dropped.

    With F and ``k_faces`` multiples of 8 the faces are selected by chunks
    of 8 (the first k/8 chunks holding an overlapping usable face, all
    their faces together), otherwise one by one: the JAX path's two
    branches (``lax.top_k`` keeps the lowest indices among ties). Inside a
    tile the edges are sign-fixed and unnormalised, z and attributes are
    premultiplied by 1/|area|, and the winner is the face of the least key.

    Same arguments as :func:`rasterize`; H and W multiples of ``tile``;
    ``tri_attrs`` (N, F, 3, D) optional per-face-vertex attributes.
    Returns dict(zbuf, face_id[, bary (zeros unless ``return_bary``)]
    [, attrs (N, H, W, D) with ``tri_attrs``]).
    """
    n, fcount = face_valid.shape
    if height % tile or width % tile:
        raise ValueError(f"frame {height}x{width} is not a multiple of {tile}")
    dev, dt = verts_xy.device, verts_xy.dtype
    tri_xy = _gather_faces(verts_xy, faces)                      # (N, F, 3, 2)
    tri_z = _gather_faces(verts_z, faces)                        # (N, F, 3)
    ax, ay = tri_xy[..., 0, 0], tri_xy[..., 0, 1]
    bx, by = tri_xy[..., 1, 0], tri_xy[..., 1, 1]
    cx, cy = tri_xy[..., 2, 0], tri_xy[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = face_valid & (area.abs() > 1e-12) & (tri_z > 1e-6).all(dim=-1)

    ty, tx = height // tile, width // tile
    t = ty * tx
    t_y0 = torch.arange(ty, device=dev).to(dt) * tile
    t_x0 = torch.arange(tx, device=dev).to(dt) * tile
    ymin, ymax = tri_xy[..., 1].amin(-1), tri_xy[..., 1].amax(-1)
    xmin, xmax = tri_xy[..., 0].amin(-1), tri_xy[..., 0].amax(-1)
    ovy = ((ymax[:, None, :] >= t_y0[:, None] - 0.5)
           & (ymin[:, None, :] <= t_y0[:, None] + tile - 0.5))   # (N, ty, F)
    ovx = ((xmax[:, None, :] >= t_x0[:, None] - 0.5)
           & (xmin[:, None, :] <= t_x0[:, None] + tile - 0.5))   # (N, tx, F)
    overlap = (ovy[:, :, None, :] & ovx[:, None, :, :]
               & ok[:, None, None, :]).reshape(n, t, fcount)

    k_faces = min(k_faces, fcount)
    chunk = 8
    if fcount % chunk == 0 and k_faces % chunk == 0:
        ov_chunks = overlap.reshape(n, t, fcount // chunk, chunk).any(-1)
        first = _first_overlapping(ov_chunks, k_faces // chunk)  # (N, T, K8)
        sel = (first[..., None] * chunk
               + torch.arange(chunk, device=dev)).reshape(n, t, k_faces)
        sel = torch.where(first.repeat_interleave(chunk, -1) >= 0, sel, -1)
    else:
        sel = _first_overlapping(overlap, k_faces)               # (N, T, K)
    filled = sel >= 0
    idx = sel.clamp_min(0)
    rows = torch.arange(n, device=dev)[:, None, None]
    sel_xy = tri_xy[rows, idx]                                   # (N,T,K,3,2)
    sel_z = tri_z[rows, idx]                                     # (N, T, K, 3)
    sel_valid = filled & ok[rows, idx]
    sel_area = area[rows, idx]
    d_attr = 0 if tri_attrs is None else tri_attrs.shape[-1]
    if d_attr:
        sel_attr = tri_attrs[rows, idx]                          # (N,T,K,3,D)

    # the per-face edge coefficients: w_k = a·px + (b·py + c), sign-fixed
    ax, ay = sel_xy[..., 0, 0], sel_xy[..., 0, 1]
    bx, by = sel_xy[..., 1, 0], sel_xy[..., 1, 1]
    cx, cy = sel_xy[..., 2, 0], sel_xy[..., 2, 1]
    s = torch.where(sel_area >= 0, 1.0, -1.0)
    inv_abs = torch.where(sel_area.abs() > 1e-12, 1.0 / sel_area.abs(), 0.0)
    coef = torch.stack([
        -(cy - by) * s, (cx - bx) * s, ((cy - by) * bx - (cx - bx) * by) * s,
        -(ay - cy) * s, (ax - cx) * s, ((ay - cy) * cx - (ax - cx) * cy) * s,
        -(by - ay) * s, (bx - ax) * s, ((by - ay) * ax - (bx - ax) * ay) * s,
    ], dim=-1).reshape(n * t, k_faces, 9)
    zt = (sel_z * inv_abs[..., None]).reshape(n * t, k_faces, 3)
    valid = sel_valid.reshape(n * t, k_faces)
    inv_abs = inv_abs.reshape(n * t, k_faces)
    fids = idx.reshape(n * t, k_faces).to(torch.int32)
    if d_attr:
        at = (sel_attr * inv_abs.reshape(n, t, k_faces)[..., None, None]
              ).reshape(n * t, k_faces, 3, d_attr)
    id_bits = _id_bits(fcount)

    p = tile * tile
    pix = torch.arange(p, device=dev)
    dxl, dyl = (pix % tile).to(dt), (pix // tile).to(dt)
    tile_id = torch.arange(t, device=dev).repeat(n)
    keys = torch.empty(n * t, p, dtype=torch.int32, device=dev)
    zbuf = torch.empty(n * t, p, dtype=dt, device=dev)
    bary = torch.zeros(n * t, p, 3, dtype=dt, device=dev)
    attrs = torch.empty(n * t, p, d_attr, dtype=dt, device=dev)
    step = max(1, _BLOCK // (p * k_faces))
    for r0 in range(0, n * t, step):
        sl = slice(r0, r0 + step)
        px = ((tile_id[sl] % tx) * tile).to(dt)[:, None, None] + dxl[:, None]
        py = ((tile_id[sl] // tx) * tile).to(dt)[:, None, None] + dyl[:, None]
        c = coef[sl][:, None]                                    # (B, 1, K, 9)
        w = [c[..., 3 * e] * px + (c[..., 3 * e + 1] * py + c[..., 3 * e + 2])
             for e in range(3)]                                  # (B, P, K)
        inside = ((w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0)
                  & valid[sl][:, None])
        z = zt[sl][:, None]
        zi = w[0] * z[..., 0] + w[1] * z[..., 1] + w[2] * z[..., 2]
        key = _pack(zi, fids[sl][:, None], inside, id_bits)
        # keys are unique within a tile: the face id is in the low bits
        win = key.argmin(dim=-1, keepdim=True)                   # (B, P, 1)
        keys[sl] = key.gather(-1, win)[..., 0]
        cover = inside.gather(-1, win)                           # (B, P, 1)
        zbuf[sl] = torch.where(cover, zi.gather(-1, win), 0.0)[..., 0]
        ws = [torch.where(cover, we.gather(-1, win), 0.0) for we in w]
        if return_bary:
            inv_w = inv_abs[sl][:, None].expand(-1, p, -1).gather(-1, win)
            bary[sl] = torch.cat([we * inv_w for we in ws], dim=-1)
        if d_attr:
            b_ix = torch.arange(win.shape[0], device=dev)[:, None]
            a = at[sl][b_ix, win[..., 0]]                        # (B, P, 3, D)
            attrs[sl] = (ws[0] * a[..., 0, :] + ws[1] * a[..., 1, :]
                         + ws[2] * a[..., 2, :])

    def image(v):              # (N·T, P, ...) tile-major → (N, H, W, ...)
        rest = v.shape[2:]
        v = v.reshape(n, ty, tx, tile, tile, *rest).transpose(2, 3)
        return v.reshape(n, height, width, *rest)

    keys = image(keys)
    bg = keys >= BIG_KEY
    out = {"zbuf": torch.where(bg, 0.0, image(zbuf)),
           "face_id": torch.where(bg, -1, keys & ((1 << id_bits) - 1)),
           "bary": torch.where(bg[..., None], 0.0, image(bary))}
    if d_attr:
        out["attrs"] = torch.where(bg[..., None], 0.0, image(attrs))
    return out


def interpolate_face_attributes(face_id: torch.Tensor, bary: torch.Tensor,
                                faces: torch.Tensor,
                                vert_attrs: torch.Tensor) -> torch.Tensor:
    """Per-vertex attributes at rasterized pixels: face_id (N, H, W), bary
    (N, H, W, 3), faces (N, F, 3), vert_attrs (N, V, D) → (N, H, W, D),
    0 on background."""
    rows = torch.arange(face_id.shape[0], device=face_id.device)[:, None, None]
    fv = faces[rows, face_id.clamp_min(0).long()]                # (N, H, W, 3)
    attrs = vert_attrs[rows[..., None], fv.long()]               # (N,H,W,3,D)
    out = (bary[..., None] * attrs).sum(-2)
    return torch.where((face_id < 0)[..., None], 0.0, out)
