"""Tile-binned triangle rasterizer: a torch pre-pass and one CUDA kernel.

Port of ``scflow_tpu/ops/rasterize_fast.py``. A torch pre-pass builds each
face's edge/depth coefficients and bounding box (:func:`_coeff_table`) and
its attribute rows. The tile pass (:func:`rasterize_tiles`) then picks,
per 32×32 pixel tile, the first ``K`` faces of the 8-face chunks whose
bounding boxes overlap the tile (:func:`_select_tiles`), runs for every
pixel and selected face the edge functions, the inside test, the
interpolated z and a packed (z | face id) key whose minimum is the z-test,
and writes the winner's face id, z and attributes in image layout. Without
attributes (``tri_attrs=None``: depth or mask renders) it writes face ids
and z alone, as the TPU kernel's ``d_attr=0`` form does.

On a CUDA tensor the tile pass is the hand-written kernel in
``csrc/rasterize.cu``, selection and decode included; on a CPU tensor it
is :func:`rasterize_tiles_reference`: :func:`_select_tiles`, a literal
translation of the TPU kernel's dense (pixels × faces) formulation, and
the decode.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TILE = 32            # pixel tile edge (tile = TILE×TILE pixels)
CHUNK = 8            # face-selection granularity
K_FACES = 256        # per-tile face budget (the kernel's shared-memory cap)
ID_BITS = 14
BIG_KEY = 0x7F7F0000
ATTR_PAD = 16        # per-vertex attribute channels padded to this


def _coeff_table(tri_xy: torch.Tensor, tri_z: torch.Tensor,
                 face_valid: torch.Tensor):
    """Per-face channel table (..., F, 16):
    [a0,b0,c0, a1,b1,c1, a2,b2,c2, zt0,zt1,zt2, inv|area|, fid, valid, pad]
    where edge k is w_k(px, py) = a·px + b·py + c with the area sign folded
    in (inside ⇔ all w ≥ 0) and zt are vertex z premultiplied by 1/|area|.
    Also returns the face bounding boxes and the usable-face mask."""
    f = tri_xy.shape[-3]
    ax, ay = tri_xy[..., 0, 0], tri_xy[..., 0, 1]
    bx, by = tri_xy[..., 1, 0], tri_xy[..., 1, 1]
    cx, cy = tri_xy[..., 2, 0], tri_xy[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    big = area.abs() > 1e-12
    ok = face_valid & big & (tri_z > 1e-6).all(dim=-1)
    s = torch.where(area >= 0, 1.0, -1.0)
    inv_abs = torch.where(big, 1.0 / area.abs(), 0.0)
    a0, b0 = -(cy - by) * s, (cx - bx) * s
    c0 = ((cy - by) * bx - (cx - bx) * by) * s
    a1, b1 = -(ay - cy) * s, (ax - cx) * s
    c1 = ((ay - cy) * cx - (ax - cx) * cy) * s
    a2, b2 = -(by - ay) * s, (bx - ax) * s
    c2 = ((by - ay) * ax - (bx - ax) * ay) * s
    zt = tri_z * inv_abs[..., None]
    fid = torch.arange(f, dtype=tri_xy.dtype, device=tri_xy.device)
    cols = [a0, b0, c0, a1, b1, c1, a2, b2, c2,
            zt[..., 0], zt[..., 1], zt[..., 2], inv_abs,
            fid.expand_as(a0), ok.to(tri_xy.dtype), torch.zeros_like(a0)]
    bbox = (torch.minimum(torch.minimum(ax, bx), cx),
            torch.maximum(torch.maximum(ax, bx), cx),
            torch.minimum(torch.minimum(ay, by), cy),
            torch.maximum(torch.maximum(ay, by), cy))
    return torch.stack(cols, dim=-1), bbox, ok


def _select_tiles(bbox, ok: torch.Tensor, height: int, width: int,
                  k_faces: int) -> torch.Tensor:
    """Chunk-granular face selection per tile: (N, T, K) int32 face ids.

    Slot ``s`` of a tile holds face ``8·c + s % 8`` where ``c`` is the
    ``s // 8``-th chunk (in face order) with a face whose bounding box
    overlaps the tile; slots past the overlapping chunks are -1. These are
    the first K overlapping chunks, in order, as the TPU path selects them.
    """
    xmin, xmax, ymin, ymax = bbox                                # (N, F)
    n, f = ok.shape
    dev = ok.device
    ty, tx = height // TILE, width // TILE
    t_y0 = torch.arange(ty, device=dev, dtype=torch.float32) * TILE
    t_x0 = torch.arange(tx, device=dev, dtype=torch.float32) * TILE
    ovy = ((ymax[:, None, :] >= t_y0[:, None] - 0.5)
           & (ymin[:, None, :] <= t_y0[:, None] + TILE - 0.5))   # (N, ty, F)
    ovx = ((xmax[:, None, :] >= t_x0[:, None] - 0.5)
           & (xmin[:, None, :] <= t_x0[:, None] + TILE - 0.5))   # (N, tx, F)
    overlap = ovy[:, :, None, :] & ovx[:, None, :, :] & ok[:, None, None, :]
    chunks = f // CHUNK
    ov_chunks = overlap.reshape(n, ty * tx, chunks, CHUNK).any(dim=-1)
    count = ov_chunks.cumsum(dim=-1)                             # (N, T, C)
    k8 = k_faces // CHUNK
    want = torch.arange(1, k8 + 1, device=dev).expand(n, ty * tx, k8)
    chunk = torch.searchsorted(count, want.contiguous())         # (N, T, K8)
    face = chunk[..., None] * CHUNK + torch.arange(CHUNK, device=dev)
    sel = torch.where((chunk < chunks)[..., None], face, -1)
    return sel.reshape(n, ty * tx, k8 * CHUNK).to(torch.int32)


def _check_inputs(coeff, bbox, attr, height, width, d_attr, k_faces):
    """Raise unless the tile pass's inputs have the shapes, types and
    layout that :func:`rasterize_tiles` takes (``attr`` None with
    ``d_attr`` 0: no attributes)."""
    if coeff.dim() != 3:
        raise ValueError(f"coeff must be (N, F, 16), got {tuple(coeff.shape)}")
    n, f = coeff.shape[:2]
    if height % TILE or width % TILE or height <= 0 or width <= 0:
        raise ValueError(f"frame {height}x{width} is not a multiple of {TILE}")
    if not 0 < k_faces <= K_FACES or k_faces % CHUNK:
        raise ValueError(f"face budget {k_faces} not a multiple of {CHUNK} in "
                         f"(0, {K_FACES}]")
    if not 0 < f < (1 << ID_BITS) or f % CHUNK:
        raise ValueError(f"{f} faces: not a multiple of {CHUNK} below "
                         f"2^{ID_BITS} (the packed id)")
    if attr is None:
        if d_attr != 0:
            raise ValueError(f"d_attr {d_attr} without an attribute table")
    elif not 0 < d_attr <= ATTR_PAD:
        raise ValueError(f"d_attr {d_attr} outside (0, {ATTR_PAD}]")
    tables = ((coeff, 16), (bbox, 4), (attr, 3 * ATTR_PAD))
    for x, width_ in tables[:2] if attr is None else tables:
        if (x.device != coeff.device or x.dtype != torch.float32
                or tuple(x.shape) != (n, f, width_) or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"expected contiguous 16-byte aligned float32 "
                             f"{(n, f, width_)} on {coeff.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def rasterize_tiles_reference(coeff: torch.Tensor, bbox: torch.Tensor,
                              attr: torch.Tensor | None, height: int,
                              width: int, d_attr: int,
                              k_faces: int = K_FACES):
    """Plain PyTorch tile pass: :func:`_select_tiles`, the TPU kernel's
    (P, K) formulation, then the decode.

    coeff (N, F, 16) from :func:`_coeff_table`; bbox (N, F, 4) its
    [xmin, xmax, ymin, ymax]; attr (N, F, 3·16) vertex attributes
    premultiplied by 1/|area|, of which the first ``d_attr`` channels are
    read, or None with ``d_attr`` 0 (no attributes). Returns face_id
    (N, H, W) int32 (-1 where no face covers), zbuf (N, H, W) f32 and attrs
    (N, H, W, d_attr) f32 (0 where no face covers; empty when d_attr is 0).
    The winner's z and attributes are gathered from its slot and blended
    as (w0·v0 + w1·v1) + w2·v2, the kernel's order. Tiles go through in
    chunks, so the dense (tiles, 1024, K) temporaries stay bounded.
    """
    _check_inputs(coeff, bbox, attr, height, width, d_attr, k_faces)
    sel = _select_tiles(bbox.unbind(-1), coeff[..., 14] > 0, height, width,
                        k_faces)
    n, t, k = sel.shape
    p = TILE * TILE
    ty, tx = height // TILE, width // TILE
    dev = coeff.device
    pix = torch.arange(p, device=dev)
    dx = (pix % TILE).to(torch.float32)[:, None]                 # (P, 1)
    dy = (pix // TILE).to(torch.float32)[:, None]
    key = torch.empty(n * t, p, dtype=torch.int32, device=dev)
    zbuf = torch.empty(n * t, p, dtype=torch.float32, device=dev)
    attrs = torch.empty(n * t, p, d_attr, dtype=torch.float32, device=dev)
    sel_flat = sel.reshape(n * t, k).long()
    sample = torch.arange(n, device=dev).repeat_interleave(t)
    tile = torch.arange(t, device=dev).repeat(n)
    step = max(1, (1 << 14) // k)
    for c0 in range(0, n * t, step):
        sl = slice(c0, c0 + step)
        idx = sel_flat[sl]                                       # (B, K)
        filled = (idx >= 0)[..., None]
        b_n = sample[sl][:, None]
        rows = torch.where(filled, coeff[b_n, idx.clamp_min(0)], 0.0)

        def row(i):
            return rows[:, None, :, i]                           # (B, 1, K)

        y0 = ((tile[sl] // tx) * TILE).to(torch.float32)[:, None, None]
        x0 = ((tile[sl] % tx) * TILE).to(torch.float32)[:, None, None]
        px = x0 + dx                                             # (B, P, 1)
        py = y0 + dy
        w0 = row(0) * px + (row(1) * py + row(2))                # (B, P, K)
        w1 = row(3) * px + (row(4) * py + row(5))
        w2 = row(6) * px + (row(7) * py + row(8))
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (row(14) > 0)
        zi = w0 * row(9) + w1 * row(10) + w2 * row(11)
        zkey = zi.clamp_min(1e-30).view(torch.int32)
        fid = row(13).to(torch.int32)
        kk = ((zkey >> ID_BITS) << ID_BITS) | fid
        kk = torch.where(inside, kk, BIG_KEY)
        # keys are unique within a tile (the face id is in the low bits)
        win = kk.argmin(dim=-1, keepdim=True)                    # (B, P, 1)
        key[sl] = kk.gather(-1, win)[..., 0]
        zbuf[sl] = zi.gather(-1, win)[..., 0]
        if attr is None:
            continue
        ws = [w.gather(-1, win) for w in (w0, w1, w2)]           # (B, P, 1)
        a = torch.where(filled, attr[b_n, idx.clamp_min(0)], 0.0)
        a = a[torch.arange(a.shape[0], device=dev)[:, None], win[..., 0]]
        attrs[sl] = (ws[0] * a[..., 0:d_attr]
                     + ws[1] * a[..., ATTR_PAD:ATTR_PAD + d_attr]
                     + ws[2] * a[..., 2 * ATTR_PAD:2 * ATTR_PAD + d_attr])

    def image(v):               # (N·T, P, ...) tile-major → (N, H, W, ...)
        rest = v.shape[2:]
        v = v.reshape(n, ty, tx, TILE, TILE, *rest).transpose(2, 3)
        return v.reshape(n, height, width, *rest)

    key, zbuf, attrs = image(key), image(zbuf), image(attrs)
    bg = key >= BIG_KEY
    return (torch.where(bg, -1, key & ((1 << ID_BITS) - 1)),
            torch.where(bg, 0.0, zbuf),
            torch.where(bg[..., None], 0.0, attrs))


_ENTRY = None


def _kernel_entry():
    global _ENTRY
    if _ENTRY is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _ENTRY = _build.entry("scflow_rasterize_tiles",
                              [p, p, p, p, p, p, i, i, i, i, i, i, p])
    return _ENTRY


def rasterize_tiles(coeff: torch.Tensor, bbox: torch.Tensor,
                    attr: torch.Tensor | None, height: int, width: int,
                    d_attr: int, k_faces: int = K_FACES):
    """Tile pass: the CUDA kernel on CUDA tensors (its no-attribute
    instantiation when ``attr`` is None), the plain version
    (:func:`rasterize_tiles_reference`) on CPU tensors. Same contract."""
    if coeff.device.type == "cpu":
        return rasterize_tiles_reference(coeff, bbox, attr, height, width,
                                         d_attr, k_faces)
    if coeff.device.type != "cuda":
        raise ValueError(f"unsupported device {coeff.device}")
    _check_inputs(coeff, bbox, attr, height, width, d_attr, k_faces)
    n, f = coeff.shape[:2]
    dev = coeff.device
    face_id = torch.empty(n, height, width, dtype=torch.int32, device=dev)
    zbuf = torch.empty(n, height, width, dtype=torch.float32, device=dev)
    attrs = torch.empty(n, height, width, d_attr, dtype=torch.float32,
                        device=dev)
    err = _kernel_entry()(
        coeff.data_ptr(), bbox.data_ptr(),
        None if attr is None else attr.data_ptr(),
        face_id.data_ptr(), zbuf.data_ptr(), attrs.data_ptr(),
        n, f, k_faces, height, width, d_attr,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rasterize_tiles")
    rasterize_tiles.launches += 1
    if attr is None:
        rasterize_tiles.bare_launches += 1
    return face_id, zbuf, attrs


# launches of either instantiation, and of the no-attribute one alone
rasterize_tiles.launches = 0
rasterize_tiles.bare_launches = 0


def tile_inputs(tri_xy: torch.Tensor, tri_z: torch.Tensor,
                face_valid: torch.Tensor, height: int, width: int,
                tri_attrs: torch.Tensor | None, k_faces: int = K_FACES):
    """The tile pass's inputs for a batch of projected meshes: coeff
    (N, F', 16), bbox (N, F', 4), attr rows (N, F', 48) (None without
    ``tri_attrs``), d_attr (0 without) and the face budget
    K = min(k_faces, F'), with the faces padded to F' = a multiple of 8."""
    if height % TILE or width % TILE:
        raise ValueError(f"frame {height}x{width} is not a multiple of {TILE}")
    n, f0 = face_valid.shape
    pad = (-f0) % CHUNK
    if pad:
        face_valid = torch.cat([face_valid, face_valid.new_zeros(n, pad)], 1)
        tri_xy = torch.cat([tri_xy, tri_xy.new_zeros(n, pad, 3, 2)], 1)
        tri_z = torch.cat([tri_z, tri_z.new_zeros(n, pad, 3)], 1)
        if tri_attrs is not None:
            tri_attrs = torch.cat([tri_attrs, tri_attrs.new_zeros(
                (n, pad) + tri_attrs.shape[2:])], 1)
    fcount = f0 + pad
    if fcount >= (1 << ID_BITS):
        raise ValueError("face budget exceeds the packed id bits")
    k_faces = min(k_faces, max(CHUNK, (fcount // CHUNK) * CHUNK))

    coeff, bbox, _ = _coeff_table(tri_xy, tri_z, face_valid)
    bbox = torch.stack(bbox, dim=-1)
    if tri_attrs is None:
        return coeff.contiguous(), bbox, None, 0, k_faces
    d_attr = tri_attrs.shape[-1]
    if not 0 < d_attr <= ATTR_PAD:
        raise ValueError(f"{d_attr} attribute channels outside (0, {ATTR_PAD}]")
    attr_p = tri_attrs * coeff[..., 12, None, None]              # premultiplied
    attr_p = torch.nn.functional.pad(attr_p, (0, ATTR_PAD - d_attr))
    attr_rows = attr_p.reshape(n, fcount, 3 * ATTR_PAD).contiguous()
    return coeff.contiguous(), bbox, attr_rows, d_attr, k_faces


def winner_barycentrics(tri_xy: torch.Tensor,
                        face_id: torch.Tensor) -> torch.Tensor:
    """Screen-space barycentrics (N, H, W, 3) of the winning face at each
    pixel (x, y) from tri_xy (N, F, 3, 2) and face_id (N, H, W): the edge
    functions over the signed area, 1/area taken as 0 for a degenerate
    face, 0 on background (the JAX package's ``return_bary`` tail)."""
    n, h, w = face_id.shape
    bg = face_id < 0
    rows = torch.arange(n, device=face_id.device)[:, None, None]
    tri = tri_xy[rows, face_id.clamp_min(0).long()]           # (N, H, W, 3, 2)
    py, px = torch.meshgrid(
        torch.arange(h, dtype=tri.dtype, device=tri.device),
        torch.arange(w, dtype=tri.dtype, device=tri.device), indexing="ij")
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    inv_area = torch.where(area.abs() > 1e-12, 1.0 / area, 0.0)
    e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
    e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
    e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    bary = torch.stack([e0, e1, e2], dim=-1) * inv_area[..., None]
    return torch.where(bg[..., None], 0.0, bary)


def rasterize_fast(tri_xy: torch.Tensor, tri_z: torch.Tensor,
                   face_valid: torch.Tensor, height: int, width: int,
                   tri_attrs: torch.Tensor | None = None,
                   k_faces: int = K_FACES, return_bary: bool = True) -> dict:
    """Tile-binned rasterization of a batch of projected meshes.

    tri_xy (N, F, 3, 2) pixel coordinates and tri_z (N, F, 3) camera depth
    of each face's vertices; face_valid (N, F); tri_attrs (N, F, 3, D≤16)
    per-face-vertex attributes, interpolated with the winner's barycentric
    weights, or None (the kernel's no-attribute form). Returns dict(zbuf
    (N, H, W), face_id (N, H, W) int32, -1 for background[, attrs
    (N, H, W, D) with ``tri_attrs``][, bary (N, H, W, 3) with
    ``return_bary``, from :func:`winner_barycentrics`]), the keys of the
    JAX package's ``rasterize_fast``.
    """
    coeff, bbox, attr, d_attr, k = tile_inputs(
        tri_xy, tri_z, face_valid, height, width, tri_attrs, k_faces)
    face_id, zbuf, attrs = rasterize_tiles(coeff, bbox, attr, height, width,
                                           d_attr, k)
    out = {"zbuf": zbuf, "face_id": face_id}
    if tri_attrs is not None:
        out["attrs"] = attrs
    if return_bary:
        out["bary"] = winner_barycentrics(tri_xy, face_id)
    return out
