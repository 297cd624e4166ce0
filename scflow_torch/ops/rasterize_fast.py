"""Tile-binned triangle rasterizer: torch pre/post around a CUDA tile kernel.

Port of ``scflow_tpu/ops/rasterize_fast.py``. A torch pre-pass builds each
face's edge/depth coefficients (:func:`_coeff_table`) and picks, per
32×32 pixel tile, the first ``K`` faces of the 8-face chunks whose
bounding boxes overlap the tile (:func:`_select_tiles`). The tile pass
(:func:`rasterize_tiles`) then runs, for every pixel and selected face,
the edge functions, the inside test, the interpolated z and a packed
(z | face id) key whose minimum is the z-test; the winner's z and
attributes are written in image layout. A torch tail decodes the keys.

On a CUDA tensor the tile pass is the hand-written kernel in
``csrc/rasterize.cu``; on a CPU tensor it is
:func:`rasterize_tiles_reference`, a literal translation of the TPU
kernel's dense (pixels × faces) formulation.
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


def rasterize_tiles_reference(coeff: torch.Tensor, sel: torch.Tensor,
                              attr: torch.Tensor, height: int, width: int,
                              d_attr: int):
    """Plain PyTorch tile pass: the TPU kernel's (P, K) formulation.

    coeff (N, F, 16) from :func:`_coeff_table`; sel (N, T, K) face ids (-1
    for empty slots); attr (N, F, 3·16) vertex attributes premultiplied by
    1/|area|, of which the first ``d_attr`` channels are read. Returns key
    (N, H, W) int32, zbuf (N, H, W) f32 and attrs (N, H, W, d_attr) f32 —
    the raw winner values, 0 where no face covers. Tiles go through in
    chunks, so the dense (tiles, 1024, K) temporaries stay bounded.
    """
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
        min_key = kk.amin(dim=-1, keepdim=True)                  # (B, P, 1)
        key[sl] = min_key[..., 0]
        winner = ((kk == min_key) & inside).to(torch.float32)
        zbuf[sl] = (winner * zi).sum(dim=-1)
        a = torch.where(filled, attr[b_n, idx.clamp_min(0)], 0.0)
        interp = (winner * w0) @ a[..., 0:ATTR_PAD]
        interp += (winner * w1) @ a[..., ATTR_PAD:2 * ATTR_PAD]
        interp += (winner * w2) @ a[..., 2 * ATTR_PAD:3 * ATTR_PAD]
        attrs[sl] = interp[..., :d_attr]

    def image(v):               # (N·T, P, ...) tile-major → (N, H, W, ...)
        rest = v.shape[2:]
        v = v.reshape(n, ty, tx, TILE, TILE, *rest).transpose(2, 3)
        return v.reshape(n, height, width, *rest)

    return image(key), image(zbuf), image(attrs)


_ENTRY = None


def _kernel_entry():
    global _ENTRY
    if _ENTRY is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _ENTRY = _build.entry("scflow_rasterize_tiles",
                              [p, p, p, p, p, p, i, i, i, i, i, i, p])
    return _ENTRY


def rasterize_tiles(coeff: torch.Tensor, sel: torch.Tensor,
                    attr: torch.Tensor, height: int, width: int, d_attr: int):
    """Tile pass: the CUDA kernel on CUDA tensors, the plain version
    (:func:`rasterize_tiles_reference`) on CPU tensors. Same contract."""
    if coeff.device.type == "cpu":
        return rasterize_tiles_reference(coeff, sel, attr, height, width,
                                         d_attr)
    if coeff.device.type != "cuda":
        raise ValueError(f"unsupported device {coeff.device}")
    n, t, k = sel.shape
    f = coeff.shape[1]
    if height % TILE or width % TILE or t != (height // TILE) * (width // TILE):
        raise ValueError(f"{height}x{width} frame does not match {t} tiles")
    if not 0 < k <= K_FACES or k % CHUNK:
        raise ValueError(f"face budget {k} not a multiple of {CHUNK} in "
                         f"(0, {K_FACES}]")
    if f >= (1 << ID_BITS):
        raise ValueError(f"{f} faces exceed the {ID_BITS}-bit packed id")
    if not 0 < d_attr <= ATTR_PAD:
        raise ValueError(f"d_attr {d_attr} outside (0, {ATTR_PAD}]")
    for x, dtype, shape in ((coeff, torch.float32, (n, f, 16)),
                            (sel, torch.int32, (n, t, k)),
                            (attr, torch.float32, (n, f, 3 * ATTR_PAD))):
        if (x.device != coeff.device or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"expected contiguous {dtype} {shape} on "
                             f"{coeff.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    dev = coeff.device
    key = torch.empty(n, height, width, dtype=torch.int32, device=dev)
    zbuf = torch.empty(n, height, width, dtype=torch.float32, device=dev)
    attrs = torch.empty(n, height, width, d_attr, dtype=torch.float32,
                        device=dev)
    err = _kernel_entry()(
        coeff.data_ptr(), sel.data_ptr(), attr.data_ptr(),
        key.data_ptr(), zbuf.data_ptr(), attrs.data_ptr(),
        n, f, k, height, width, d_attr,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rasterize_tiles")
    rasterize_tiles.launches += 1
    return key, zbuf, attrs


rasterize_tiles.launches = 0


def tile_inputs(tri_xy: torch.Tensor, tri_z: torch.Tensor,
                face_valid: torch.Tensor, height: int, width: int,
                tri_attrs: torch.Tensor, k_faces: int = K_FACES):
    """The tile pass's inputs for a batch of projected meshes: (coeff
    (N, F', 16), sel (N, T, K) int32, attr rows (N, F', 48), d_attr), with the faces padded to F' = a multiple of 8 and
    K = min(k_faces, F')."""
    if height % TILE or width % TILE:
        raise ValueError(f"frame {height}x{width} is not a multiple of {TILE}")
    n, f0 = face_valid.shape
    pad = (-f0) % CHUNK
    if pad:
        face_valid = torch.cat([face_valid, face_valid.new_zeros(n, pad)], 1)
        tri_xy = torch.cat([tri_xy, tri_xy.new_zeros(n, pad, 3, 2)], 1)
        tri_z = torch.cat([tri_z, tri_z.new_zeros(n, pad, 3)], 1)
        tri_attrs = torch.cat(
            [tri_attrs, tri_attrs.new_zeros((n, pad) + tri_attrs.shape[2:])], 1)
    fcount = f0 + pad
    if fcount >= (1 << ID_BITS):
        raise ValueError("face budget exceeds the packed id bits")
    k_faces = min(k_faces, max(CHUNK, (fcount // CHUNK) * CHUNK))

    coeff, bbox, ok = _coeff_table(tri_xy, tri_z, face_valid)
    d_attr = tri_attrs.shape[-1]
    if not 0 < d_attr <= ATTR_PAD:
        raise ValueError(f"{d_attr} attribute channels outside (0, {ATTR_PAD}]")
    attr_p = tri_attrs * coeff[..., 12, None, None]              # premultiplied
    attr_p = torch.nn.functional.pad(attr_p, (0, ATTR_PAD - d_attr))
    attr_rows = attr_p.reshape(n, fcount, 3 * ATTR_PAD).contiguous()
    sel = _select_tiles(bbox, ok, height, width, k_faces)
    return coeff.contiguous(), sel, attr_rows, d_attr


def rasterize_fast(tri_xy: torch.Tensor, tri_z: torch.Tensor,
                   face_valid: torch.Tensor, height: int, width: int,
                   tri_attrs: torch.Tensor, k_faces: int = K_FACES) -> dict:
    """Tile-binned rasterization of a batch of projected meshes.

    tri_xy (N, F, 3, 2) pixel coordinates and tri_z (N, F, 3) camera depth
    of each face's vertices; face_valid (N, F); tri_attrs (N, F, 3, D≤16)
    per-face-vertex attributes, interpolated with the winner's barycentric
    weights. Returns dict(zbuf (N, H, W), face_id (N, H, W) int32, -1 for
    background, attrs (N, H, W, D)).
    """
    coeff, sel, attr_rows, d_attr = tile_inputs(
        tri_xy, tri_z, face_valid, height, width, tri_attrs, k_faces)
    key, zbuf, attrs = rasterize_tiles(coeff, sel, attr_rows, height, width,
                                       d_attr)
    bg = key >= BIG_KEY
    return {"zbuf": torch.where(bg, 0.0, zbuf),
            "face_id": torch.where(bg, -1, key & ((1 << ID_BITS) - 1)),
            "attrs": torch.where(bg[..., None], 0.0, attrs)}
