"""Drawing primitives in numpy for the visualisation tools: the OpenCV calls
that ``tools/visualize.py`` makes, on (H, W, C) uint8 images, in place.

- :func:`line` is ``cv2.line`` (LINE_8). Thickness 1 is OpenCV's
  ``LineIterator`` on the line clipped by ``clipLine``, pixel for pixel.
  A thicker line is cv2 5's ``ThickLine``: the segment clipped to the
  frame grown by the thickness, a quadrilateral in 16-bit fixed point
  filled as ``FillConvexPoly`` does (edges by ``Line2``, then scanlines),
  and round caps.
- :func:`circle` is the filled ``cv2.circle`` (thickness -1, LINE_8):
  OpenCV's integer midpoint circle as horizontal runs, pixel for pixel.
- :func:`find_contours` is ``cv2.findContours`` with RETR_EXTERNAL and
  CHAIN_APPROX_SIMPLE: Suzuki–Abe border following as OpenCV does it
  (a zero frame around the image, the same start pixel, search order and
  border marks), the outer borders only, in OpenCV's order (the last one
  found first).
- :func:`draw_contours` is ``cv2.drawContours`` of every contour as a
  closed polyline of :func:`line`.
- :func:`put_text` stands for ``cv2.putText`` with FONT_HERSHEY_SIMPLEX at
  scale 0.5 for the characters the tools print (digits, '.', '-', ' '):
  a stroke font of its own (the Hershey table is not carried), drawn
  with 1-pixel lines, no anti-aliasing, every ink pixel inside the box
  cv2 inks for the same string and glyph advances equal to cv2's.
"""
from __future__ import annotations

import numpy as np

# ---- lines ---------------------------------------------------------------


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to the frame [0, w) × [0, h): the clipped
    endpoints, or None where the line misses the frame."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def line_pixels(shape, p1, p2) -> tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of the 8-connected line from ``p1`` to ``p2`` (integer xy)
    within a frame of ``shape`` (H, W), as OpenCV's ``LineIterator``
    (left to right) visits them."""
    h, w = shape[:2]
    x1, y1 = (int(v) for v in p1)
    x2, y2 = (int(v) for v in p2)
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return np.zeros(0, int), np.zeros(0, int)
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:                       # left to right
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # major steps every pixel; the minor one where the error was negative
    n = dx + 1
    err = dx - 2 * dy
    minor = np.zeros(n, int)
    e, m = err, 0
    for i in range(1, n):
        if e < 0:
            m += 1
            e += 2 * dx
        e -= 2 * dy
        minor[i] = m
    major = np.arange(n)
    if vert:
        return y1 + sy * major, x1 + sx * minor
    return y1 + sy * minor, x1 + sx * major


XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: a polygon edge between 16-bit fixed-point
    points, clipped, one pixel per major-axis step from the start rounded
    to its pixel, the minor coordinate advanced in fixed point; and the
    end pixel."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    steep = abs(dx) <= abs(dy)
    if (dy if steep else dx) < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    half = XY_ONE >> 1
    if steep:
        step = _cdiv(dx << XY_SHIFT, abs(dy) | 1)
        k = np.arange(((y2 - y1) >> XY_SHIFT) + 1)
        xs, ys = (x1 + half + k * step) >> XY_SHIFT, ((y1 + half) >> XY_SHIFT) + k
    else:
        step = _cdiv(dy << XY_SHIFT, abs(dx) | 1)
        k = np.arange(((x2 - x1) >> XY_SHIFT) + 1)
        xs, ys = ((x1 + half) >> XY_SHIFT) + k, (y1 + half + k * step) >> XY_SHIFT
    xs = np.append(xs, (x2 + half) >> XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _fill_convex_poly(img: np.ndarray, v: list, color) -> None:
    """OpenCV's ``FillConvexPoly`` (LINE_8) of 16-bit fixed-point vertices
    ``v``: the edges by :func:`_line2`, then one span per scanline between
    the two edge walkers (each edge's x stepped by its rounded slope)."""
    h, w = img.shape[:2]
    n = len(v)
    half = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    xmin = (min(p[0] for p in v) + half) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + half) >> XY_SHIFT
    ymin = (min(ys) + half) >> XY_SHIFT
    ymax = (max(ys) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges, y = n, ymin
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, x=xs, idx=idx,
                             dx=_cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0 = idx
                idx = (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + half) >> XY_SHIFT
            x2 = (edge[right]["x"] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int,
                caps: int) -> None:
    """OpenCV's ``ThickLine`` (LINE_8, shift 0, thickness > 1): the segment
    clipped to the frame grown by ``thickness``, the quadrilateral around
    it, and the round caps ``caps`` asks for (bit 1 at p0, bit 2 at p1)."""
    h, w = img.shape[:2]
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, int(p0[0]) + m, int(p0[1]) + m,
                         int(p1[0]) + m, int(p1[1]) + m)
    if clipped is None:
        return
    p0 = [(clipped[0] - m) << XY_SHIFT, (clipped[1] - m) << XY_SHIFT]
    p1 = [(clipped[2] - m) << XY_SHIFT, (clipped[3] - m) << XY_SHIFT]
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(float).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx, ddy = int(round(dy * r)), int(round(dx * r))
        _fill_convex_poly(img, [(p0[0] + ddx, p0[1] + ddy),
                                (p0[0] - ddx, p0[1] - ddy),
                                (p1[0] - ddx, p1[1] - ddy),
                                (p1[0] + ddx, p1[1] + ddy)], color)
    for i, p in enumerate((p0, p1)):
        if caps & (i + 1):
            center = ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                      (p[1] + (XY_ONE >> 1)) >> XY_SHIFT)
            circle(img, center, (t + (XY_ONE >> 1)) >> XY_SHIFT, color)


def line(img: np.ndarray, p1, p2, color, thickness: int = 1,
         caps: int = 3) -> np.ndarray:
    """``cv2.line(img, p1, p2, color, thickness)`` (LINE_8) in place;
    ``caps`` as ``_thick_line``'s (a polyline caps each segment's end)."""
    if thickness <= 1:
        ys, xs = line_pixels(img.shape, p1, p2)
        img[ys, xs] = color
    else:
        _thick_line(img, p1, p2, color, thickness, caps)
    return img


# ---- filled circle -------------------------------------------------------


def circle(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """The filled ``cv2.circle(img, center, radius, color, -1)`` in place:
    OpenCV's midpoint circle, each octant step a horizontal run."""
    h, w = img.shape[:2]
    cx, cy = (int(v) for v in center)
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1
    while dx >= dy:
        for y, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and xa < w and xb >= 0:
                img[y, max(xa, 0):min(xb, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


# ---- contours ------------------------------------------------------------

# OpenCV's 8 directions: 0 right, then counter-clockwise (y grows down)
_DIRS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_NBD = 2                 # the mark of a traced border pixel
_RIGHT = 2 - 128         # the mark of one with the background to its right


def _fetch_contour(img: np.ndarray, y0: int, x0: int) -> list:
    """Follow the outer border from (y0, x0) of the padded int image,
    marking it as OpenCV does; the CHAIN_APPROX_SIMPLE points (xy, in the
    padded frame)."""
    def at(p, s):
        return p[0] + _DIRS[s][1], p[1] + _DIRS[s][0]

    i0 = (y0, x0)
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = at(i0, s)
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end and img[i1] == 0:              # a single pixel
        img[i0] = _RIGHT
        return [(x0, y0)]
    pts, pt = [], [x0, y0]
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while True:
            s += 1
            i4 = at(i3, s & 7)
            if img[i4] != 0 or s >= 15:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            img[i3] = _RIGHT
        elif img[i3] == 1:
            img[i3] = _NBD
        if s != prev_s:
            pts.append((pt[0], pt[1]))
            prev_s = s
        pt[0] += _DIRS[s][0]
        pt[1] += _DIRS[s][1]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_contours(mask: np.ndarray) -> list:
    """``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``
    for a 2-D mask (non-zero is foreground): a list of (K, 1, 2) int32
    point arrays in xy, the last border found first."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int16)
    img[1:-1, 1:-1] = np.asarray(mask) != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd_x, prev = 0, 0          # the last border mark seen on the row
        # the row's changes of value, left to right (between them the scan
        # only skips); a trace may mark later pixels of the row, so the
        # changes past it are found again after each one
        events = list(np.flatnonzero(row[1:w + 1] != row[0:w]) + 1)
        k = 0
        while k < len(events):
            x = int(events[k])
            k += 1
            p = int(row[x])
            if p == prev:
                continue
            if prev == 0 and p == 1:
                # an outer border, taken unless it lies inside one already
                # traced (the last mark seen is a left border's, > 0)
                if row[lnbd_x] <= 0:
                    pts = _fetch_contour(img, y, x)
                    found.append(np.asarray(pts, np.int32).reshape(-1, 1, 2)
                                 - 1)
                    prev = int(row[x])       # the origin's mark
                    events = list(np.flatnonzero(
                        row[x + 1:w + 1] != row[x:w]) + x + 1)
                    k = 0
                    continue
            elif p == 0 and prev >= 1 and prev & -2:
                lnbd_x = x - 1               # a hole (not traced here)
            prev = p
            if prev & -2:
                lnbd_x = x
    return found[::-1]


def draw_contours(img: np.ndarray, contours, color,
                  thickness: int = 1) -> np.ndarray:
    """``cv2.drawContours(img, contours, -1, color, thickness)`` for
    thickness ≥ 1, in place: each contour a closed polyline."""
    for c in contours:
        pts = np.asarray(c).reshape(-1, 2)
        for i in range(len(pts)):
            line(img, pts[i - 1], pts[i], color, thickness, caps=2)
    return img


# ---- text ----------------------------------------------------------------

# strokes of each glyph on a 6×9 grid whose (0, 0) lies 1 px right of the
# pen and 10 px above the baseline; the pen's advance at scale 0.5
_GLYPHS = {
    "0": ([(1, 0), (5, 0), (6, 1), (6, 8), (5, 9), (1, 9), (0, 8), (0, 1),
           (1, 0)],),
    "1": ([(1, 2), (3, 0), (3, 9)],),
    "2": ([(0, 1), (1, 0), (5, 0), (6, 1), (6, 3), (0, 9), (6, 9)],),
    "3": ([(0, 0), (6, 0), (3, 4), (5, 4), (6, 5), (6, 8), (5, 9), (1, 9),
           (0, 8)],),
    "4": ([(4, 9), (4, 0), (0, 6), (6, 6)],),
    "5": ([(6, 0), (0, 0), (0, 4), (5, 4), (6, 5), (6, 8), (5, 9), (1, 9),
           (0, 8)],),
    "6": ([(5, 0), (2, 0), (0, 2), (0, 8), (1, 9), (5, 9), (6, 8), (6, 5),
           (5, 4), (1, 4), (0, 5)],),
    "7": ([(0, 0), (6, 0), (2, 9)],),
    "8": ([(1, 0), (5, 0), (6, 1), (6, 3), (5, 4), (1, 4), (0, 3), (0, 1),
           (1, 0)],
          [(1, 4), (0, 5), (0, 8), (1, 9), (5, 9), (6, 8), (6, 5), (5, 4)]),
    "9": ([(6, 4), (1, 4), (0, 3), (0, 1), (1, 0), (5, 0), (6, 1), (6, 7),
           (4, 9), (1, 9)],),
    ".": ([(0, 8), (1, 8), (1, 9), (0, 9), (0, 8)],),
    "-": ([(0, 5), (5, 5)],),
    " ": (),
}
_ADVANCE = {**{d: 9 for d in "0123456789"}, ".": 3, "-": 7, " ": 3}


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """Draw ``text`` with its baseline's left end at ``org`` (xy), in place,
    at the tools' scale (cv2's 0.5); the characters the tools print only
    (module docstring)."""
    bad = sorted(set(text) - set(_GLYPHS))
    if bad:
        raise ValueError(f"put_text has no glyph for {bad}")
    pen_x, base_y = (int(v) for v in org)
    for ch in text:
        for stroke in _GLYPHS[ch]:
            pts = [(pen_x + 1 + gx, base_y + gy - 10) for gx, gy in stroke]
            for a, b in zip(pts[:-1], pts[1:]):
                line(img, a, b, color)
        pen_x += _ADVANCE[ch]
    return img
