"""Write the JPEG fixtures of the port's decoder: ``tests/torch_fixtures/jpeg/``.

Run from the repository root, where cv2 is installed:

    python tests/torch_fixtures/make_jpeg_fixtures.py

Every file is written by cv2 (libjpeg-turbo) and ``manifest.json`` holds,
for each, the sha256 of cv2's decoded arrays: ``rgb`` (``IMREAD_COLOR``,
channels reversed to RGB) and ``gray`` (``IMREAD_GRAYSCALE``), C order.
``chip_smoke.py`` decodes every file with the port's decoder on a machine
without cv2 and checks both digests: bit-equality without cv2.

- ``frame_*.jpg``: the 8 frames of ``scflow_torch.tools.make_synthetic_bop
  --split train_pbr --seed 0 --num-images 8`` with chip_smoke's tree
  arguments (21 classes, 480×640, 3–6 objects), re-encoded at q95 4:2:0
  baseline, the form of BOP ``train_pbr``. The tool writes the same
  annotations and masks for that seed on the card, so the frames fit them.
- ``textured_*.jpg``: 2 textured 640×480 frames (q95 4:2:0), for timing.
- ``bg_*.jpg``: 3 backgrounds at 320×240: progressive, gray, and 4:4:4
  with a restart interval.
- ``conf_*.jpg``: the conformance forms at odd sizes (every sampling
  baseline and progressive at 1×1, 7×9 and 17×33; four forms at 645×483).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

REPO = Path(__file__).resolve().parents[2]
OUT = Path(__file__).resolve().parent / "jpeg"
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# chip_smoke's tree arguments (NUM_CLASS, BOP_FRAME, BOP_OBJECTS)
TREE = ["--num-classes", "21", "--height", "480", "--width", "640",
        "--min-objects", "3", "--max-objects", "6"]


def encode(rgb: np.ndarray, quality: int = 95, sampling: str = "420",
           progressive: bool = False, optimize: bool = False,
           restart: int = 0) -> bytes:
    """cv2's JPEG of an (H, W, 3) RGB or (H, W) gray uint8 image."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if rgb.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        rgb = rgb[..., ::-1]
    ok, buf = cv2.imencode(".jpg", rgb, params)
    assert ok
    return buf.tobytes()


def content(h: int, w: int, seed: int, noise: float = 20.0,
            blocks: int | None = None) -> np.ndarray:
    """Gradients, noise and flat blocks (the tests' conformance content)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) * 127 / max(w + h - 2, 1)], -1)
    img = img + rng.normal(0, noise, img.shape)
    for _ in range(max(1, h * w // 400) if blocks is None else blocks):
        by, bx = rng.integers(0, h), rng.integers(0, w)
        img[by:by + 16, bx:bx + 24] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def textured(h: int, w: int, seed: int) -> np.ndarray:
    """A photo-like frame: smooth color fields, fine texture and edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y, x = yy / 64.0, xx / 64.0
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(6):
            fx, fy, ph = rng.uniform(0.2, 3.0, 2).tolist() + [rng.uniform(0, 6)]
            img[..., c] += 30 * np.sin(fx * x + fy * y + ph)
    img += 128 + rng.normal(0, 2, (h, w, 1))
    for _ in range(30):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(8, 60)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def tool_frames(tmp: str) -> list[np.ndarray]:
    """The train_pbr frames of the port's tool, seed 0, on the CPU."""
    sys.path.insert(0, str(REPO))
    from scflow_torch.tools.make_synthetic_bop import main

    main(["--out", tmp, "--split", "train_pbr", "--num-images", "8",
          "--seed", "0", *TREE, "--device", "cpu"])
    rgb = Path(tmp) / "train_pbr" / "000001" / "rgb"
    return [cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1]
            for p in sorted(rgb.iterdir())]


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=str(OUT))
    out = Path(p.parse_args(argv).out)
    out.mkdir(parents=True, exist_ok=True)
    files: dict[str, tuple[str, bytes]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, frame in enumerate(tool_frames(tmp)):
            files[f"frame_{i:06d}.jpg"] = ("frame", encode(frame))
    for i in range(2):
        files[f"textured_{i}.jpg"] = ("textured", encode(textured(480, 640, i)))
    bg = content(240, 320, 7, noise=4.0, blocks=40)
    files["bg_progressive.jpg"] = ("background", encode(bg, progressive=True))
    files["bg_gray.jpg"] = ("background", encode(
        cv2.cvtColor(bg, cv2.COLOR_RGB2GRAY), quality=90))
    files["bg_444_rst.jpg"] = ("background", encode(bg, sampling="444",
                                                    restart=3))
    for h, w in ((1, 1), (7, 9), (17, 33)):
        img = content(h, w, h)
        for s in SAMPLING:
            for prog in (False, True):
                name = f"conf_{h}x{w}_{s}_{'prog' if prog else 'base'}.jpg"
                files[name] = ("conformance", encode(img, 90, s, prog))
    big = content(483, 645, 1, noise=3.0, blocks=60)
    for name, kw in (("420_prog_opt", dict(sampling="420", progressive=True,
                                            optimize=True)),
                     ("422_q85_rst3", dict(sampling="422", quality=85, restart=3)),
                     ("411_q75", dict(sampling="411", quality=75)),
                     ("440_rst1", dict(sampling="440", quality=50,
                                       restart=1))):
        files[f"conf_483x645_{name}.jpg"] = ("conformance", encode(big, **kw))

    manifest = []
    for name, (kind, data) in sorted(files.items()):
        (out / name).write_bytes(data)
        rgb = cv2.imread(str(out / name), cv2.IMREAD_COLOR)[..., ::-1]
        gray = cv2.imread(str(out / name), cv2.IMREAD_GRAYSCALE)
        manifest.append(dict(file=name, kind=kind, shape=list(gray.shape),
                             bytes=len(data), rgb_sha256=digest(rgb),
                             gray_sha256=digest(gray)))
    (out / "manifest.json").write_text(json.dumps(
        {"writer": f"cv2 {cv2.__version__}", "files": manifest}, indent=1)
        + "\n")
    for f in sorted(out.glob("*.jpg")):
        if f.name not in files:
            os.remove(f)                 # a stale file of an earlier run
    total = sum(f.stat().st_size for f in out.iterdir())
    print(f"wrote {len(manifest)} files, {total} bytes, to {out}")


if __name__ == "__main__":
    main()
