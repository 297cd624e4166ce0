"""The host library's C++ data passes against their numpy witnesses, bit
for bit, on the CPU: PNG unfiltering (``csrc/png_unfilter.cpp``), the eval
crop (``csrc/crop.cpp``) and the train crop's and augmentations' pixel
passes (``csrc/cvops.cpp``); and against what the JAX package calls for
the same work (its libpng decode and C++ crop, cv2) where it has it.

Each C++ entry is reached through the public function the data path
calls; each witness is the numpy form that the function ran before the
C++ (``imageio._unfilter_rows_np``, ``pipeline._crop_resize_pad_batch_np``,
``cvops._*_np``)."""
import re
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest

from port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_data import encode_png
from scflow_torch.data import color_aug, cvops, imageio, pipeline

FRAME = (480, 640)
CSRC = Path(pipeline.__file__).resolve().parent / "csrc"
# the C++ standard library headers the host sources may include (the
# card's machine is not known to have libpng, zlib, libjpeg or OpenCV)
STD_HEADERS = {"algorithm", "cmath", "cstddef", "cstdint", "cstdio",
               "cstdlib", "cstring", "exception", "string", "utility",
               "vector"}


def _unfilter_both(data: bytes, path: str = "<bytes>"):
    """The rows of a PNG unfiltered by the C++ and by the witness."""
    raw, height, width, bpp, _ = imageio._inflate_png(data, path)
    args = (raw, height, width * bpp, bpp, path)
    return imageio._unfilter_rows(*args), imageio._unfilter_rows_np(*args)


def _bits_equal(got, want, what=""):
    """Equal arrays, float32 compared as bit patterns (-0 ≠ 0)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cpp")))
def test_host_sources_include_standard_headers_only(source):
    """Each host source includes C++ standard headers and nothing else."""
    text = (CSRC / source).read_text()
    includes = re.findall(r"^\s*#\s*include\s*(\S+)", text, re.M)
    assert includes and all(i.strip("<>") in STD_HEADERS and i[0] == "<"
                            for i in includes), includes


# -- PNG ---------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_png_unfilter_matches_witness(channels, filt):
    """Every filter type and mixed rows, 1-4 bytes a pixel, every width
    from 1 to 67 (7 rows, the stream over 1-3 IDATs): the C++ pass equals
    the witness's rows, and ``decode_png`` returns the image."""
    rng = np.random.default_rng(channels * 10 + (5 if filt == "mixed" else filt))
    for width in range(1, 68):
        shape = (7, width) if channels == 1 else (7, width, channels)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        data = encode_png(img, filt, idats=1 + width % 3)
        _bits_equal(*_unfilter_both(data), f"width {width}")
        _bits_equal(imageio.decode_png(data)[0],
                    img.reshape(7, width, channels), f"width {width}")


def _frames():
    """A 640×480 frame with gradients and a noise block, as
    ``test_png_decoder_reads_cv2_files`` draws it."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:FRAME[0], 0:FRAME[1]]
    img = np.stack([(x * 0.4 + y * 0.1) % 256, (y * 0.5) % 256,
                    (x * y * 0.001) % 256], -1).astype(np.uint8)
    img[100:200, 100:300] = rng.integers(0, 256, (100, 200, 3))
    return img


@pytest.mark.parametrize("writer", ["cv2", "paeth"])
def test_png_frame_matches_witness_libpng_and_cv2(tmp_path, writer):
    """A cv2-written 640×480 frame (its adaptive filters) and one whose
    every row is Paeth-filtered: ``imread`` equals the witness's decode,
    the JAX package's libpng decode (``scflow_tpu.data.native``) and
    cv2's."""
    from scflow_tpu.data import native

    img = _frames()
    path = str(tmp_path / f"{writer}.png")
    if writer == "cv2":
        cv2.imwrite(path, img[..., ::-1])
    else:
        with open(path, "wb") as f:
            f.write(encode_png(img, 4, idats=2))
    with open(path, "rb") as f:
        data = f.read()
    got = imageio.imread(path)
    _bits_equal(got, img)
    _bits_equal(*_unfilter_both(data))
    _bits_equal(got, native.decode_image(path, channels=3))
    _bits_equal(got, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("kind", [5, 255])
def test_png_unknown_filter_raises(kind):
    """An unknown filter type on the third row raises the witness's
    ValueError, naming the file and the type."""
    img = np.random.default_rng(kind).integers(0, 256, (4, 9, 3), np.uint8)
    data = encode_png(img, 0)
    raw = bytearray(imageio._inflate_png(data, "x")[0].tobytes())
    raw[2 * (9 * 3 + 1)] = kind
    z = zlib.compress(bytes(raw))
    idat = (struct.pack(">I", len(z)) + b"IDAT" + z
            + struct.pack(">I", zlib.crc32(b"IDAT" + z)))
    start = data.index(b"IDAT") - 4
    end = data.index(b"IEND") - 4
    bad = data[:start] + idat + data[end:]
    message = f"bad.png: unknown PNG filter type {kind}"
    with pytest.raises(ValueError, match=message):
        imageio.decode_png(bad, "bad.png")
    raw, height, width, bpp, _ = imageio._inflate_png(bad, "bad.png")
    for unfilter in (imageio._unfilter_rows, imageio._unfilter_rows_np):
        with pytest.raises(ValueError, match=message):
            unfilter(raw, height, width * bpp, bpp, "bad.png")


# -- the eval crop -------------------------------------------------------------

def _native_boxes():
    """``test_crop_matches_native``'s 203 boxes."""
    rng = np.random.default_rng(0)
    x1, y1 = rng.uniform(-300, 700, 200), rng.uniform(-300, 500, 200)
    side = rng.uniform(3, 500, 200)
    boxes = np.trunc(np.stack([x1, y1, x1 + side * rng.uniform(0.4, 1.6, 200),
                               y1 + side], -1)).astype(np.float32)
    return np.concatenate([boxes, [[-500, -400, -300, -200],
                                   [600, 400, 900, 700],
                                   [10, 10, 10 + 255, 10 + 83]]]).astype(np.float32)


@pytest.mark.parametrize("size", [64, 256])
def test_crop_matches_witness(size):
    """The 203 boxes of ``test_crop_matches_native`` on a 640×480 frame,
    with mean and std, plus 200 boxes with fractional corners: patches and
    transforms bit-equal to the witness, and within
    ``test_crop_matches_native``'s bounds of the JAX package's C++."""
    from scflow_tpu.data import native

    rng = np.random.default_rng(size)
    img = rng.integers(0, 256, (*FRAME, 3), dtype=np.uint8)
    frac = rng.uniform(-200, 800, (200, 4)).astype(np.float32)
    frac[:, 2:] = frac[:, :2] + rng.uniform(0.5, 400, (200, 2))
    boxes = np.concatenate([_native_boxes(), frac])
    kw = dict(mean=(10, 20, 30), std=(50, 60, 70), pad_val=97.5)
    got = pipeline.crop_resize_pad_batch([img] * len(boxes), boxes, size, **kw)
    want = pipeline._crop_resize_pad_batch_np([img] * len(boxes), boxes, size,
                                              **kw)
    for g, w, what in zip(got, want, ("patches", "transforms")):
        _bits_equal(g, w, what)
    jax_patch, jax_t = native.crop_resize_pad_batch(
        [img] * len(boxes), boxes, size, **kw)
    np.testing.assert_allclose(got[0], jax_patch, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], jax_t, rtol=0, atol=1e-6)


def test_crop_edge_cases():
    """A 1×1 frame, boxes wholly out of frame on each side, zero-area and
    inverted boxes (pad only, identity), several images in one call (runs
    of one image object crop in one C++ call each): bit-equal to the
    witness."""
    rng = np.random.default_rng(1)
    one = rng.integers(0, 256, (1, 1, 3), dtype=np.uint8)
    frame = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    boxes = np.array([[0, 0, 1, 1], [-3, -2, 4, 5], [0.7, 0.2, 1.9, 1.3],
                      [-50, -40, -10, -5], [60, 0, 90, 20], [0, 40, 20, 70],
                      [-9, -9, 100, 100], [5, 5, 5, 9], [5, 5, 9, 5],
                      [9, 9, 4, 4], [0, 0, 53, 37], [52.9, 36.9, 53.5, 37.5]],
                     np.float32)
    images = [one] * 3 + [frame] * 4 + [one, frame, frame.copy(), one, frame]
    for size in (8, 64):
        got = pipeline.crop_resize_pad_batch(images, boxes, size)
        want = pipeline._crop_resize_pad_batch_np(images, boxes, size)
        _bits_equal(got[0], want[0], f"patches {size}")
        _bits_equal(got[1], want[1], f"transforms {size}")
        for i in (7, 8, 9):
            assert (got[1][i] == np.eye(3)).all()
            assert (got[0][i] == np.float32(128.0) / np.float32(255.0)).all()


@pytest.mark.parametrize("box", [[np.nan, 0, 4, 4], [0, 0, np.inf, 4],
                                 [0, 0, 2.0 ** 24, 4]])
def test_crop_refuses_boxes_past_its_range(box):
    """A corner that is not finite or not below 2^24 raises."""
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="within ±2\\^24"):
        pipeline.crop_resize_pad_batch([img], [box], 8)


# -- cvops -----------------------------------------------------------------------

def test_resize_linear_matches_witness():
    """200 seeded size pairs (sides from 1 to 300), 1 and 3 channels, and
    every pairing of 1-pixel sides: bit-equal to the witness and to
    cv2."""
    rng = np.random.default_rng(0)
    pairs = [((int(h), int(w)), (int(oh), int(ow))) for h, w, oh, ow in
             rng.integers(1, 300, (200, 4))]
    pairs += [((h, w), (oh, ow)) for h in (1, 2) for w in (1, 5)
              for oh in (1, 3) for ow in (1, 4)]
    for i, (src, out) in enumerate(pairs):
        shape = src if i % 2 else (*src, 3)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = cvops.resize_linear(img, out)
        _bits_equal(got, cvops._resize_linear_np(img, out), f"{src} {out}")
        _bits_equal(got, cv2.resize(img, out[::-1],
                                    interpolation=cv2.INTER_LINEAR),
                    f"cv2 {src} {out}")


@pytest.mark.parametrize("k", [3, 5])
def test_gaussian_blur_matches_witness(k):
    """Planes from 1×1 up, gray and RGB, views that are not contiguous:
    bit-equal to the witness and to cv2."""
    rng = np.random.default_rng(k)
    for h in (1, 2, 3, 4, 6, 31):
        for w in (1, 2, 3, 5, 40):
            for shape in ((h, w), (h, w, 3)):
                img = rng.integers(0, 256, shape, dtype=np.uint8)
                got = cvops.gaussian_blur(img, k)
                _bits_equal(got, cvops._gaussian_blur_np(img, k), f"{shape}")
                _bits_equal(got, cv2.GaussianBlur(img, (k, k), 0),
                            f"cv2 {shape}")
    view = rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)[::2, ::-3]
    _bits_equal(cvops.gaussian_blur(view, k), cvops._gaussian_blur_np(view, k))
    with pytest.raises(ValueError, match="kernel size 7"):
        cvops.gaussian_blur(view, 7)


def _all_triples() -> np.ndarray:
    """(4096, 4096, 3): every uint8 triple once."""
    i = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([i >> 16, (i >> 8) & 255, i & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


def test_color_conversions_match_witness_on_every_color():
    """RGB→HSV, HSV→RGB (every H byte, 180-255 included) and RGB→GRAY
    over all 2^24 triples: bit-equal to the witnesses."""
    img = _all_triples()
    for name in ("rgb_to_hsv", "hsv_to_rgb", "rgb_to_gray"):
        got = getattr(cvops, name)(img)
        for rows in range(0, 4096, 1024):       # the witness in slices
            _bits_equal(got[rows:rows + 1024], getattr(cvops, f"_{name}_np")(
                img[rows:rows + 1024]), f"{name} rows {rows}")


def test_hsv_jitter_matches_witness():
    """The fused pass on every color at draws that wrap the hue below 0
    (tiny negative sums round up to 180) and past 180, scale S and V to
    clipping and to zero: bit-equal to the witness."""
    img = _all_triples()[::4]                   # every R, every G, B/4
    draws = [(-1e-6, 1.0, 1.0), (-36.0, 1.5, 0.5), (35.99, 0.5, 1.5),
             (-0.4, 1.0, 1.0), (17.3, 0.0, 2.0), (179.9, 1.2, 0.8)]
    for dh, ds, dv in draws:
        got = cvops.hsv_jitter(img, dh, ds, dv)
        _bits_equal(got, cvops._hsv_jitter_np(img, dh, ds, dv), f"{dh}")
    red = np.array([[9, 0, 0]], np.uint8)            # H 0, S 255, V 9
    _bits_equal(cvops.hsv_jitter(red, -1e-6, 1, 1),
                cvops._hsv_to_rgb_np(np.array([[180, 255, 9]], np.uint8)))


def test_hsv_to_rgb_row_tails_match_cv2():
    """cv2 converts a row 32 pixels a vector step (truncating) and the
    rest in scalar code (rounding): every HSV triple as a row of one pixel
    (all scalar) and in rows 48 wide, and seeded colors at every width
    from 1 to 99, bit-equal to cv2, C++ and witness, plain and jittered
    (``hsv_jitter`` at no shift and scale 1)."""
    hsv = _all_triples().reshape(-1, 3)
    hsv[:, 0] %= 180
    for width in (1, 48):
        img = hsv[:len(hsv) // width * width].reshape(-1, width, 3)
        want = cv2.cvtColor(img, cv2.COLOR_HSV2RGB)
        _bits_equal(cvops.hsv_to_rgb(img), want, f"width {width}")
        rows = 65536 // width
        _bits_equal(cvops._hsv_to_rgb_np(img[:rows]), want[:rows])
    rng = np.random.default_rng(8)
    for width in range(1, 100):
        img = rng.integers(0, 256, (9, width, 3), dtype=np.uint8)
        hsv = (img % np.array([180, 256, 256])).astype(np.uint8)
        _bits_equal(cvops.hsv_to_rgb(hsv),
                    cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), f"width {width}")
        _bits_equal(cvops._hsv_to_rgb_np(hsv),
                    cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), f"width {width}")
        want = cv2.cvtColor(cv2.cvtColor(img, cv2.COLOR_RGB2HSV),
                            cv2.COLOR_HSV2RGB)
        _bits_equal(cvops.hsv_jitter(img, 0.0, 1.0, 1.0), want, f"{width}")
        _bits_equal(cvops._hsv_jitter_np(img, 0.0, 1.0, 1.0), want)


@pytest.mark.parametrize("width", [64, 48, 7])
def test_random_hsv_matches_jax(width):
    """``random_hsv`` at 40 seeded draws against the JAX package's (cv2)
    on rows of whole vector steps, with a scalar tail, and all tail: the
    same pixels, the Generators left in the same state."""
    from scflow_tpu.data import color_aug as jax_aug

    img = np.random.default_rng(3).integers(0, 256, (48, width, 3), np.uint8)
    img[:8] = [[255, 0, 1]]            # hue 0 from above: wraps at 0
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    for call in range(40):
        _bits_equal(color_aug.random_hsv(rng, img),
                    jax_aug.random_hsv(jrng, img), f"call {call}")
        assert rng.bit_generator.state == jrng.bit_generator.state


# -- threads, and no cv2 ---------------------------------------------------------

def _calls():
    """(name, function of no arguments) for each C++ entry, on shared
    inputs."""
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (*FRAME, 3), dtype=np.uint8)
    png = encode_png(frame, "mixed", idats=3)
    boxes = _native_boxes()[:8]
    patch = frame[100:356, 200:456]
    return [
        ("decode_png", lambda: imageio.decode_png(png)[0]),
        ("crop", lambda: pipeline.crop_resize_pad_batch([frame] * 8, boxes,
                                                        256)[0]),
        ("resize", lambda: cvops.resize_linear(frame, (256, 211))),
        ("blur", lambda: cvops.gaussian_blur(patch, 5)),
        ("gray", lambda: cvops.rgb_to_gray(patch)),
        ("hsv", lambda: cvops.hsv_to_rgb(cvops.rgb_to_hsv(patch))),
        ("jitter", lambda: cvops.hsv_jitter(patch, -20.5, 1.3, 0.7)),
    ]


def test_six_threads_give_the_bytes_of_one():
    """Each entry run 4 times on each of 6 threads over shared inputs
    (ctypes releases the GIL) returns the bytes of one call alone."""
    for name, fn in _calls():
        want = fn()
        with ThreadPoolExecutor(6) as pool:
            futures = [pool.submit(fn) for _ in range(24)]
            for f in futures:
                _bits_equal(f.result(timeout=60), want, name)


def _witness_names(m):
    """Point the crop's and augmentations' cvops names at the witnesses."""
    m.setattr(pipeline, "resize_linear", cvops._resize_linear_np)
    for name in ("hsv_jitter", "gaussian_blur", "resize_linear",
                 "rgb_to_gray"):
        m.setattr(color_aug, name, getattr(cvops, f"_{name}_np"))


AUG_CALLS = {
    "default_train_augs": lambda r, img, mask, bg:
        color_aug.default_train_augs(r, img),
    "random_sharpness": lambda r, img, mask, bg:
        color_aug.random_sharpness(r, img),
    "random_gray": lambda r, img, mask, bg: color_aug.random_gray(r, img, p=1),
    "random_background": lambda r, img, mask, bg:
        color_aug.random_background(r, img, mask, [bg], p=1),
}


def test_host_passes_run_without_cv2(monkeypatch, tmp_path):
    """With cv2 unimportable, every C++ entry runs; ``imread`` of a Paeth
    PNG, the train crop with its mask and the augmentations that reach the
    C++ give what they give with the witnesses in its place, from the same
    draws."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    for name, fn in _calls():
        fn()
    rng = np.random.default_rng(6)
    frame = rng.integers(0, 256, (*FRAME, 3), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(frame, 4))
    _bits_equal(imageio.imread(str(path)), frame)
    mask = np.zeros(FRAME, bool)
    mask[100:300, 200:400] = True
    bbox = np.array([180, 90, 420, 310])

    def run():
        crop = pipeline.crop_resize_pad(frame, bbox, np.eye(3), 256, 1.2,
                                        mask=mask)
        out = [crop.patch, crop.mask_patch]
        for seed, (name, aug) in enumerate(AUG_CALLS.items()):
            out.append(aug(np.random.default_rng(seed), crop.patch,
                           crop.mask_patch, frame[::2, ::3]))
        return out

    got = run()
    with monkeypatch.context() as m:
        _witness_names(m)
        want = run()
    for g, w, name in zip(got, want, ["patch", "mask", *AUG_CALLS]):
        _bits_equal(g, w, name)
