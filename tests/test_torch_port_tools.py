"""The port's visualisation and tool twins (``scflow_torch/tools``) against
cv2 and the JAX package's tools.

- The drawing primitives against cv2 5 bit for bit: lines of thickness 1
  to 5 (in and out of the frame), filled circles of radius 0-3,
  ``findContours``' point lists (RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) and
  ``drawContours`` at thickness 1-3. ``put_text`` (no Hershey table) is
  held to a bound: every ink pixel inside the box cv2 inks for the same
  string, grown by 2 px.
- ``VisTool`` (mask and contour) and ``draw_detections`` against
  ``tools/visualize.py`` on the CPU on the same scene: equal images (with
  scores: equal outside the text).
- Each tool's ``main`` end to end on a ``make_synthetic_bop`` tree, in a
  process where cv2, PIL and JAX cannot be imported; the PNGs read back
  through the port's reader.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from port_common import one_torch_thread  # noqa: E402,F401
from scflow_torch.tools import draw  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))


def random_points(rng, n, lo, hi):
    return [tuple(int(v) for v in rng.integers(lo, hi, 2)) for _ in range(n)]


@pytest.mark.parametrize("thickness", [1, 2, 3, 5])
def test_line_matches_cv2(thickness):
    rng = np.random.default_rng(thickness)
    for i in range(150):
        h, w = (int(v) for v in rng.integers(5, 70, 2))
        lo, hi = (-30, 100) if i % 2 else (0, min(h, w))
        p1, p2 = random_points(rng, 2, lo, hi)
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.line(want, p1, p2, (255, 3, 70), thickness)
        draw.line(got, p1, p2, (255, 3, 70), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2} {h}x{w}")


def test_filled_circle_matches_cv2():
    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(3, 30, 2))
        c = tuple(int(v) for v in rng.integers(-4, 34, 2))
        r = int(rng.integers(0, 4))
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.circle(want, c, r, (1, 200, 3), -1)
        draw.circle(got, c, r, (1, 200, 3))
        np.testing.assert_array_equal(got, want, err_msg=f"{c} {r}")


def contour_masks(rng, n=60):
    """Noise at several densities (many pieces, holes, objects in holes)
    and rings with a disc inside."""
    out = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(3, 48, 2))
        m = rng.uniform(size=(h, w)) < rng.uniform(0.05, 0.7)
        if i % 3 == 0:
            ys, xs = np.mgrid[0:h, 0:w]
            r = np.hypot(ys - h / 2, xs - w / 2)
            s = min(h, w)
            m = (r < s / 2.2) & ~((r > s / 5) & (r < s / 3.5))
        out.append(m.astype(np.uint8))
    m = np.zeros((20, 30), np.uint8)
    m[5, 7] = 1                             # one pixel
    m[0, :] = 1                             # a border row
    m[10:15, 20:29] = 1
    out.append(m)
    return out


def test_find_contours_matches_cv2():
    for m in contour_masks(np.random.default_rng(1)):
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        got = draw.find_contours(m)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.int32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_draw_contours_matches_cv2(thickness):
    for m in contour_masks(np.random.default_rng(2), 30):
        contours, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        want = np.full(m.shape + (3,), 40, np.uint8)
        got = want.copy()
        cv2.drawContours(want, contours, -1, (0, 255, 255), thickness)
        draw.draw_contours(got, contours, (0, 255, 255), thickness)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text", ["0.90", "0.45", "1.00", "-0.5", "12.34",
                                  "0123456789", "9.87 6.54", "."])
def test_put_text_inks_inside_cv2_box(text):
    want = np.zeros((40, 140, 3), np.uint8)
    got = want.copy()
    cv2.putText(want, text, (7, 25), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (255, 255, 255), 1, cv2.LINE_AA)
    draw.put_text(got, text, (7, 25), (255, 255, 255))
    ys, xs = np.nonzero(want.any(-1))
    gy, gx = np.nonzero(got.any(-1))
    assert len(gy) > 0
    assert (gy >= ys.min() - 2).all() and (gy <= ys.max() + 2).all()
    assert (gx >= xs.min() - 2).all() and (gx <= xs.max() + 2).all()
    with pytest.raises(ValueError):
        draw.put_text(got, "x", (0, 10), (1, 1, 1))


@pytest.fixture(scope="module")
def scene():
    """tests/test_visualize.py's scene, with both packages' renderers."""
    from scflow_torch.rendering import Renderer as PortRenderer
    from scflow_torch.rendering import make_test_meshes as port_meshes
    from scflow_tpu.rendering import Renderer, make_test_meshes

    jax_renderer = Renderer(make_test_meshes(num_classes=2, subdivisions=1,
                                             radius=40.0), image_size=(96, 96))
    bank = port_meshes(2, subdivisions=1, radius=40.0, device="cpu")
    port_renderer = PortRenderer(bank, image_size=(96, 96))
    k = np.array([[120.0, 0, 48], [0, 120.0, 48], [0, 0, 1]], np.float32)
    rots = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    rots[2] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    trans = np.array([[0, 0, 400.0], [20, 10, 500.0], [-25, -20, 450.0]],
                     np.float32)
    return dict(jax_renderer=jax_renderer, port_renderer=port_renderer,
                rots=rots, trans=trans, labels=np.array([0, 1, 1], np.int32),
                ks=np.tile(k, (3, 1, 1)),
                pts=bank.verts[0].numpy().astype(np.float32),
                image=np.random.default_rng(3).integers(
                    0, 255, (96, 96, 3)).astype(np.uint8))


@pytest.mark.parametrize("mode", ["mask", "contour"])
def test_vistool_matches_jax(scene, mode, tmp_path):
    from scflow_torch.data.imageio import imread
    from scflow_torch.tools.visualize import VisTool
    from visualize import VisTool as JaxVisTool

    args = (scene["image"], scene["rots"], scene["trans"], scene["labels"],
            scene["ks"])
    want = JaxVisTool(scene["jax_renderer"], vis_mode=mode)(*args)
    tool = VisTool(scene["port_renderer"], vis_mode=mode)
    assert tool.renderer.render_image is False
    out = tmp_path / "vis.png"
    got = tool(*args, out_file=str(out))
    assert (got != scene["image"]).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imread(str(out)), got)
    # a score threshold: the kept objects only; keeping none leaves the
    # contour image as it was and halves the mask image (as in JAX)
    for scores in ([0.5, 0.97, 0.1], [0.5, 0.2, 0.1]):
        kw = dict(score_thr=0.95)
        got = VisTool(scene["port_renderer"], vis_mode=mode, **kw)(
            *args, scores=np.array(scores))
        want = JaxVisTool(scene["jax_renderer"], vis_mode=mode, **kw)(
            *args, scores=np.array(scores))
        np.testing.assert_array_equal(got, want)


def test_pose_contour_and_detections_match_jax(scene):
    from scflow_torch.tools import visualize as pv
    import visualize as jv

    img, ks, pts = scene["image"], scene["ks"], scene["pts"]
    r, t, labels = scene["rots"], scene["trans"], scene["labels"]
    np.testing.assert_array_equal(
        pv.draw_pose_contour(img, scene["port_renderer"], ks[1], r[1], t[1], 1),
        jv.draw_pose_contour(img, scene["jax_renderer"], ks[1], r[1], t[1], 1))
    np.testing.assert_array_equal(pv.draw_pose_axes(img, ks[0], r[0], t[0]),
                                  jv.draw_pose_axes(img, ks[0], r[0], t[0]))
    np.testing.assert_array_equal(
        pv.draw_detections(img, r, t, pts, ks, labels=labels),
        jv.draw_detections(img, r, t, pts, ks, labels=labels))
    # with scores: equal outside each score's text, whose ink stays in
    # cv2's box grown by 2 px
    scores = np.array([0.9, 0.45, 0.07])
    got = pv.draw_detections(img, r, t, [pts] * 3, ks, labels=labels,
                             scores=scores)
    want = jv.draw_detections(img, r, t, [pts] * 3, ks, labels=labels,
                              scores=scores)
    base = jv.draw_detections(img, r, t, [pts] * 3, ks, labels=labels)
    text_box = np.zeros(img.shape[:2], bool)
    ys, xs = np.nonzero((want != base).any(-1))
    text_box[max(ys.min() - 2, 0):ys.max() + 3, max(xs.min() - 2, 0):xs.max() + 3] = True
    np.testing.assert_array_equal(got[~text_box], want[~text_box])
    assert (got[text_box] != base[text_box]).any()


TOOLS_RUN = """
import json, sys
for name in ("jax", "jaxlib", "flax", "scflow_tpu", "cv2", "PIL"):
    sys.modules[name] = None        # any import of it now raises
from scflow_torch.data.imageio import imread
from scflow_torch.tools import (browse_dataset, collect_3d_keypoints,
                                make_synthetic_bop, pose_graph_ablation,
                                train_synthetic_demo, visualize)
root, out = sys.argv[1], sys.argv[2]
cpu = ["--device", "cpu"]
make_synthetic_bop.main(["--out", root, "--num-images", "3", "--height",
                         "96", "--width", "128", "--num-classes", "3",
                         "--min-objects", "2", "--seed", "3", *cpu])
make_synthetic_bop.main(["--out", f"{root}_train", "--split", "train_real",
                         "--num-images", "2", "--height", "96", "--width",
                         "128", "--num-classes", "3", *cpu])
vis = visualize.main(["--data-root", f"{root}/test", "--ref-annots-root",
                      f"{root}/init_poses", "--image-list",
                      f"{root}/image_lists/test.txt", "--mesh-dir",
                      f"{root}/models", "--out", f"{out}/vis.png", *cpu])
pngs = [vis]
pngs += browse_dataset.main(["--synthetic", "--num", "2", "--out-dir",
                             f"{out}/browse", *cpu])
pngs += browse_dataset.main(["--data-root", f"{root}_train/train_real",
                             "--image-list",
                             f"{root}_train/image_lists/train_real.txt",
                             "--mesh-dir", f"{root}_train/models", "--patch",
                             "--num", "2", "--out-dir", f"{out}/browse_disk",
                             *cpu])
kp = collect_3d_keypoints.main(["--mesh-dir", f"{root}/models", "--out",
                                f"{out}/kp.json", "--mode", "obbox"])
# the two training tools at a small size: their fixed sizes are module
# constants (the JAX tools' values), set here before main reads them
train_synthetic_demo.BATCH_SIZE = 2
train_synthetic_demo.IMAGE_SIZE = 64
train_synthetic_demo.EVAL_BATCHES = 1
demo = train_synthetic_demo.main(["--steps", "1", "--work-dir",
                                  f"{out}/demo", *cpu])
pose_graph_ablation.BATCH_SIZE = 2
pg = pose_graph_ablation.main(["--out", f"{out}/pg/table.md", "--steps", "1",
                               "--data-root", root, "--num-classes", "3",
                               "--image-scale", "64", "--work-dir",
                               f"{out}/pg_work", *cpu])
shapes = [list(imread(p).shape) for p in pngs]
blocked = [m for m in ("cv2", "PIL", "jax") if sys.modules.get(m) is not None]
print(json.dumps(dict(shapes=shapes, pngs=pngs, kp=sorted(kp), demo=demo,
                      pg=sorted(pg), blocked=blocked)))
"""


def test_tool_mains_without_cv2_pil_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = tmp_path / "out"
    r = subprocess.run([sys.executable, "-c", TOOLS_RUN, str(tmp_path / "bop"),
                        str(out)], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["blocked"] == []
    assert res["shapes"][0] == [96, 128, 3]          # the frame
    assert res["shapes"][1:3] == [[256, 256, 3]] * 2  # synthetic panels
    assert len(res["shapes"]) >= 6                   # + disk images, patches
    assert res["kp"] == ["1", "2", "3"]
    assert all(np.isfinite(res["demo"]["before"] + res["demo"]["after"]))
    assert res["pg"] == ["camera_only", "full_graph", "plain"]
    table = (out / "pg" / "table.md").read_text()
    assert "| metric | per-object |" in table
    assert json.loads((out / "pg" / "table.json").read_text())["plain"]
