"""The port's logging, metric and profiling utilities against the JAX
package, on the CPU, on seeded numpy inputs: ``endpoint_error``,
``add_error`` / ``adds_error``, ``MetricAccumulator``, ``flow_to_rgb``,
``make_train_panel``, ``sequence_epe_report``, the TensorBoard event
writer (its bytes) and the port's own PNG encoder (decoded with PIL),
``PhaseTimer`` and ``trace``."""
import io
import json
import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from port_common import random_rotations

# f32 sums of a few terms in another order: a few ulps
F32_RTOL = 1e-5


def _flows(rng, n=2, h=16, w=20):
    pred = rng.normal(scale=4.0, size=(n, h, w, 2)).astype(np.float32)
    gt = (pred + rng.normal(scale=2.0, size=pred.shape)).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("valid", ["none", "bool", "float"])
def test_endpoint_error_matches_jax(valid):
    """EPE and 1/3/5-px accuracies within rtol 1e-5 (f32 norms and sums)."""
    from scflow_torch.geometry import endpoint_error
    from scflow_tpu.geometry.flow import endpoint_error as jax_epe

    rng = np.random.default_rng(0)
    pred, gt = _flows(rng)
    v = {"none": None,
         "bool": rng.random(pred.shape[:-1]) < 0.6,
         "float": (rng.random(pred.shape[:-1]) < 0.6).astype(np.float32)}[valid]
    got = endpoint_error(torch.from_numpy(pred), torch.from_numpy(gt),
                         None if v is None else torch.from_numpy(v))
    want = jax_epe(jnp.asarray(pred), jnp.asarray(gt),
                   None if v is None else jnp.asarray(v))
    assert set(got) == set(want) == {"epe", "acc1", "acc3", "acc5"}
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=F32_RTOL, err_msg=k)


def _poses(rng, n):
    r = random_rotations(rng, n)
    t = np.concatenate([rng.uniform(-30, 30, (n, 2)),
                        rng.uniform(500, 900, (n, 1))], 1).astype(np.float32)
    return r, t


@pytest.mark.parametrize("case", ["apart", "near", "equal"])
def test_add_and_adds_error_match_jax(case):
    """ADD and ADD-S of 4 samples, 96 points in a 60 mm ball, with the pred
    pose apart from the GT (a random pose), near it (0.5°, 0.3 mm) or equal
    to it.

    ADD: rtol 1e-5 (f32 norms and means). ADD-S uses the dense form |a|² +
    |b|² − 2a·b at ~600 mm from the camera: f32 rounds each squared
    distance at the scale s = 2⁻²³·(|a|² + |b|² + 2|a||b|) ≈ 0.17 mm², so
    a nearest distance d carries an error up to ~s/(2d), or √s ≈ 0.4 mm
    when d is near 0. Both packages are held to a float64 witness (the
    exact nearest distances) within 2√s per sample mean, and to each other
    within rtol 1e-5 + 2√s."""
    from scflow_torch.geometry import (add_error, adds_error,
                                       axis_angle_to_matrix)
    from scflow_tpu.geometry.se3 import add_error as jax_add
    from scflow_tpu.geometry.se3 import adds_error as jax_adds

    rng = np.random.default_rng({"apart": 1, "near": 2, "equal": 3}[case])
    n, p = 4, 96
    r_gt, t_gt = _poses(rng, n)
    pts = rng.normal(size=(n, p, 3))
    pts = (60.0 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
           * rng.random((n, p, 1)) ** (1 / 3)).astype(np.float32)
    if case == "apart":
        r_pr, t_pr = _poses(rng, n)
    elif case == "near":
        axis = rng.normal(size=(n, 3))
        axis *= np.deg2rad(0.5) / np.linalg.norm(axis, axis=-1, keepdims=True)
        dr = axis_angle_to_matrix(torch.from_numpy(axis)).numpy()
        r_pr = (dr @ r_gt).astype(np.float32)
        t_pr = (t_gt + rng.normal(scale=0.3, size=t_gt.shape)).astype(
            np.float32)
    else:
        r_pr, t_pr = r_gt.copy(), t_gt.copy()
    args = (r_pr, t_pr, r_gt, t_gt, pts)
    got_add = add_error(*map(torch.from_numpy, args)).numpy()
    got_adds = adds_error(*map(torch.from_numpy, args)).numpy()
    want_add = np.asarray(jax_add(*map(jnp.asarray, args)))
    want_adds = np.asarray(jax_adds(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got_add, want_add, rtol=F32_RTOL, atol=1e-6)

    a = np.einsum("nij,npj->npi", r_gt.astype(np.float64), pts) + t_gt[:, None]
    b = np.einsum("nij,npj->npi", r_pr.astype(np.float64), pts) + t_pr[:, None]
    exact = np.linalg.norm(a[:, :, None] - b[:, None], axis=-1).min(-1).mean(-1)
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    s = 2.0 ** -23 * (na.max(1) + nb.max(1)) ** 2
    for name, v in (("port", got_adds), ("jax", want_adds)):
        assert (np.abs(v - exact) <= 2 * np.sqrt(s)).all(), (name, v, exact)
    assert (np.abs(got_adds - want_adds)
            <= F32_RTOL * np.abs(want_adds) + 2 * np.sqrt(s)).all()
    assert (got_adds <= got_add + 2 * np.sqrt(s)).all()


def test_metric_accumulator_matches_jax():
    """Two updates (one with padded slots) of seeded errors spanning the
    thresholds and the histogram's range (and beyond it): equal count,
    threshold and histogram states, equal metric dicts (AUC within 1e-12:
    the same numpy arithmetic on equal counts); merge sums."""
    from scflow_torch.parallel import MetricAccumulator
    from scflow_tpu.parallel.collect import MetricAccumulator as JaxAcc

    rng = np.random.default_rng(4)
    acc, jacc = MetricAccumulator(num_classes=4), JaxAcc(num_classes=4)
    state, jstate = acc.init("cpu"), jacc.init()
    for valid in (None, (rng.random(24) < 0.7).astype(np.float32)):
        labels = rng.integers(0, 3, 24).astype(np.int32)     # class 3 absent
        diam = rng.uniform(80, 250, 24).astype(np.float32)
        err = (diam * rng.uniform(0, 0.7, 24)).astype(np.float32)
        err[:3] = (0.0, 99.99, 150.0)
        tv = None if valid is None else torch.from_numpy(valid)
        state = acc.update(state, torch.from_numpy(labels),
                           torch.from_numpy(err), torch.from_numpy(diam), tv)
        jstate = jacc.update(jstate, jnp.asarray(labels), jnp.asarray(err),
                             jnp.asarray(diam),
                             None if valid is None else jnp.asarray(valid))
    for k in jstate:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]),
                                      err_msg=k)
    got, want = acc.compute(state), jacc.compute(jstate)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert got["num_instances"] > 0 and "cls_3/auc" not in got
    merged = acc.merge([state, state])
    for k in state:
        assert torch.equal(merged[k], 2 * state[k])


def test_flow_to_rgb_and_train_panel_match_jax():
    """flow_to_rgb (invalid sentinel and non-finite pixels black) and the
    uint8 train panel are the JAX package's exactly: the same numpy code."""
    from scflow_torch.training.logging import make_train_panel
    from scflow_torch.utils.flow_vis import flow_to_rgb
    from scflow_tpu.training.logging import make_train_panel as jax_panel
    from scflow_tpu.utils.flow_vis import flow_to_rgb as jax_rgb

    rng = np.random.default_rng(5)
    flows = [rng.normal(scale=20, size=(12, 16, 2)).astype(np.float32)
             for _ in range(3)]
    flows[0][:3] = 400.0
    flows[1][0, 0] = np.nan
    np.testing.assert_array_equal(flow_to_rgb(flows[0]), jax_rgb(flows[0]))
    np.testing.assert_array_equal(flow_to_rgb(flows[1]), jax_rgb(flows[1]))
    assert (flow_to_rgb(flows[0])[:3] == 0).all()
    imgs = [rng.random((12, 16, 3)).astype(np.float32) for _ in range(2)]
    mask = rng.random((12, 16)).astype(np.float32)
    got = make_train_panel(*imgs, *flows, mask=mask)
    np.testing.assert_array_equal(got, jax_panel(*imgs, *flows, mask=mask))
    assert got.shape == (12, 16 * 6, 3) and got.dtype == np.uint8


def test_sequence_epe_report_matches_jax():
    from scflow_torch.training.logging import sequence_epe_report
    from scflow_tpu.training.logging import sequence_epe_report as jax_report

    rng = np.random.default_rng(6)
    seq = rng.normal(scale=3, size=(3, 2, 8, 8, 2)).astype(np.float32)
    gt = rng.normal(scale=3, size=(2, 8, 8, 2)).astype(np.float32)
    gt[0, :2] = 400.0                                 # beyond max_flow
    valid = rng.random((2, 8, 8)).astype(np.float32)
    got = sequence_epe_report(torch.from_numpy(seq), torch.from_numpy(gt),
                              torch.from_numpy(valid))
    want = jax_report(jnp.asarray(seq), jnp.asarray(gt), jnp.asarray(valid))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=F32_RTOL, err_msg=k)


def _records(path: str) -> list[bytes]:
    from scflow_torch.utils.tb_writer import _masked_crc

    out = []
    with open(path, "rb") as f:
        while header := f.read(8):
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header) and dcrc == _masked_crc(data)
            out.append(data)
    return out


def test_tb_event_writer_matches_jax(tmp_path, monkeypatch):
    """With the clock fixed, the port's event file of a scalar and a
    scalars record is the JAX writer's byte for byte (TFRecord framing,
    masked CRC32C, Event/Summary wire format). An image record differs only
    in its PNG bytes: the port's PNG and the JAX package's (cv2 or PIL)
    decode with PIL to the same pixels."""
    from scflow_torch.utils.tb_writer import TBEventWriter, crc32c
    from scflow_tpu.utils.tb_writer import TBEventWriter as JaxWriter

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    paths = []
    for cls, name in ((TBEventWriter, "port"), (JaxWriter, "jax")):
        w = cls(str(tmp_path / name))
        w.add_scalar("loss", 1.5, step=10)
        w.add_scalars({"a": 2.0, "b": -3.25, "lr": 4e-4}, step=11)
        w.close()
        paths.append(w.path)
    assert paths[0].rsplit("/", 1)[1] == paths[1].rsplit("/", 1)[1]
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f0.read() == f1.read()
    assert crc32c(b"123456789") == 0xE3069283        # RFC 3720 §B.4

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    pngs = []
    for cls, name in ((TBEventWriter, "port_img"), (JaxWriter, "jax_img")):
        w = cls(str(tmp_path / name))
        w.add_image("panel", img, step=3)
        w.close()
        rec = _records(w.path)[1]
        start = rec.index(b"\x89PNG")
        pngs.append(rec[start:])
    for png in pngs:
        with Image.open(io.BytesIO(png)) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), img)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (6, 4, 3), (3, 8, 4)])
def test_png_encoder_decodes_to_its_pixels(shape, tmp_path):
    """encode_png (stdlib zlib + struct) for gray, RGB and RGBA: PIL reads
    back the same pixels; ImageLogger writes the same bytes to disk."""
    from scflow_torch.training.logging import ImageLogger
    from scflow_torch.utils.tb_writer import encode_png

    img = np.random.default_rng(8).integers(0, 256, shape, dtype=np.uint8)
    png = encode_png(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", png[16:24]) == (shape[1], shape[0])
    want = img if len(shape) == 3 and shape[2] > 1 else img.reshape(shape[:2])
    with Image.open(io.BytesIO(png)) as im:
        np.testing.assert_array_equal(np.asarray(im), want)
    if img.ndim == 3 and shape[2] == 3:
        logger = ImageLogger(str(tmp_path), tensorboard=False)
        logger.log_panel(4, "p", img)
        assert (tmp_path / "images" / "p_00000004.png").read_bytes() == png
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


def test_phase_timer_and_trace(tmp_path):
    """PhaseTimer accumulates per-phase means; trace writes a Chrome trace
    holding the block's ops."""
    from scflow_torch.utils.profiling import PhaseTimer, trace

    timer = PhaseTimer()
    for _ in range(2):
        with timer("matmul"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert timer.counts["matmul"] == 2 and timer.summary()["matmul"] > 0
    assert timer.report().startswith("matmul: ")
    with trace(str(tmp_path)):
        torch.ones(8, 8).sum()
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
