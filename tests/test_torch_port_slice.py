"""The port's inference slice end to end against the JAX package.

JAX ``make_eval_step`` (Renderer with the Pallas tile rasterizer, run in
interpret mode on the CPU) and the port's eval step on ``device="cpu"``
(the plain versions of both kernels) take the same synthetic batch — 64²
crops, 3 classes, batch 2, real images as uint8 — and the same weights
(JAX init with seeded noise, bridged into the port). Tolerances are those
of the JAX package's own oracle test of the decoder (rotations atol 2e-3;
translations rtol 2e-3, atol 2e-4): the port's f32 arithmetic differs from
XLA's in summation order only, and that error compounds over iterations.
"""
import jax
import numpy as np
import pytest

from port_common import IMAGE, NUM_CLASS, jax_refiner_variables, port_refiner
from port_common import one_torch_thread  # noqa: F401 (autouse)

ITERS = 3
RADIUS = 20.0        # mesh radius (mm) that keeps the object inside 64²


@pytest.fixture(scope="module")
def setup():
    from scflow_tpu.data import synthetic_batch
    from scflow_tpu.rendering import Renderer, make_test_meshes

    model, cfg, variables = jax_refiner_variables(iters=ITERS)
    renderer = Renderer(make_test_meshes(num_classes=NUM_CLASS,
                                         subdivisions=2, radius=RADIUS),
                        image_size=IMAGE, rasterizer="pallas")
    batch = jax.tree.map(np.asarray, synthetic_batch(
        jax.random.PRNGKey(3), renderer, 2))
    batch["real_images"] = np.round(batch["real_images"] * 255).astype(np.uint8)
    return model, cfg, variables, renderer, batch


def _jax_step(setup, lowres: bool, passes: int):
    import dataclasses

    from scflow_tpu.training import make_eval_step
    from scflow_tpu.training.steps import make_multi_pass_eval_step

    model, cfg, variables, renderer, batch = setup
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, lowres_eval=lowres))
    if passes == 1:
        step = make_eval_step(model, renderer, cfg)
    else:
        step = make_multi_pass_eval_step(model, renderer, cfg, passes=passes)
    out = step(variables["params"], variables["batch_stats"], batch)
    return jax.tree.map(np.asarray, out)


def _port_step(setup, lowres: bool, passes: int):
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import make_eval_step, make_multi_pass_eval_step

    _, _, variables, _, batch = setup
    model, cfg = port_refiner(variables, iters=ITERS, lowres_eval=lowres)
    renderer = Renderer(make_test_meshes(num_classes=NUM_CLASS,
                                         subdivisions=2, radius=RADIUS,
                                         device="cpu"), image_size=IMAGE)
    if passes == 1:
        step = make_eval_step(model, renderer, cfg, device="cpu")
    else:
        step = make_multi_pass_eval_step(model, renderer, cfg, passes=passes,
                                         device="cpu")
    return {k: v.numpy() for k, v in step(batch).items()}


@pytest.mark.parametrize("lowres,passes", [(True, 1), (False, 1), (True, 2)],
                         ids=["lowres", "fullres", "lowres-2pass"])
def test_eval_step_matches_jax(setup, lowres, passes):
    want = _jax_step(setup, lowres, passes)
    got = _port_step(setup, lowres, passes)
    batch = setup[4]
    # the pose moved, so the comparison is not of two unrefined poses
    assert np.abs(want["translations"] - batch["ref_translations"]).max() > 1e-2
    np.testing.assert_allclose(got["rotations"], want["rotations"], atol=2e-3)
    np.testing.assert_allclose(got["translations"], want["translations"],
                               rtol=2e-3, atol=2e-4)
    # rendered depth at the (last pass's) reference pose; the dense maps
    # at the oracle test's mask tolerance
    np.testing.assert_allclose(got["depth"], want["depth"], atol=1e-3)
    np.testing.assert_allclose(got["flow"], want["flow"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got["masks"], want["masks"], atol=1e-3)
