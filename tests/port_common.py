"""Shared set-up for the parity tests of the PyTorch port (scflow_torch)
against the JAX package (scflow_tpu): one seed, numpy inputs, both models
with the same weights."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

# f32 parity: no TF32 in convolutions or matmuls where a card is present
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

NUM_CLASS = 3
IMAGE = (64, 64)


def jax_refiner_variables(num_class: int = NUM_CLASS, image=IMAGE,
                          iters: int = 3, seed: int = 0):
    """(JAX SCFlowRefiner, its config, numpy variables) at full channel
    widths, with every init-constant leaf replaced by seeded noise (see
    :func:`perturb`)."""
    from scflow_tpu.training import Config, ModelConfig, build_model

    cfg = Config(model=ModelConfig(num_class=num_class, iters=iters,
                                   test_iters=iters))
    model = build_model(cfg)
    n, (h, w) = 2, image
    eye = jnp.tile(jnp.eye(3), (n, 1, 1))
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((n, h, w, 3)),
        jnp.zeros((n, h, w, 3)), eye,
        jnp.tile(jnp.asarray([0.0, 0.0, 600.0]), (n, 1)),
        jnp.zeros((n, h, w)), eye, jnp.zeros((n,), jnp.int32))
    return model, cfg, perturb(jax.tree.map(np.asarray, variables), seed)


def jax_raft_variables(family: str = "raft_flow_mask", image=IMAGE,
                       iters: int = 3, seed: int = 0):
    """(JAX RAFTRefiner, its config, numpy variables) for ``family`` at full
    channel widths, init-constant leaves replaced by seeded noise."""
    from scflow_tpu.training import Config, ModelConfig, build_model

    cfg = Config(model=ModelConfig(family=family, iters=iters,
                                   test_iters=iters))
    model = build_model(cfg)
    x = jnp.zeros((2, *image, 3))
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), x, x)
    return model, cfg, perturb(jax.tree.map(np.asarray, variables), seed)


def perturb(variables: dict, seed: int = 0) -> dict:
    """Seeded noise on the leaves the flax init leaves constant, so the
    bridge and the affine/statistics paths are exercised: norm scales near
    1 and biases near 0, BN running means/variances, and small pose-head
    output kernels (zero at init, which would pin the pose)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif "/norm/" in p or p.startswith("batch_stats"):
                noise = rng.normal(size=v.shape).astype(np.float32)
                if k == "var":
                    out[k] = (1.0 + 0.2 * np.abs(noise)).astype(np.float32)
                elif k == "scale":
                    out[k] = (1.0 + 0.1 * noise).astype(np.float32)
                else:
                    out[k] = (0.1 * noise).astype(np.float32)
            elif p.endswith(("rotation_pred/kernel", "translation_pred/kernel")):
                out[k] = (1e-3 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    return {col: walk(tree, col) for col, tree in variables.items()}


def port_refiner(variables: dict, num_class: int = NUM_CLASS, image=IMAGE,
                 iters: int = 3, lowres_eval: bool = True,
                 family: str = "scflow"):
    """(port refiner of ``family`` on the CPU with the bridged weights, its
    config)."""
    from scflow_torch.training import (Config, ModelConfig, RenderConfig,
                                       build_model)
    from scflow_torch.weights import load_jax_variables

    cfg = Config(model=ModelConfig(family=family, num_class=num_class,
                                   iters=iters, test_iters=iters,
                                   lowres_eval=lowres_eval),
                 render=RenderConfig(image_size=image))
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, variables)
    return model, cfg


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def random_rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3, 3) f32 rotations from normalised Gaussian quaternions."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q.T
    m = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return m.reshape(n, 3, 3).astype(np.float32)

