"""The general ResNet backbone of the PyTorch port against the JAX
package's: depths 18 and 50, the plain and the V1d stem, batch norm (eval
and train mode), instance norm and group norm, every ``out_indices``. The
weights come from the port's seeded init with noise on the norms
(``perturb``), go to JAX through ``to_jax_variables`` and back through
``load_jax_variables`` exactly. Outputs agree to 1e-4 of their scale (f32
convolutions summed in another order through up to 53 layers), but for
a last stage of 2×2 planes normalised by instance norm or train-mode
batch norm (at batch 2): its norms see 4 or 8 values whose variance can
be tiny, and both packages lie 7e-4 to 4e-3 of the output scale from a
float64 run there; such an output is held to JAX's model run in float64,
within 1.5× JAX's own f32 distance from it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import nchw, nhwc, one_torch_thread, perturb  # noqa: F401
from scflow_torch.models import ResNet
from scflow_torch.models.backbone import Bottleneck
from scflow_torch.ops.fused_norm import instance_norm_fwd
from scflow_torch.weights import load_jax_variables, to_jax_variables
from scflow_tpu.models.backbone import ResNet as JaxResNet

REL = 1e-4

# (depth, deep_stem, norm, base_channels, input side, out_indices)
CASES = {
    "r18_bn": (18, False, "bn", 8, 64, (0, 1, 2, 3)),
    "r18_v1d_in": (18, True, "in", 8, 64, (1, 3)),
    "r18_gn": (18, False, "gn", 32, 32, (2,)),       # 32 groups: width ≥ 32
    "r50_in_56": (50, False, "in", 8, 56, (0, 1, 2, 3)),
    "r50_v1d_bn": (50, True, "bn", 8, 64, (3,)),
}


def assert_rel(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= REL, f"{what}: {err:.2e} of the output scale"


def tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(port ResNet with bridged weights, flax model, variables, input)."""
    depth, deep, norm, base, side, outs = CASES[request.param]
    torch.manual_seed(depth + 7 * deep)
    port = ResNet(depth, base, outs, deep, norm)
    variables = perturb(to_jax_variables(port), seed=depth)
    load_jax_variables(port, variables)
    tree_equal(to_jax_variables(port), variables)          # exact round trip
    jax_model = JaxResNet(depth=depth, base_channels=base, out_indices=outs,
                          deep_stem=deep, norm=norm)
    x = np.random.default_rng(depth).normal(
        size=(2, side, side, 3)).astype(np.float32)
    return request.param, port, jax_model, variables, x


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def float64_outputs(jax_model, variables, x, train):
    """JAX's model on ``x`` in float64."""
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        out = jax_model.apply(v64, jnp.asarray(x, jnp.float64), train=train,
                              mutable=["batch_stats"] if train else False)
        out = out[0] if train else out
        return [np.asarray(o) for o in as_tuple(out)]


def check_outputs(case, got, want, train):
    """Each stage output to 1e-4 of its scale; one of 2×2 planes whose
    norm takes statistics from the batch against the float64 witness
    (module docstring)."""
    name, _, jax_model, variables, x = case
    stats_norm = CASES[name][2] == "in" or (train and CASES[name][2] == "bn")
    witness = None
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = nhwc(g), np.asarray(w)
        if not stats_norm or g.shape[1] * g.shape[2] > 4:
            assert_rel(g, w, f"{name} out {i}")
            continue
        if witness is None:
            witness = float64_outputs(jax_model, variables, x, train)
        d = witness[i]
        scale = np.abs(d).max()
        port_err = np.abs(g - d).max() / scale
        jax_err = np.abs(w - d).max() / scale
        assert port_err <= 1.5 * jax_err + REL, (name, i, port_err, jax_err)


def test_eval_forward_matches_jax(case):
    name, port, jax_model, variables, x = case
    port.eval()
    with torch.no_grad():
        got = as_tuple(port(nchw(x)))
    want = as_tuple(jax.jit(lambda v, a: jax_model.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    assert len(got) == len(want) == len(CASES[name][5])
    check_outputs(case, got, want, train=False)


def test_train_forward_matches_jax(case):
    """Train mode: batch statistics, and the running statistics moved as
    flax moves them (eval and train are the same for in and gn)."""
    name, port, jax_model, variables, x = case
    port.train()
    with torch.no_grad():
        got = as_tuple(port(nchw(x)))
    want, state = jax.jit(lambda v, a: jax_model.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    check_outputs(case, got, as_tuple(want), train=True)
    if CASES[name][2] == "bn":
        moved = to_jax_variables(port)["batch_stats"]
        flat_j = jax.tree_util.tree_leaves_with_path(state["batch_stats"])
        flat_p = dict(jax.tree_util.tree_leaves_with_path(moved))
        for path, w in flat_j:
            np.testing.assert_allclose(flat_p[path], np.asarray(w),
                                       rtol=1e-4, atol=1e-5)
    load_jax_variables(port, variables)       # undo the statistics' move


def test_launch_count_per_forward_and_planes():
    """53 instance norms in a ResNet-50 forward with the plain stem, 55
    with V1d (16 bottlenecks × 3, 4 downsamples, the stem's 1 or 3); at a
    56² input the stages' planes are 14², 7², 4², 2²: the 196- and
    49-element planes take the kernel's general form on the card."""
    for deep, want in ((False, 53), (True, 55)):
        m = ResNet(50, 8, (0, 1, 2, 3), deep, "in")
        assert sum(1 for mod in m.modules()
                   if type(mod).__name__ == "FusedInstanceNorm") == want
    m = ResNet(50, 8, (0, 1, 2, 3), False, "in").eval()
    with torch.no_grad():
        outs = m(torch.zeros(1, 3, 56, 56))
    assert [o.shape[-1] for o in outs] == [14, 7, 4, 2]
    assert [o.shape[1] for o in outs] == [32, 64, 128, 256]
    assert instance_norm_fwd.launches == 0        # the CPU runs no kernel


def test_bottleneck_and_refusals():
    b = Bottleneck(16, 8, stride=2, norm="bn")
    names = {n for n, _ in b.named_parameters()}
    assert {"conv1.weight", "conv1.bias", "bn3.weight", "downsample.0.weight",
            "downsample.1.bias"} <= names
    assert b(torch.zeros(2, 16, 8, 8)).shape == (2, 32, 4, 4)
    with pytest.raises(ValueError):
        ResNet(depth=20)
