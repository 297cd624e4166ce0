"""Weight bridge of the PyTorch port: flax variables → scflow_torch and back.

``load_jax_variables`` fills the port from a JAX ``SCFlowRefiner.init``;
the JAX package's own torch-checkpoint converter then reads the port's
``state_dict`` (its parameter names are the reference torch ones) and must
give back every flax leaf bit for bit."""
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from port_common import jax_refiner_variables, port_refiner
from scflow_tpu.training.checkpoint import (convert_torch_checkpoint,
                                            merge_converted)


@pytest.fixture(scope="module")
def bridged():
    _, _, variables = jax_refiner_variables()
    model, _ = port_refiner(variables)
    return variables, model


def test_round_trip_is_bit_exact(bridged):
    variables, model = bridged
    converted = convert_torch_checkpoint(model.state_dict())
    merged, report = merge_converted(variables, converted, allow_missing=False)
    assert not report["unused"] and not report["missing"]
    for col in variables:
        want = flatten_dict(variables[col], sep="/")
        got = flatten_dict(merged[col], sep="/")
        assert set(got) == set(want)
        for k, v in want.items():
            g = np.asarray(got[k])
            assert g.dtype == v.dtype and np.array_equal(g, v), f"{col}/{k}"


def test_reference_parameter_names(bridged):
    _, model = bridged
    names = set(model.state_dict())
    for key in ("render_encoder.conv1.weight", "render_encoder.in1.weight",
                "render_encoder.res_layer1.0.conv1.weight",
                "context.bn1.running_var", "decoder.gru.conv_z.0.conv.weight",
                "decoder.pose_pred.conv_layers.0.gn.weight",
                "decoder.pose_pred.fc_layers.0.0.weight"):
        assert key in names, key


@pytest.mark.parametrize("drop", [
    "params/decoder/iteration/gru/conv_q_1/bias",
    "batch_stats/context/stem/norm/mean",
])
def test_missing_leaf_raises(bridged, drop):
    variables, model = bridged
    col, path = drop.split("/", 1)
    flat = flatten_dict(variables[col], sep="/")
    del flat[path]
    from flax.traverse_util import unflatten_dict
    from scflow_torch.weights import load_jax_variables

    broken = dict(variables, **{col: unflatten_dict(flat, sep="/")})
    with pytest.raises(KeyError):
        load_jax_variables(model, broken)


def test_unused_leaf_raises(bridged):
    variables, model = bridged
    from scflow_torch.weights import load_jax_variables

    extra = dict(variables, params=dict(variables["params"],
                                        stray={"kernel": np.zeros(3)}))
    with pytest.raises(KeyError, match="stray"):
        load_jax_variables(model, extra)


def test_to_jax_variables_inverts_the_bridge(bridged):
    """``to_jax_variables`` gives back every flax leaf of the bridged
    variables, batch_stats included, bit for bit; loading its output into
    a fresh port model reproduces the model's state bit for bit."""
    from scflow_torch.training import Config, ModelConfig, RenderConfig, build_model
    from scflow_torch.weights import load_jax_variables, to_jax_variables

    variables, model = bridged
    back = to_jax_variables(model)
    assert set(back) == set(variables)
    for col in variables:
        want = flatten_dict(variables[col], sep="/")
        got = flatten_dict(back[col], sep="/")
        assert set(got) == set(want), col
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    fresh = build_model(Config(model=ModelConfig(num_class=3, iters=3),
                               render=RenderConfig(image_size=(64, 64))),
                        device="cpu", seed=1)
    load_jax_variables(fresh, back)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(fresh.state_dict()[k].numpy(), v.numpy()), k


def test_to_jax_variables_reads_gradients(bridged):
    import torch

    from scflow_torch.weights import to_jax_variables

    _, model = bridged
    with pytest.raises(ValueError, match="no gradient"):
        to_jax_variables(model, grad=True)
    for i, p in enumerate(model.parameters()):
        p.grad = torch.full_like(p, float(i))
    try:
        grads = flatten_dict(to_jax_variables(model, grad=True)["params"],
                             sep="/")
        values = flatten_dict(to_jax_variables(model)["params"], sep="/")
        assert set(grads) == set(values)
        for k, v in grads.items():
            assert v.shape == values[k].shape and len(np.unique(v)) == 1, k
    finally:
        model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("family", ["raft_flow_mask", "raft_flow"])
def test_raft_bridge(family):
    """RAFT: ``load_jax_variables`` then ``to_jax_variables`` gives back a
    flax ``RAFTRefiner``'s variables bit for bit (``mask_pred`` is the
    576-channel ``up_mask_head``, ``occlusion_pred`` the ``occ_head``), and
    the JAX package's converter (``family="raft"``) reads the port's
    ``state_dict`` with nothing missing or unused."""
    from port_common import jax_raft_variables
    from scflow_torch.weights import to_jax_variables

    _, _, variables = jax_raft_variables(family)
    model, _ = port_refiner(variables, family=family)
    assert model.decoder.mask_pred.predict_layer.out_channels == 576
    assert (model.decoder.occlusion_pred is not None) == (
        family == "raft_flow_mask")
    back = to_jax_variables(model)
    for col in variables:
        want = flatten_dict(variables[col], sep="/")
        got = flatten_dict(back[col], sep="/")
        assert set(got) == set(want), col
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    converted = convert_torch_checkpoint(model.state_dict(), family="raft")
    merged, report = merge_converted(variables, converted, allow_missing=False)
    assert not report["missing"] and not report["unused"]
    for col in variables:
        for k, v in flatten_dict(variables[col], sep="/").items():
            assert np.array_equal(np.asarray(flatten_dict(
                merged[col], sep="/")[k]), v), f"{col}/{k}"
