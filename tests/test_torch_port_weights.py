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
