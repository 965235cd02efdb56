"""Port parity: the plug-in attention registry of `pl_yolo_tpu_torch`
(`layers/attention*.py`, 44 modules) against the JAX package's on the
CPU, on seeded numpy inputs: every entry's forward, input gradient and
parameter gradients; the BatchNorms that train and the two that never do;
`build_attention`; the bridge's 1-D conv kernels, the attention layers'
3-D kernels and SGE's free `weight` / `bias`.

Each module maps a seeded [2,8,8,16] map (`fca` a [2,8,8,64] one, as
tests/test_attention.py does: its SE bottleneck is c/16 wide); its
parameters and BN statistics are seeded values off their init, shared
through the bridge, whose tree is held to the one a flax init makes. The
gradients are of sum(out · cot) for a seeded cotangent. The JAX side is
jitted (its eager ops compile one by one).

Tolerance: TOL (1e-4) of each tensor's scale, max |JAX|: fp32 softmaxes,
norms and sums over up to 64 tokens in another order; the worst measured
on the CPU is in the comment at TOL. A gradient that is zero in exact
arithmetic is rounding noise of the terms that cancel in it (A2's `convB`
bias: a softmax over the pixels ignores a shift of all of them), so a
gradient's scale has a floor of 1e-2 of the module's largest gradient. A
wrong axis, scale or padding moves a tensor by O(1) of its scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.layers import attention as ja
from pl_yolo_tpu_torch import bridge
from pl_yolo_tpu_torch.layers import attention as ta
from pl_yolo_tpu_torch.layers.attention_extra import (
    MultiHeadDotProductAttention)

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

# the JAX references compile at XLA's backend optimization level 0: the
# same functions, compiled in about three quarters of the time (results
# within an ulp or so of level 2's)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

SHAPE, SIZE = (2, 8, 8, 16), (8, 8)
# worst max |port - JAX| / scale measured on the CPU over the 44 entries:
# 2.8e-5 (EMSA's parameter gradients, through its instance norm of the
# softmax), then CoAtNet 1.7e-5 and AFT 1.3e-5, the rest under 1e-5
TOL = 1e-4
NAMES = sorted(ja.ATTENTION)
# the modules whose BatchNorms normalise by the batch and update their
# statistics in train mode (flax `train=True`)
BN_TRAINING = ("bam", "coatnet", "cot", "parnet", "sk")
# BatchNorms on their running statistics in both modes
BN_FROZEN = ("coordatt", "triplet")


def _channels(name):
    return 64 if name == "fca" else SHAPE[-1]


def _inputs(name):
    rng = np.random.default_rng(NAMES.index(name))
    shape = SHAPE[:-1] + (_channels(name),)
    x = rng.normal(size=shape).astype(np.float32)
    xs = ([x, rng.normal(size=shape).astype(np.float32)] if name == "skff"
          else x)
    return xs, rng


def _randomized(tmod, jmod, xs, rng):
    """`tmod`'s parameters and statistics set to seeded values (kernels of
    unit-variance outputs, norms' scales and statistics, biases and free
    parameters off their init), returned as flax variables whose tree is
    the one a flax init of `jmod` on `xs` makes."""
    got = bridge.state_dict_to_variables(tmod.state_dict(), tmod)
    got = {k: v for k, v in got.items() if v}

    def leaf(path, v):
        name = path[-1].key
        if name == "kernel":
            fan_in = max(1, int(np.prod(v.shape[:-1])))
            return rng.normal(0.0, fan_in ** -0.5, v.shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, v.shape)
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, v.shape)
        return rng.normal(0.0, 0.5, v.shape)  # the free parameters
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: leaf(p, v).astype(np.float32), got)
    want = jax.eval_shape(lambda k: jmod.init(k, xs), jax.random.key(0))
    assert jax.tree.map(lambda v: v.shape, dict(want)) == jax.tree.map(
        np.shape, variables)
    bridge.load_variables(tmod, variables)
    return variables


def _assert_close(got, want, what, floor=1e-6):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=TOL * scale, err_msg=what)


def _pair(name):
    """The module in both packages from the same seeded values, its input
    and a cotangent."""
    xs, rng = _inputs(name)
    jmod = ja.build_attention(name)
    tmod = ta.build_attention(name, _channels(name), size=SIZE)
    variables = _randomized(tmod, jmod, jax.tree.map(jnp.asarray, xs), rng)
    out_shape = jax.eval_shape(lambda: jmod.apply(variables, xs)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)
    return jmod, tmod, variables, xs, cot


def _torch_in(xs):
    if isinstance(xs, list):
        return [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
    return torch.from_numpy(xs.copy()).requires_grad_()


@pytest.mark.parametrize("name", NAMES)
def test_attention_forward_and_gradients_match_jax(name):
    """Eval mode: the output, the input's gradient and every parameter's
    gradient (mapped to the flax tree by the bridge) at TOL."""
    jmod, tmod, variables, xs, cot = _pair(name)
    params = variables["params"] if "params" in variables else {}
    rest = {k: v for k, v in variables.items() if k != "params"}

    @_jit
    def jax_side(params, xs, cot):
        def f(p, u):
            return jmod.apply({"params": p, **rest} if p else rest, u)
        out, vjp = jax.vjp(f, params, xs)
        return (out,) + vjp(cot)
    want, gparams, gx = jax_side(params, jax.tree.map(jnp.asarray, xs),
                                 jnp.asarray(cot))

    tmod.eval()
    x_t = _torch_in(xs)
    out = tmod(x_t)
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_close(out.detach(), want, f"{name}: output")
    floor = 1e-2 * max(float(np.abs(np.asarray(g)).max())
                       for g in jax.tree.leaves((gx, gparams)))
    for i, (g, w) in enumerate(zip(jax.tree.leaves(x_t),
                                   jax.tree.leaves(gx))):
        _assert_close(g.grad, w, f"{name}: input gradient {i}", floor)
    grads = {k: p.grad for k, p in tmod.named_parameters()}
    assert all(g is not None for g in grads.values()), name
    got = dict(bridge._flatten(bridge.state_dict_to_variables(
        grads, tmod)["params"]))
    want_g = dict(bridge._flatten(jax.device_get(gparams)))
    assert set(got) == set(want_g), name
    for path, w in want_g.items():
        _assert_close(got[path], w, f"{name}: gradient of {'/'.join(path)}",
                      floor)


@pytest.mark.parametrize("name", BN_TRAINING)
def test_attention_train_forward_and_running_stats_match_jax(name):
    """Train mode: the batch statistics normalise (BAM's channel branch
    over B = 2 values a channel) and the running statistics take flax's
    momentum 0.99 and biased variance, at TOL."""
    jmod, tmod, variables, xs, _ = _pair(name)
    want, mutated = _jit(lambda v, x: jmod.apply(
        v, x, True, mutable=["batch_stats"]))(variables, jnp.asarray(xs))
    with torch.no_grad():
        got = tmod.train()(torch.from_numpy(xs))
    _assert_close(got, want, f"{name}: train output")
    stats = dict(bridge._flatten(bridge.state_dict_to_variables(
        tmod.state_dict(), tmod)["batch_stats"]))
    want_stats = dict(bridge._flatten(jax.device_get(mutated["batch_stats"])))
    assert set(stats) == set(want_stats) and want_stats
    for path, w in want_stats.items():
        assert not np.array_equal(w, bridge._flatten(
            variables["batch_stats"])[path]), path
        _assert_close(stats[path], w, f"{name}: {'/'.join(path)}")
    for m in tmod.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert (m.eps, m.momentum) == (1e-5, 0.01)


@pytest.mark.parametrize("name", BN_FROZEN)
def test_attention_frozen_batch_norm_ignores_train_mode(name):
    """CoordAtt's and Triplet's BatchNorms keep `use_running_average=True`:
    the port in train mode gives JAX's output and moves no statistic."""
    jmod, tmod, variables, xs, _ = _pair(name)
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    want = _jit(jmod.apply)(variables, jnp.asarray(xs))
    with torch.no_grad():
        got = tmod.train()(torch.from_numpy(xs))
    _assert_close(got, want, f"{name}: train output")
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_registry_names_equal_the_jax_packages():
    assert sorted(ta.ATTENTION) == NAMES and len(NAMES) == 44


def test_build_attention_none_and_unknown():
    """None and 'none' build nothing; an unknown name raises JAX's
    KeyError, message and all; a size-dependent entry without its size
    raises."""
    for name in (None, "none"):
        assert ta.build_attention(name) is None
    with pytest.raises(KeyError) as want:
        ja.build_attention("nope")
    with pytest.raises(KeyError) as got:
        ta.build_attention("nope", 16)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="size"):
        ta.build_attention("aft", 16)
    assert isinstance(ta.build_attention("aft", 16, size=(4, 4)), ta.AFTFull)


@pytest.mark.parametrize("name", ["eca", "muse", "sge", "mobilevit"])
def test_bridge_round_trips_conv1d_dense_general_and_free_weights(name):
    """The state_dict goes to flax variables and back unchanged; a 1-D
    conv's and an attention layer's 3-D kernels are the torch weights with
    their axes reversed; SGE's free `weight` [1,1,1,g] keeps its layout
    (with the module; without one a 4-D `weight` is a conv kernel)."""
    tmod = ta.build_attention(name, SHAPE[-1], size=SIZE)
    with torch.no_grad():
        for p in tmod.parameters():
            p.normal_()
    sd = tmod.state_dict()
    variables = bridge.state_dict_to_variables(sd, tmod)
    back = bridge.variables_to_state_dict(variables, tmod)
    assert set(back) == set(sd)
    for key, t in sd.items():
        assert torch.equal(back[key], t), key
    params = variables["params"]
    if name == "eca":
        assert params["conv"]["kernel"].shape == (3, 1, 1)
        np.testing.assert_array_equal(params["conv"]["kernel"][:, 0, 0],
                                      sd["conv.weight"][0, 0].numpy())
    elif name == "muse":
        assert params["dw5"]["kernel"].shape == (5, 1, SHAPE[-1])
        np.testing.assert_array_equal(
            params["dw5"]["kernel"], sd["dw5.weight"].numpy().transpose())
    elif name == "sge":
        np.testing.assert_array_equal(params["weight"], sd["weight"].numpy())
        assert params["weight"].shape == (1, 1, 1, 8)
        no_module = bridge.state_dict_to_variables(sd)["params"]
        assert "weight" not in no_module and no_module["kernel"].shape == (
            1, 8, 1, 1)
    else:
        attn = tmod.attn0
        assert isinstance(attn, MultiHeadDotProductAttention)
        assert params["attn0"]["query"]["kernel"].shape == (64, 4, 16)
        assert params["attn0"]["out"]["kernel"].shape == (4, 16, 64)
        np.testing.assert_array_equal(
            params["attn0"]["out"]["kernel"],
            attn.out.weight.detach().numpy().transpose(2, 1, 0))
