"""Port parity: each layer block of `pl_yolo_tpu_torch.layers.blocks` against
its flax counterpart in eval mode, fp32, on the CPU.

The same weights (random, with non-trivial BatchNorm statistics) move from
flax to torch through the bridge; the same seeded numpy input goes to both.
Tolerance rtol=atol=1e-5: both sides compute in fp32 and differ only in the
order of the convolution sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.layers import blocks as jb
from pl_yolo_tpu_torch.bridge import load_variables
from pl_yolo_tpu_torch.layers import blocks as tb

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fp32_compute():
    """The JAX package's compute dtype is global state that other code
    (build_model of a bf16 config) sets; these tests run fp32."""
    prev = jb.get_compute_dtype()
    jb.set_compute_dtype(None)
    yield
    jb.set_compute_dtype(prev)


def _randomize(variables, rng):
    """Replace every leaf with seeded values; BN variances stay positive."""
    def leaf(path, x):
        name = path[-1].key
        if name == "var":
            v = rng.uniform(0.5, 2.0, x.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name in ("mean", "bias"):
            v = rng.normal(0.0, 0.1, x.shape)
        else:  # kernel: unit-variance outputs
            v = rng.normal(0.0, np.sqrt(1.0 / np.prod(x.shape[:-1])), x.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


# (name, flax module, torch module, input channels, spatial size)
CASES = {
    "conv3x3": (lambda: jb.ConvBlock(12, ksize=3),
                lambda: tb.ConvBlock(8, 12, 3), 8, 16),
    "conv1x1": (lambda: jb.ConvBlock(12, ksize=1),
                lambda: tb.ConvBlock(8, 12, 1), 8, 16),
    "conv3x3_s2": (lambda: jb.ConvBlock(12, ksize=3, stride=2),
                   lambda: tb.ConvBlock(8, 12, 3, stride=2), 8, 16),
    "conv_no_norm_lrelu": (lambda: jb.ConvBlock(12, ksize=3, norm=None,
                                                act="lrelu"),
                           lambda: tb.ConvBlock(8, 12, 3, norm=None,
                                                act="lrelu"), 8, 16),
    "dwconv": (lambda: jb.DWConvBlock(12, ksize=3, stride=2),
               lambda: tb.DWConvBlock(8, 12, 3, stride=2), 8, 16),
    "focus_fused": (lambda: jb.Focus(16, ksize=3),
                    lambda: tb.Focus(3, 16, ksize=3), 3, 32),
    "focus_s2d": (lambda: jb.Focus(16, ksize=3, fused=False),
                  lambda: tb.Focus(3, 16, ksize=3, fused=False), 3, 32),
    "bottleneck": (lambda: jb.Bottleneck(8, expansion=1.0),
                   lambda: tb.Bottleneck(8, 8, expansion=1.0), 8, 16),
    "bottleneck_dw": (lambda: jb.Bottleneck(8, depthwise=True),
                      lambda: tb.Bottleneck(8, 8, depthwise=True), 8, 16),
    "csp": (lambda: jb.CSPLayer(16, num_bottle=2),
            lambda: tb.CSPLayer(8, 16, num_bottle=2), 8, 16),
    "csp_no_shortcut": (lambda: jb.CSPLayer(16, shortcut=False),
                        lambda: tb.CSPLayer(8, 16, shortcut=False), 8, 16),
    "spp": (lambda: jb.SPPBottleneck(16),
            lambda: tb.SPPBottleneck(16, 16), 16, 16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_flax(name):
    make_j, make_t, cin, size = CASES[name]
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (2, size, size, cin)).astype(np.float32)
    jmod = make_j()
    variables = _randomize(jmod.init(jax.random.key(0), jnp.asarray(x), False),
                           rng)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    tmod = load_variables(make_t(), variables).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["silu", "relu", "lrelu", "hswish",
                                  "hsigmoid", "gelu", "sigmoid", "identity",
                                  None])
def test_activation_matches_flax(name):
    x = np.random.default_rng(1).uniform(-6, 6, (64,)).astype(np.float32)
    want = np.asarray(jb.get_activation(name)(jnp.asarray(x)))
    got = tb.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fn", ["space_to_depth", "upsample_nearest_2x",
                                "max_pool_same"])
def test_layout_ops_match_jax(fn):
    x = np.random.default_rng(2).normal(size=(2, 8, 6, 3)).astype(np.float32)
    jfn, tfn = getattr(jb, fn), getattr(tb, fn)
    if fn == "max_pool_same":
        jfn, tfn = (lambda a: jb.max_pool_same(a, 5)), (lambda a: tb.max_pool_same(a, 5))
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_focus_forms_agree_in_torch():
    """The fused 6x6 eval form and the s2d train form share one param tree
    and compute the same function."""
    torch.manual_seed(0)
    m = tb.Focus(3, 8, ksize=3).eval()
    x = torch.rand(1, 3, 16, 16) * 255
    with torch.no_grad():
        fused = m(x)
        plain = m.conv(tb.space_to_depth(x))
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-4)


def test_bf16_compute_keeps_fp32_params():
    m = tb.ConvBlock(4, 8, 3, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        y = m(torch.rand(1, 4, 8, 8))
    assert y.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())
