"""Port parity: the mobile backbones of `pl_yolo_tpu_torch` (the sandglass
block, the mobile CSP and ELAN-sandglass layers, CSPMobileNext, ECMNet,
MobileNetV3-S/L with its squeeze-excite, ShuffleNetV2 with and without
its SE), the AL-PAFPN neck and its bicubic 2x upsampling, the tiny e-YOLOX
through serving and training, and the five `e-yolox_*` YAMLs, against the
JAX package on the CPU, on seeded numpy inputs at narrow widths and 64 px.
The JAX side is jitted (its eager ops compile one by one), and its
variables come from the port's seeded init through the bridge, held to
the tree a flax init makes (traced, not run).

Tolerances: each module's outputs in fp32, eval and train mode, rtol 1e-5
and atol 1e-5 of the map's scale (conv sums and the batch variance in
another order), the BN running statistics after a train forward the same;
the bicubic upsampling 1e-5 in fp32 and bit for bit in bf16 (the same
bf16 weights, the same contraction order, both libraries rounding an fp32
sum once a contraction); bf16 modules against JAX's bf16 within BF16_TOL
of the map's scale (see there); the tiny e-YOLOX's head maps and decode
1e-4 (as tests/test_torch_model.py: a BatchNorm network on 0-255 inputs),
its postprocess exact on the same decoded predictions, its loss and input
gradients rtol 1e-5 (as tests/test_torch_loss.py), its 3-step train state
as tests/test_torch_yolov7.py holds YOLOv7's (change-relative 5e-3,
losses 1e-3; see TRAIN_LR).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pl_yolo_tpu.layers import blocks as jb
from pl_yolo_tpu.models import detector as jdet
from pl_yolo_tpu.models.backbones import mobile as jmob
from pl_yolo_tpu.models.backbones import shufflenetv2 as jshuf
from pl_yolo_tpu.models.necks import pafpn_al as jal
from pl_yolo_tpu.ops import nms as jnms
from pl_yolo_tpu.train import state as jstate_mod
from pl_yolo_tpu.train.optim import _kernel_mask
from pl_yolo_tpu.train.optim import build_optimizer as jax_build_optimizer
from pl_yolo_tpu_torch import bridge
from pl_yolo_tpu_torch.data.augment import AugmentConfig, make_augment_fn
from pl_yolo_tpu_torch.layers.blocks import (BatchNorm2d, space_to_depth,
                                             stem_input_s2d)
from pl_yolo_tpu_torch.models import detector as tdet
from pl_yolo_tpu_torch.models.backbones import mobile as tmob
from pl_yolo_tpu_torch.models.backbones import shufflenetv2 as tshuf
from pl_yolo_tpu_torch.models.necks import pafpn_al as tal
from pl_yolo_tpu_torch.ops import nms as tnms
from pl_yolo_tpu_torch.ops.resize import upsample_bicubic_2x
from pl_yolo_tpu_torch.train.optim import build_optimizer
from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

# the JAX references compile at XLA's backend optimization level 0: the
# same functions, compiled in about three quarters of the time (results
# within an ulp or so of level 2's)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


def _jax_step(make, *args, **kwargs):
    """The JAX package's jitted step from `make`, jitted again with
    `_jit`'s compiler options."""
    return _jit(make(*args, **kwargs).__wrapped__)


NUM_CLASSES, SIZE, BATCH = 3, 64, 3
TOL = 1e-5
MAPS_TOL = dict(rtol=1e-4, atol=1e-4)
JAX_CONFIGS = CONFIG_DIR.parents[1] / "pl_yolo_tpu" / "configs" / "model"
E_YOLOX = ("e-yolox_tiny", "e-yolox_s", "e-yolox_m", "e-yolox_l",
           "e-yolox_x")


@pytest.fixture(autouse=True)
def _fp32_compute():
    """The JAX package's compute dtype is global state; these tests run
    fp32 unless they set it."""
    prev = jb.get_compute_dtype()
    jb.set_compute_dtype(None)
    yield
    jb.set_compute_dtype(prev)


def _assert_close(got, want, tol=TOL, what=""):
    """|got - want| <= tol·|want| + tol·max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


def _flax_tree(jmod, x):
    """The shapes of the variables a flax init of `jmod` on `x` makes, and
    its outputs' (traced, not run)."""
    outs, tree = jax.eval_shape(lambda k, x: jmod.init_with_output(
        k, x, False), jax.random.key(0), x)
    return jax.tree.map(lambda v: v.shape, dict(tree)), outs


def _randomized(tmod, jmod, x, rng, check_tree=True):
    """`tmod`'s parameters and BN statistics replaced by seeded values
    (kernels of unit-variance outputs, BN affine and statistics off their
    init, SE biases nonzero) and returned as flax variables, whose tree is
    held to the one a flax init of `jmod` on `x` makes (unless
    `check_tree` is false: the caller holds it elsewhere)."""
    got = bridge.state_dict_to_variables(tmod.state_dict(), tmod)
    got = {k: v for k, v in got.items() if v}

    def leaf(path, v):
        name = path[-1].key
        if name == "var":
            out = rng.uniform(0.5, 2.0, v.shape)
        elif name == "scale":
            out = rng.uniform(0.5, 1.5, v.shape)
        elif name in ("mean", "bias"):
            out = rng.normal(0.0, 0.1, v.shape)
        else:
            out = rng.normal(0.0, np.sqrt(1.0 / np.prod(v.shape[:-1])),
                             v.shape)
        return out.astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(leaf, got)
    if check_tree:
        assert _flax_tree(jmod, x)[0] == jax.tree.map(np.shape, variables)
    bridge.load_variables(tmod, variables)
    return variables


def _nchw(x):
    if isinstance(x, (list, tuple)):
        return [_nchw(t) for t in x]
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(ts):
    if isinstance(ts, torch.Tensor):
        ts = [ts]
    return [t.detach().float().permute(0, 2, 3, 1).numpy() for t in ts]


def _maps(rng, shapes, lo=-2.0, hi=2.0):
    return [rng.uniform(lo, hi, s).astype(np.float32) for s in shapes]


def _image(rng, size=SIZE):
    return _maps(rng, [(BATCH, size, size, 3)], 0.0, 255.0)[0]


# ----------------------------------------------------- the modules, one by one

# name: (JAX module, port module, input maker (rng -> NHWC array or list))
MODULES = {
    "sandglass_residual": (
        lambda: jmob.SandglassBlock(12),
        lambda **kw: tmob.SandglassBlock(12, 12, **kw),
        lambda rng: _maps(rng, [(BATCH, 12, 12, 12)])[0]),
    "sandglass_project": (
        lambda: jmob.SandglassBlock(16, expansion=1.5),
        lambda **kw: tmob.SandglassBlock(8, 16, expansion=1.5, **kw),
        lambda rng: _maps(rng, [(BATCH, 12, 12, 8)])[0]),
    "mobile_csp": (
        lambda: jmob.MobileCSPLayer(num_bottle=3),
        lambda **kw: tmob.MobileCSPLayer(16, num_bottle=3, **kw),
        lambda rng: _maps(rng, [(BATCH, 12, 12, 16)])[0]),
    "mobile_csp_depth1_no_shortcut": (
        lambda: jmob.MobileCSPLayer(num_bottle=1, shortcut=False),
        lambda **kw: tmob.MobileCSPLayer(16, num_bottle=1, shortcut=False,
                                         **kw),
        lambda rng: _maps(rng, [(BATCH, 12, 12, 16)])[0]),
    "elan_sandglass": (
        lambda: jmob.ELANSandglassLayer(num_bottle=4),
        lambda **kw: tmob.ELANSandglassLayer(16, num_bottle=4, **kw),
        lambda rng: _maps(rng, [(BATCH, 12, 12, 16)])[0]),
    "cspmobilenext": (
        lambda: jmob.CSPMobileNext(depths=(1, 2, 2, 2),
                                   channels=(8, 16, 32, 64, 128)),
        lambda **kw: tmob.CSPMobileNext(depths=(1, 2, 2, 2),
                                        channels=(8, 16, 32, 64, 128), **kw),
        _image),
    "ecmnet": (
        lambda: jmob.ECMNet(depths=(1, 1, 3, 1),
                            channels=(8, 16, 32, 64, 128)),
        lambda **kw: tmob.ECMNet(depths=(1, 1, 3, 1),
                                 channels=(8, 16, 32, 64, 128), **kw),
        _image),
    "al_pafpn": (
        lambda: jal.AL_PAFPN(depths=(2, 1, 1, 1), in_channels=(16, 32, 64)),
        lambda **kw: tal.AL_PAFPN(depths=(2, 1, 1, 1),
                                  in_channels=(16, 32, 64),
                                  feat_channels=(16, 32, 64), **kw),
        lambda rng: _maps(rng, [(BATCH, 8, 8, 16), (BATCH, 4, 4, 32),
                                (BATCH, 2, 2, 64)])),
    "se_module": (
        lambda: jmob.SEModule(),
        lambda **kw: tmob.SEModule(16, **kw),
        lambda rng: _maps(rng, [(BATCH, 6, 6, 16)])[0]),
    "mnv3_block_se": (
        lambda: jmob.MNV3Block(ksize=5, expand=24, out_channels=8,
                               act="hswish", use_se=True),
        lambda **kw: tmob.MNV3Block(8, 5, 24, 8, "hswish", True, **kw),
        lambda rng: _maps(rng, [(BATCH, 8, 8, 8)])[0]),
    "mobilenetv3_small": (
        lambda: jmob.MobileNetV3("small"),
        lambda **kw: tmob.MobileNetV3("small", **kw),
        _image),
    "shuffle_unit_s2_se": (
        lambda: jshuf.ShuffleUnit(24, ksize=5, stride=2, use_se=True),
        lambda **kw: tshuf.ShuffleUnit(8, 24, ksize=5, stride=2,
                                       use_se=True, **kw),
        lambda rng: _maps(rng, [(BATCH, 12, 12, 8)])[0]),
    "shuffle_xception_se": (
        lambda: jshuf.ShuffleXception(24, use_se=True),
        lambda **kw: tshuf.ShuffleXception(24, 24, use_se=True, **kw),
        lambda rng: _maps(rng, [(BATCH, 6, 6, 24)])[0]),
    "shufflenetv2_se": (
        lambda: jshuf.ShuffleNetV2(channels=(24, 48, 96, 192), use_se=True),
        lambda **kw: tshuf.ShuffleNetV2(channels=(24, 48, 96, 192),
                                        use_se=True, **kw),
        _image),
}


# The whole backbones in train mode are compared through a float64 run of
# the port. Their BatchNorms normalise by the batch: stage 4 sees 12
# values a channel (2x2 at B=3), MobileNetV3's and ShuffleNetV2's SE
# BatchNorms 3 (one a batch entry), and on noise images those few values
# lie close together, so the variance cancels and 1/std amplifies each
# package's fp32 rounding layer after layer. Measured on the CPU, the
# worst output against the float64 port: the port 6e-6 to 2.0e-4 of the
# map's scale, JAX 6e-6 to 1.2e-3 (MobileNetV3-S's stage 4; flax's
# E[x²] - E[x]² variance cancels where torch's two passes do not). So each
# output and running statistic of these four holds JAX within F64_TOL of
# the float64 port, and the fp32 port no further from it than JAX (or
# TOL); a wrong layer moves JAX O(1) away from the float64 port.
NETS = ("cspmobilenext", "ecmnet", "mobilenetv3_small", "shufflenetv2_se")
F64_TOL = 2.5e-3


@pytest.fixture(scope="module", params=sorted(MODULES))
def module_pair(request):
    """One module in both packages from the same randomised weights, on
    one seeded input: the eval outputs, and the train-mode outputs with
    the BN statistics after that forward (for NETS also the float64
    port's)."""
    jb.set_compute_dtype(None)
    name = request.param
    make_j, make_t, make_x = MODULES[name]
    rng = np.random.default_rng(sorted(MODULES).index(name))
    x = make_x(rng)
    jmod, tmod = make_j(), make_t()
    # the whole backbones' trees are held to flax's by
    # test_bf16_output_dtypes_match_jax, which traces their init anyway
    variables = _randomized(tmod, jmod, jax.tree.map(jnp.asarray, x), rng,
                            check_tree=name not in BF16_DTYPES)

    @_jit
    def both(v, x):
        evaluated = jmod.apply(v, x, False)
        trained, mutated = jmod.apply(v, x, True, mutable=["batch_stats"])
        return evaluated, trained, mutated["batch_stats"]
    jeval, jtrain, jstats = both(variables, jax.tree.map(jnp.asarray, x))
    exact = None
    if name in NETS:
        t64 = copy.deepcopy(tmod).double().train()
        with torch.no_grad():
            out = t64(_nchw(x).double())
        exact = (out, _stats(t64))
    with torch.no_grad():
        teval = tmod.eval()(_nchw(x))
        ttrain = tmod.train()(_nchw(x))
    return dict(name=name, tmod=tmod, jeval=jeval, jtrain=jtrain,
                jstats=jstats, teval=teval, ttrain=ttrain, exact=exact)


def _stats(tmod):
    return dict(bridge._flatten(bridge.state_dict_to_variables(
        tmod.state_dict(), tmod)["batch_stats"]))


def _err(got, want):
    """max |got - want| / max(1, max |want|), in float64."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


def _outputs_match(got, want, name):
    want = jax.tree.leaves(want)
    got = _nhwc(got)
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i)
        _assert_close(g, w, what=f"{name} output {i}")


def test_module_eval_outputs_match_jax(module_pair):
    _outputs_match(module_pair["teval"], module_pair["jeval"],
                   module_pair["name"])
    tmod = module_pair["tmod"]
    if hasattr(tmod, "out_channels"):
        outs = jax.tree.leaves(module_pair["jeval"])
        widths = tmod.out_channels
        assert list(widths if isinstance(widths, list) else [widths]) == [
            o.shape[-1] for o in outs]


def test_module_train_forward_and_running_stats_match_jax(module_pair):
    """Train mode: the batch statistics normalise (the SE's BatchNorms over
    B = 3 values a channel), and the running statistics take flax's
    momentum and biased variance. NETS through the float64 port (see
    there), the blocks directly at TOL."""
    name, tmod = module_pair["name"], module_pair["tmod"]
    got = _stats(tmod)
    want = dict(bridge._flatten(jax.device_get(module_pair["jstats"])))
    assert set(got) == set(want) and want
    for m in tmod.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert isinstance(m, BatchNorm2d)
            assert int(m.num_batches_tracked) == 1
    if module_pair["exact"] is None:
        _outputs_match(module_pair["ttrain"], module_pair["jtrain"], name)
        for path, w in want.items():
            _assert_close(got[path], w, what="/".join(path))
        return
    outs, stats = module_pair["exact"]
    pairs = [(g, w, e, f"{name} output {i}") for i, (g, w, e) in enumerate(
        zip(_nhwc(module_pair["ttrain"]), jax.tree.leaves(
            module_pair["jtrain"]), _nhwc([o.float() for o in outs])))]
    pairs += [(got[p], want[p], stats[p], "/".join(p)) for p in want]
    for g, w, e, what in pairs:
        port, jax_ = _err(g, e), _err(w, e)
        assert jax_ <= F64_TOL and port <= max(jax_, TOL), (
            f"{what}: port {port:.3e}, JAX {jax_:.3e} from the float64 port")


# --------------------------------------------------------- bicubic upsampling

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w", [(8, 8), (5, 7), (7, 5), (3, 12)])
def test_upsample_bicubic_2x_matches_jax(h, w, dtype):
    """`jax.image.resize(..., "bicubic")` by 2 of an NHWC map against the
    port's NCHW einsums: fp32 1e-5 with its gradient; bf16 bit for bit and
    bf16 out (JAX casts the weights to the input's dtype and rounds each
    of its two contractions; which axis goes first follows the map's
    shape, hence the non-square cases)."""
    rng = np.random.default_rng(h * 16 + w)
    x = (rng.normal(size=(2, h, w, 6)) * 3).astype(np.float32)
    jdtype = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdtype)
    want = _jit(jal.upsample_bicubic_2x)(xj)
    assert want.dtype == jdtype
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = upsample_bicubic_2x(xt)
    assert got.dtype == xt.dtype and got.shape == (2, 6, 2 * h, 2 * w)
    got = _nhwc(got)[0]
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        return
    _assert_close(got, want)
    cot = rng.normal(size=want.shape).astype(np.float32)
    wgrad = _jit(jax.grad(lambda x: jnp.sum(
        jal.upsample_bicubic_2x(x) * cot)))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    (upsample_bicubic_2x(xt) * _nchw(cot)).sum().backward()
    _assert_close(_nhwc(xt.grad)[0], wgrad)


# ----------------------------------------------------------------- bf16 dtypes

# bf16 against bf16: both packages run every conv and BatchNorm of these
# modules in bf16 (8 significant bits, a relative step of 2^-8 = 3.9e-3),
# and the two CPU libraries round a bf16 conv's fp32 sum, and the
# BatchNorm's bf16 arithmetic, each their own way; a layer's difference of
# about a step passes on through the layers after it. Measured on the CPU:
# 3.9e-3 to 2.2e-2 of the map's scale at the outputs (ECMNet's stage 4 the
# most). A wrong branch, order or dtype moves the maps by O(1) of their
# scale.
BF16_TOL = 3e-2
BF16_VALUES = ("al_pafpn", "ecmnet", "shuffle_unit_s2_se")
# the full backbones' output dtypes (traced on the JAX side)
BF16_DTYPES = {
    "ecmnet": MODULES["ecmnet"][:2],
    "cspmobilenext": MODULES["cspmobilenext"][:2],
    "mobilenetv3_small": MODULES["mobilenetv3_small"][:2],
    "mobilenetv3_large": (lambda: jmob.MobileNetV3("large"),
                          lambda **kw: tmob.MobileNetV3("large", **kw)),
    "shufflenetv2": (
        lambda: jshuf.ShuffleNetV2(channels=(24, 48, 96, 192)),
        lambda **kw: tshuf.ShuffleNetV2(channels=(24, 48, 96, 192), **kw)),
    "shufflenetv2_se": MODULES["shufflenetv2_se"][:2],
}


@pytest.mark.parametrize("name", sorted(BF16_DTYPES))
def test_bf16_output_dtypes_match_jax(name):
    """The whole backbone's flax tree (held here for the module tests too);
    under `dtype: bfloat16` the maps are bf16, but for ShuffleNetV2 with
    the SE: its SE convs are flax `nn.Conv`s without a dtype, fp32 params
    promote the bf16 input, and the gate's product and the unit's concat
    are fp32, as every stage map then is."""
    make_j, make_t = BF16_DTYPES[name]
    jb.set_compute_dtype("bfloat16")
    x = _image(np.random.default_rng(30))
    tree, want = _flax_tree(make_j(), jnp.asarray(x))
    tmod = make_t(dtype=torch.bfloat16).eval()
    variables = bridge.state_dict_to_variables(tmod.state_dict(), tmod)
    assert tree == jax.tree.map(np.shape, {k: v for k, v in
                                           variables.items() if v})
    with torch.no_grad():
        got = tmod(_nchw(x))
    expect = torch.float32 if name == "shufflenetv2_se" else torch.bfloat16
    assert [g.dtype for g in got] == [expect] * 3
    assert [jnp.dtype(w.dtype) for w in want] == [jnp.dtype(
        str(expect).split(".")[-1])] * 3


@pytest.mark.parametrize("name", BF16_VALUES)
def test_bf16_outputs_match_jax(name):
    """bf16 maps against JAX's bf16 maps, eval mode, BF16_TOL of the
    map's scale; the same fp32 weights on both sides; the same dtypes."""
    make_j, make_t, make_x = MODULES[name]
    rng = np.random.default_rng(31)
    jb.set_compute_dtype("bfloat16")
    jmod, tmod, x = make_j(), make_t(dtype=torch.bfloat16), make_x(rng)
    xj = jax.tree.map(jnp.asarray, x)
    variables = _randomized(tmod, jmod, xj, rng,
                            check_tree=name not in BF16_DTYPES)
    want = jax.tree.leaves(_jit(lambda v, x: jmod.apply(v, x, False))(
        variables, xj))
    with torch.no_grad():
        got = tmod.eval()(_nchw(x))
    got = got if isinstance(got, (list, tuple)) else [got]
    assert [str(g.dtype).split(".")[-1] for g in got] == [
        jnp.dtype(w.dtype).name for w in want]
    for i, (g, w) in enumerate(zip(_nhwc(got), want)):
        _assert_close(g, np.asarray(w.astype(jnp.float32)), BF16_TOL,
                      what=f"{name} output {i}")


# --------------------------------------------- the tiny e-YOLOX, end to end

def _tiny(name, channels=(8, 16, 32, 64, 128), dtype=None):
    """`name`.yaml with narrow widths (its depths, neck and head kept)."""
    cfg = load_config(CONFIG_DIR / "model" / f"{name}.yaml")
    cfg["backbone"]["channels"] = list(channels)
    widths = [2 * c for c in channels[1:4]]
    cfg["neck"]["channels"] = list(widths)
    cfg["head"]["channels"] = list(widths)
    cfg["dtype"] = dtype
    return cfg


def _labels(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    labels = np.zeros((batch, 6, 5), np.float32)
    labels[:, :3, 0] = rng.integers(0, NUM_CLASSES, (batch, 3))
    labels[:, :3, 1:3] = rng.uniform(12, 52, (batch, 3, 2))
    labels[:, :3, 3:] = rng.uniform(8, 40, (batch, 3, 2))
    return labels


# The tiny e-YOLOX's train-mode step is badly conditioned in fp32, as the
# tiny YOLOX's and YOLOv7's are (tests/test_torch_train.py and
# tests/test_torch_yolov7.py argue the bounds): a state tensor is compared
# by its change since the initial state, to SLICE_TOL of that change (plus
# two ulps), a loss to rtol 1e-3. The base rate is YOLOv7's 5e-6: ECMNet's
# sandglass blocks put ~90 BatchNorms in the path, the SE-free depthwise
# convs of the sandglass see 4-8 values a channel in stage 4, and three
# steps at YOLOX's 5e-4 grow the fp32 gap between the packages past
# SLICE_TOL of the change; at 5e-6 it stays inside and every tensor moves.
TOTAL_STEPS, N_STEPS, TRAIN_LR, SLICE_TOL = 10, 3, 5e-6, 5e-3


@pytest.fixture(scope="module")
def eyolox():
    """The tiny e-YOLOX (e-yolox_s.yaml's depths) in both packages from the
    port's seeded init, BN statistics randomised: its eval head maps and
    decode on one batch, and three train steps of each from one state."""
    jb.set_compute_dtype(None)
    cfg = _tiny("e-yolox_s")
    cfg["optimizer"]["learning_rate"] = TRAIN_LR
    jmodel = jdet.build_model(copy.deepcopy(cfg), NUM_CLASSES)
    tmodel = tdet.build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                              input_size=(SIZE, SIZE))
    variables = bridge.state_dict_to_variables(tmodel.module.state_dict(),
                                               tmodel.module)
    variables = {k: v for k, v in variables.items() if v}
    want = jax.eval_shape(lambda k: jmodel.init(k, input_size=(SIZE, SIZE)),
                          jax.random.key(0))
    assert (jax.tree.map(lambda v: v.shape, dict(want))
            == jax.tree.map(np.shape, variables))
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.1, v.shape)).astype(np.float32),
        variables["batch_stats"])
    bridge.load_variables(tmodel.module, variables)
    x = _image(np.random.default_rng(18))[:2]
    labels = _labels()

    @_jit
    def serve(v, x):
        maps = jmodel.module.apply(v, x, False)
        return maps, jmodel.loss.eval_decode(maps)
    jmaps, jdec = serve(variables, jnp.asarray(x))
    with torch.no_grad():
        tmaps = tmodel.module(torch.from_numpy(x))
        tdec = tmodel.loss.eval_decode(tmaps)

    tx, _ = jax_build_optimizer(cfg["optimizer"], total_steps=TOTAL_STEPS)
    jstate = jstate_mod.TrainState.create(jax.tree.map(np.array, variables),
                                          tx)
    jstep = _jax_step(jstate_mod.make_train_step, jmodel.module.apply,
                      jmodel.loss.train_loss, donate=False)
    jlosses = []
    for i in range(N_STEPS):
        jstate, losses = jstep(jstate, jnp.asarray(x), jnp.asarray(labels),
                               jax.random.key(i), use_l1=jnp.asarray(1.0))
        jlosses.append(jax.device_get(losses))
    optimizer, _ = build_optimizer(tmodel.module, cfg["optimizer"],
                                   total_steps=TOTAL_STEPS)
    tstate = TrainState.create(tmodel.module, optimizer)
    tstep = make_train_step(tmodel.loss.train_loss)
    tlosses = [tstep(tstate, torch.from_numpy(x), torch.from_numpy(labels),
                     use_l1=torch.tensor(1.0)) for _ in range(N_STEPS)]
    return dict(cfg=cfg, jmodel=jmodel, tmodel=tmodel, init=variables,
                jmaps=[np.asarray(m) for m in jmaps],
                tmaps=[m.numpy() for m in tmaps], jdec=np.asarray(jdec),
                tdec=tdec.numpy(), labels=labels, jstate=jstate,
                jlosses=jlosses, tstate=tstate, tlosses=tlosses)


def test_eyolox_head_maps_and_decode_match_jax(eyolox):
    assert [m.shape for m in eyolox["tmaps"]] == [
        (2, SIZE // s, SIZE // s, 5 + NUM_CLASSES) for s in (8, 16, 32)]
    for a, b in zip(eyolox["tmaps"], eyolox["jmaps"]):
        np.testing.assert_allclose(a, b, **MAPS_TOL)
    assert eyolox["tdec"].shape == (2, 64 + 16 + 4, 5 + NUM_CLASSES)
    np.testing.assert_allclose(eyolox["tdec"], eyolox["jdec"], **MAPS_TOL)


def test_eyolox_postprocess_matches_jax(eyolox):
    """The same decoded predictions through both postprocesses: equal."""
    preds = eyolox["jdec"]
    kw = dict(conf_threshold=1e-5, iou_threshold=0.5, max_det=100,
              pre_nms_topk=256)
    want = _jit(functools.partial(jnms.postprocess, **kw))(
        jnp.asarray(preds))
    got = tnms.postprocess(torch.from_numpy(preds.copy()), device="cpu",
                           **kw)
    assert int(np.asarray(want.valid).sum()) > 0
    for field in ("valid", "classes", "scores", "boxes"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


def test_eyolox_loss_and_input_gradients_match_jax(eyolox):
    maps, labels = eyolox["jmaps"], eyolox["labels"]
    loss_fn = eyolox["jmodel"].loss.train_loss

    def jfn(outs):
        losses = loss_fn(outs, jnp.asarray(labels), use_l1=True)
        return losses["loss"], losses
    (_, jl), jg = _jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(m) for m in maps])
    outs = [torch.from_numpy(m).requires_grad_() for m in maps]
    tl = eyolox["tmodel"].loss.train_loss(outs, torch.from_numpy(labels),
                                          use_l1=True)
    tl["loss"].backward()
    assert float(jl["proportion"]) > 0 and set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].detach().numpy(), np.asarray(jl[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for t, j in zip(outs, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7)


def test_eyolox_train_losses_match_jax_step_by_step(eyolox):
    for step, (tl, jl) in enumerate(zip(eyolox["tlosses"],
                                        eyolox["jlosses"])):
        assert set(tl) == set(jl) and float(jl["proportion"]) > 0
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-3,
                                       atol=1e-5, err_msg=f"step {step}: {k}")


@pytest.mark.parametrize("part", ["params", "batch_stats", "ema_params",
                                  "momentum"])
def test_eyolox_train_state_after_three_steps_matches_jax(eyolox, part):
    jstate, tstate = eyolox["jstate"], eyolox["tstate"]
    module = tstate.module
    assert tstate.step == int(jstate.step) == N_STEPS
    if part == "momentum":
        want = [s for s in jax.tree.leaves(
            jstate.opt_state,
            is_leaf=lambda s: isinstance(s, optax.TraceState))
            if isinstance(s, optax.TraceState)][0].trace
        got = bridge.momentum_to_trace(tstate.optimizer, module)
        init = jax.tree.map(np.zeros_like, eyolox["init"]["params"])
    elif part == "ema_params":
        want = jstate.ema_params
        got = bridge.state_dict_to_variables(
            tstate.eval_module.state_dict(), module)["params"]
        init = eyolox["init"]["params"]
    else:
        want = getattr(jstate, part)
        got = bridge.state_dict_to_variables(module.state_dict(),
                                             module)[part]
        init = eyolox["init"][part]
    got, init = dict(bridge._flatten(got)), dict(bridge._flatten(init))
    want = dict(bridge._flatten(jax.device_get(want)))
    assert set(got) == set(want) == set(init)
    moved = 0
    for path in want:
        change = np.abs(want[path] - init[path]).max()
        moved += change > 0
        err = np.abs(got[path] - want[path]).max()
        ulps = 2 * np.finfo(np.float32).eps * np.abs(want[path]).max()
        assert err <= SLICE_TOL * change + ulps, (
            f"{part}: {'/'.join(path)} differs by {err:.3e}, "
            f"{err / max(change, 1e-30):.3e} of its change {change:.3e}")
    assert moved > 0.9 * len(want)


# ------------------------------------------- a CPU step on each stem route

def _with_csppafpn(backbone: dict, widths) -> dict:
    """A detector of yolox_s.yaml's neck, head and recipe around a
    registry backbone, its neck and head as wide as the backbone's maps."""
    cfg = load_config(CONFIG_DIR / "model" / "yolox_s.yaml")
    cfg["backbone"] = backbone
    cfg["neck"].update(channels=list(widths), depths=[1, 1, 1, 1])
    cfg["head"]["channels"] = list(widths)
    return cfg


ROUTES = {
    "ecmnet": (lambda: _tiny("e-yolox_s", dtype="bfloat16"), True),
    "shufflenetv2_se": (lambda: _with_csppafpn(
        {"name": "shufflenetv2", "channels": [24, 48, 96, 192],
         "use_se": True}, (48, 96, 192)), False),
    "mobilenetv3s": (lambda: _with_csppafpn(
        {"name": "mobilenetv3s"}, (24, 48, 96)), False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_augmented_cpu_step_on_the_backbones_stem_route(name):
    """ECMNet has the Focus stem, so the trainer hands it the
    augmentation's space-to-depth output (`STEM_S2D`), on which its stem
    gives the maps of the raw images; ShuffleNetV2 and MobileNetV3 take
    the NHWC output. One bf16 step each from uint8 images: a finite loss,
    labels assigned, the step counted."""
    make_cfg, s2d = ROUTES[name]
    cfg = make_cfg()
    model = tdet.build_model(cfg, NUM_CLASSES, device="cpu")
    assert getattr(type(model.module.backbone), "STEM_S2D", False) is s2d
    rng = np.random.default_rng(40)
    images = torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3),
                                           dtype=np.uint8))
    if s2d:
        x = images.float()
        with torch.no_grad(), stem_input_s2d():
            pre = model.module(space_to_depth(x.permute(0, 3, 1, 2))
                               .permute(0, 2, 3, 1))
        with torch.no_grad():
            raw = model.module(x)
        for a, b in zip(pre, raw):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def s2d_apply(module, x):
        with stem_input_s2d():
            return module(x)
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 10)
    state = TrainState.create(model.module, optimizer)
    step = make_train_step(
        model.loss.train_loss, apply_fn=s2d_apply if s2d else None,
        augment_fn=make_augment_fn(AugmentConfig(max_labels=6),
                                   out_s2d=s2d))
    losses = step(state, images, torch.from_numpy(_labels(41)),
                  generator=torch.Generator().manual_seed(0),
                  aug_enable=True)
    assert np.isfinite(float(losses["loss"]))
    assert float(losses["proportion"]) > 0 and state.step == 1


# ------------------------------------------------------ the e-YOLOX configs

@pytest.fixture(scope="module", params=E_YOLOX)
def config_pair(request):
    """A config's port model at narrow widths (its depths kept) and the
    flax tree a JAX init would make."""
    cfg = _tiny(request.param)
    tmodel = tdet.build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                              input_size=(SIZE, SIZE))
    jmodel = jdet.build_model(copy.deepcopy(cfg), NUM_CLASSES)
    want = jax.eval_shape(lambda k: jmodel.init(k, input_size=(SIZE, SIZE)),
                          jax.random.key(0))
    return request.param, cfg, tmodel, jax.tree.map(lambda v: v.shape,
                                                    dict(want))


def test_eyolox_config_is_copied_builds_and_round_trips(config_pair):
    """The copy is byte-equal to the JAX package's YAML; every tensor maps
    to the flax tree's leaf of the same shape and back; a forward at 64
    px gives the three levels."""
    name, _, tmodel, want = config_pair
    path = CONFIG_DIR / "model" / f"{name}.yaml"
    assert path.read_bytes() == (JAX_CONFIGS / f"{name}.yaml").read_bytes()
    module = tmodel.module
    variables = bridge.state_dict_to_variables(module.state_dict(), module)
    variables = {k: v for k, v in variables.items() if v}
    assert jax.tree.map(np.shape, variables) == want, name
    back = bridge.variables_to_state_dict(variables, module)
    for key, t in module.state_dict().items():
        assert torch.equal(back[key], t), key
    with torch.no_grad():
        maps = module(torch.zeros(1, SIZE, SIZE, 3))
    assert [tuple(m.shape) for m in maps] == [
        (1, SIZE // s, SIZE // s, 5 + NUM_CLASSES) for s in (8, 16, 32)]


def _assert_decay_is_the_kernel_mask(module, optimizer, want_params, what):
    decayed, rest = optimizer.param_groups
    names = {id(p): n for n, p in module.named_parameters()}
    got = {names[id(p)] for p in decayed["params"]}
    mask = _kernel_mask(jax.tree.map(np.zeros, want_params))
    flax_kernels = {"/".join(p) for p, m in
                    bridge._flatten(jax.tree.map(np.asarray, mask)).items()
                    if m}
    assert {n.replace(".", "/")[:-len("/weight")] + "/kernel"
            for n in got} == flax_kernels, what
    assert len(got) + len(rest["params"]) == len(names)
    assert rest["weight_decay"] == 0.0


def test_eyolox_decayed_parameters_are_the_flax_kernels(config_pair):
    name, cfg, tmodel, want = config_pair
    optimizer, _ = build_optimizer(tmodel.module, cfg["optimizer"], 10)
    assert optimizer.param_groups[0]["weight_decay"] == \
        cfg["optimizer"]["weight_decay"]
    _assert_decay_is_the_kernel_mask(tmodel.module, optimizer,
                                     want["params"], name)


# ------------------------------------------------------ the registry entries

@pytest.mark.parametrize("name", ["shufflenetv2", "mobilenetv3s",
                                  "mobilenetv3l"])
def test_registry_defaults_match_jax(name):
    """A config that names only the backbone (MobileNetV3's with a `norm`
    and `act` the JAX package does not read) builds JAX's defaults:
    ShuffleNetV2 channels (36, 104, 208, 416), hswish, no SE; the same
    flax tree and output widths in both packages."""
    cfg = {"name": name}
    if name.startswith("mobilenetv3"):
        cfg.update(norm="ln", act="relu")
    tmod = tdet.BACKBONES[name](copy.deepcopy(cfg), None, (SIZE, SIZE))
    jmod = jdet.BACKBONES[name](copy.deepcopy(cfg))
    x = jnp.zeros((1, SIZE, SIZE, 3))
    want = jax.eval_shape(lambda k: jmod.init_with_output(k, x, False),
                          jax.random.key(0))
    variables = bridge.state_dict_to_variables(tmod.state_dict(), tmod)
    assert (jax.tree.map(np.shape, {k: v for k, v in variables.items() if v})
            == jax.tree.map(lambda v: v.shape, dict(want[1])))
    assert tmod.out_channels == [m.shape[-1] for m in want[0]]
    if name == "shufflenetv2":
        assert tmod.out_channels == [104, 208, 416]
        assert not any(isinstance(m, tshuf.SELayer) for m in tmod.modules())
        assert tmod.stage1_b1.pw1.act is torch.nn.functional.hardswish
    else:
        assert tmod.out_channels == ([24, 48, 96] if name == "mobilenetv3s"
                                     else [40, 80, 160])


def test_layout_tables_equal_the_jax_packages():
    """MobileNetV3's (ksize, in, expand, out, act, se, stride) tables and
    ShuffleNetV2's unit layouts, entry for entry: the value tests run
    MobileNetV3-S and the registry test holds MobileNetV3-L's tree, which
    does not see an activation or a stride."""
    assert tmob._MNV3_SMALL == jmob._MNV3_SMALL
    assert tmob._MNV3_LARGE == jmob._MNV3_LARGE
    assert tshuf._STAGES == jshuf._STAGES


def test_shufflenetv2_se_biases_start_at_zero_and_take_no_decay():
    """The SE convs' biases are flax `bias` leaves: zero at init (flax's
    default) and outside the decayed group, their kernels inside it."""
    cfg = ROUTES["shufflenetv2_se"][0]()
    cfg["dtype"] = None
    model = tdet.build_model(cfg, NUM_CLASSES, device="cpu")
    ses = [m for m in model.module.modules() if isinstance(m, tshuf.SELayer)]
    assert len(ses) == 20
    for se in ses:
        assert not se.fc1.bias.any() and not se.fc2.bias.any()
    # the SE's flax tree is held to the bridge's by the module tests
    params = bridge.state_dict_to_variables(model.module.state_dict(),
                                            model.module)["params"]
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 10)
    _assert_decay_is_the_kernel_mask(
        model.module, optimizer, jax.tree.map(np.shape, params),
        "shufflenetv2_se")
