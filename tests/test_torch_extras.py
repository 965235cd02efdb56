"""Port parity: the extra backbones of `pl_yolo_tpu_torch`
(`models/backbones/extras.py`: EfficientRep with SimSPPF, ResNet with its
basic block, ConvNeXt with its block, GhostNet with the ghost module and
bottleneck, VGG, MobileNeXt), their registry entries, and a tiny ConvNeXt
detector through serving and training, against the JAX package on the
CPU, on seeded numpy inputs at the JAX test's narrow widths
(tests/test_extras_backbones.py) and 64 px. The JAX side is jitted, and
its variables come from the port's seeded init through the bridge, held
to the tree a flax init makes (traced, not run).

Tolerances: each module's outputs in fp32, eval and train mode, rtol 1e-5
and atol 1e-5 of the map's scale, the BN running statistics after a train
forward the same; the whole backbones' train mode through a float64 run of
the port where JAX's fp32 sits further from it (see NETS); bf16 dtypes
equal, bf16 maps within BF16_TOL; the tiny ConvNeXt detector's head maps
and decode 1e-4, its postprocess exact, its loss and input gradients rtol
1e-5, its 3-step train state as tests/test_torch_yolov7.py holds
YOLOv7's (change-relative 5e-3, losses 1e-3).
"""

import copy
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pl_yolo_tpu.layers import blocks as jb
from pl_yolo_tpu.models import detector as jdet
from pl_yolo_tpu.models.backbones import extras as jx
from pl_yolo_tpu.ops import nms as jnms
from pl_yolo_tpu.train import state as jstate_mod
from pl_yolo_tpu.train.optim import _kernel_mask
from pl_yolo_tpu.train.optim import build_optimizer as jax_build_optimizer
from pl_yolo_tpu_torch import bridge
from pl_yolo_tpu_torch.layers.blocks import BatchNorm2d
from pl_yolo_tpu_torch.models import detector as tdet
from pl_yolo_tpu_torch.models.backbones import extras as tx
from pl_yolo_tpu_torch.ops import nms as tnms
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
OUTPUTS = ["stage2", "stage3", "stage4"]
# the JAX test's narrow widths (tests/test_extras_backbones.py) and the
# neck / head widths of the stage2-4 maps
EXTRAS = {
    "efficientrep": ({"depths": [1, 1, 1, 1],
                      "channels": [8, 16, 32, 64, 128]}, (32, 64, 128)),
    "resnet": ({"depths": [1, 1, 1, 1], "channels": [8, 16, 32, 64]},
               (16, 32, 64)),
    "convnext": ({"depths": [1, 1, 1, 1], "channels": [8, 16, 32, 64]},
                 (16, 32, 64)),
    "ghostnet": ({}, (40, 112, 160)),
    "vgg": ({"channels": [8, 16, 32, 64, 64]}, (32, 64, 64)),
    "mobilenext": ({"depths": [1, 1, 1, 1],
                    "channels": [8, 16, 32, 64, 128]}, (32, 64, 128)),
}


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


def _err(got, want):
    """max |got - want| / max(1, max |want|), in float64."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


def _flax_tree(jmod, x):
    """The shapes of the variables a flax init of `jmod` on `x` makes, and
    its outputs' (traced, not run)."""
    outs, tree = jax.eval_shape(lambda k, x: jmod.init_with_output(
        k, x, False), jax.random.key(0), x)
    return jax.tree.map(lambda v: v.shape, dict(tree)), outs


def _randomized(tmod, jmod, x, rng):
    """`tmod`'s parameters and BN statistics replaced by seeded values
    (kernels of unit-variance outputs, norms' affine and statistics off
    their init, biases and ConvNeXt's layer scale nonzero) and returned as
    flax variables, whose tree is held to the one a flax init of `jmod` on
    `x` makes."""
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
        elif name == "gamma":
            out = rng.uniform(0.5, 1.0, v.shape)
        else:
            out = rng.normal(0.0, np.sqrt(1.0 / np.prod(v.shape[:-1])),
                             v.shape)
        return out.astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(leaf, got)
    assert _flax_tree(jmod, x)[0] == jax.tree.map(np.shape, variables)
    bridge.load_variables(tmod, variables)
    return variables


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(ts):
    if isinstance(ts, torch.Tensor):
        ts = [ts]
    return [t.detach().float().permute(0, 2, 3, 1).numpy() for t in ts]


def _maps(rng, shape):
    return rng.uniform(-2.0, 2.0, shape).astype(np.float32)


def _image(rng, size=SIZE):
    return rng.uniform(0.0, 255.0, (BATCH, size, size, 3)).astype(np.float32)


def _backbone(name, **kw):
    """The registry's port backbone at the JAX test's widths."""
    spec, _ = EXTRAS[name]
    return lambda **dt: tdet.BACKBONES[name](
        {"name": name, "outputs": OUTPUTS, **spec, **kw},
        dt.get("dtype"), (SIZE, SIZE))


def _jbackbone(name):
    spec, _ = EXTRAS[name]
    return lambda: jdet.BACKBONES[name](
        {"name": name, "outputs": OUTPUTS, **spec})


# ----------------------------------------------------- the modules, one by one

# name: (JAX module, port module, input maker (rng -> NHWC array))
MODULES = {
    "simsppf": (
        lambda: jx.SimSPPF(24),
        lambda **kw: tx.SimSPPF(16, 24, **kw),
        lambda rng: _maps(rng, (BATCH, 8, 8, 16))),
    "basic_block": (
        lambda: jx.BasicBlock(16),
        lambda **kw: tx.BasicBlock(16, 16, **kw),
        lambda rng: _maps(rng, (BATCH, 8, 8, 16))),
    "basic_block_down": (
        lambda: jx.BasicBlock(32, stride=2),
        lambda **kw: tx.BasicBlock(16, 32, 2, **kw),
        lambda rng: _maps(rng, (BATCH, 8, 8, 16))),
    "convnext_block": (
        lambda: jx.ConvNeXtBlock(16),
        lambda **kw: tx.ConvNeXtBlock(16),
        lambda rng: _maps(rng, (BATCH, 8, 8, 16))),
    "ghost_module": (
        lambda: jx.GhostModule(24),
        lambda **kw: tx.GhostModule(16, 24, **kw),
        lambda rng: _maps(rng, (BATCH, 8, 8, 16))),
    "ghost_bottleneck_s2_se": (
        lambda: jx.GhostBottleneck(48, 24, dw_size=5, stride=2, use_se=True),
        lambda **kw: tx.GhostBottleneck(16, 48, 24, dw_size=5, stride=2,
                                        use_se=True, **kw),
        lambda rng: _maps(rng, (BATCH, 8, 8, 16))),
    "ghost_bottleneck_identity": (
        lambda: jx.GhostBottleneck(32, 16),
        lambda **kw: tx.GhostBottleneck(16, 32, 16, **kw),
        lambda rng: _maps(rng, (BATCH, 8, 8, 16))),
    **{name: (_jbackbone(name), _backbone(name), _image) for name in EXTRAS},
}


# The whole backbones in train mode are compared through a float64 run of
# the port, as tests/test_torch_mobile.py compares its backbones: their
# BatchNorms normalise by the batch, stage 4 sees 12 values a channel (2x2
# at B=3), and each package's fp32 rounding is amplified by 1/std layer
# after layer. Each output and running statistic of NETS holds JAX within
# F64_TOL of the float64 port, and the fp32 port no further from it than
# JAX or 2·TOL (at fp32's floor, ~1e-5, the two packages trade places: VGG
# 1.31e-5 against JAX's 1.21e-5); a wrong layer moves JAX O(1) away from
# the float64 port.
NETS = ("efficientrep", "ghostnet", "mobilenext", "resnet", "vgg")
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
    variables = _randomized(tmod, jmod, jnp.asarray(x), rng)

    @_jit
    def both(v, x):
        evaluated = jmod.apply(v, x, False)
        trained, mutated = jmod.apply(v, x, True, mutable=["batch_stats"])
        return evaluated, trained, mutated.get("batch_stats", {})
    jeval, jtrain, jstats = both(variables, jnp.asarray(x))
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
    if hasattr(tmod, "out_channels") and isinstance(tmod.out_channels,
                                                    list):
        assert tmod.out_channels == [o.shape[-1] for o in jax.tree.leaves(
            module_pair["jeval"])]


def test_module_train_forward_and_running_stats_match_jax(module_pair):
    """Train mode: the batch statistics normalise and the running
    statistics take flax's momentum and biased variance. NETS through the
    float64 port (see there), the blocks directly at TOL (ConvNeXt has no
    BatchNorm: train mode is eval mode)."""
    name, tmod = module_pair["name"], module_pair["tmod"]
    got = _stats(tmod)
    want = dict(bridge._flatten(jax.device_get(module_pair["jstats"])))
    assert set(got) == set(want)
    assert bool(want) == ("convnext" not in name)
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
        assert jax_ <= F64_TOL and port <= max(jax_, 2 * TOL), (
            f"{what}: port {port:.3e}, JAX {jax_:.3e} from the float64 port")


# ----------------------------------------------------------------- bf16

# bf16 against bf16, eval mode: both packages round each bf16 conv's fp32
# sum and the BatchNorm's bf16 arithmetic their own way; a layer's
# difference of about a bf16 step (3.9e-3) passes on through the layers
# after it. Measured on the CPU, of the map's scale: GhostNet's 16
# bottlenecks 1.2e-2 / 3.3e-2 / 3.4e-2 at its three outputs (each
# package's bf16 maps 1.1e-2 to 4.1e-2 from the fp32 maps of the same
# weights, the port's and JAX's alike), EfficientRep 6e-7 (its RepConvs
# are fp32), ResNet, VGG and MobileNeXt 1e-2 to 1.6e-2. A wrong branch,
# order or dtype moves the maps by O(1) of their scale.
BF16_TOL = 5e-2
BF16_VALUES = ("ghostnet", "efficientrep")


@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_bf16_output_dtypes_match_jax(name):
    """Under `dtype: bfloat16` the stage maps have JAX's dtypes: ConvNeXt
    computes in fp32 (bare flax layers), EfficientRep's RepConv stages are
    fp32 and its SimSPPF stage bf16, GhostNet's SE gate is fp32 but the
    next ghost module takes bf16 again."""
    jb.set_compute_dtype("bfloat16")
    x = _image(np.random.default_rng(30))
    _, want = _flax_tree(_jbackbone(name)(), jnp.asarray(x))
    tmod = _backbone(name)(dtype=torch.bfloat16).eval()
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert [str(g.dtype).split(".")[-1] for g in got] == [
        jnp.dtype(w.dtype).name for w in want]
    if name == "convnext":
        assert all(g.dtype == torch.float32 for g in got)
    if name == "efficientrep":
        assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                          torch.bfloat16]


@pytest.mark.parametrize("name", BF16_VALUES)
def test_bf16_outputs_match_jax(name):
    """bf16 maps against JAX's bf16 maps, eval mode, BF16_TOL of the
    map's scale; the same fp32 weights on both sides."""
    rng = np.random.default_rng(31)
    jb.set_compute_dtype("bfloat16")
    jmod, tmod, x = _jbackbone(name)(), _backbone(name)(
        dtype=torch.bfloat16), _image(rng)
    variables = _randomized(tmod, jmod, jnp.asarray(x), rng)
    want = _jit(lambda v, x: jmod.apply(v, x, False))(variables,
                                                      jnp.asarray(x))
    with torch.no_grad():
        got = tmod.eval()(_nchw(x))
    for i, (g, w) in enumerate(zip(_nhwc(got), want)):
        _assert_close(g, np.asarray(w.astype(jnp.float32)), BF16_TOL,
                      what=f"{name} output {i}")


def test_ghostnet_se_gate_is_fp32_under_bf16():
    """The SE convs are bare flax convs: a bf16 input is promoted, the
    gate's product is fp32, and the next ghost module casts it back."""
    block = tx.GhostBottleneck(16, 48, 24, dw_size=5, stride=2, use_se=True,
                               dtype=torch.bfloat16).eval()
    seen = {}

    def hook(module, args):
        seen["in"] = args[0].dtype
    block.ghost2.register_forward_pre_hook(hook)
    with torch.no_grad():
        out = block(torch.zeros(1, 16, 8, 8))
    assert seen["in"] == torch.float32 and out.dtype == torch.bfloat16


# ---------------------------------------------- the tiny ConvNeXt detector

def _detector_cfg(name, dtype=None):
    """yolox_s.yaml's neck, head and recipe around an extra backbone at the
    JAX test's widths."""
    spec, widths = EXTRAS[name]
    cfg = load_config(CONFIG_DIR / "model" / "yolox_s.yaml")
    cfg["backbone"] = {"name": name, "outputs": OUTPUTS, **spec}
    cfg["neck"].update(channels=list(widths), depths=[1, 1, 1, 1])
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


# The 3-step state is compared by each tensor's change since the initial
# state, to SLICE_TOL of that change (plus two ulps), a loss to rtol 1e-3,
# at YOLOv7's base rate 5e-6 (tests/test_torch_yolov7.py argues both: the
# tiny detectors' train steps are badly conditioned in fp32).
TOTAL_STEPS, N_STEPS, TRAIN_LR, SLICE_TOL = 10, 3, 5e-6, 5e-3
# The LayerNorm biases of ConvNeXt's outputs reach the loss only through
# the neck's 1x1 convs and their train-mode BatchNorms, whose batch mean
# removes a shift of a channel: their gradient is zero in exact
# arithmetic, and their change (3e-12 to 6e-12 against the state's largest,
# 2.6e-4, measured on the CPU) is rounding, not a step. Both packages must
# leave them within 1e-6 of the largest change.
ZERO_GRADIENT = {f"backbone/out_norm{i}/bias" for i in (1, 2, 3)}


@pytest.fixture(scope="module")
def convnext():
    """The tiny ConvNeXt detector in both packages from the port's seeded
    init, BN statistics and ConvNeXt's layer scales randomised (from 1e-6
    the blocks would pass their input on): its eval head maps and decode
    on one batch, and three train steps of each from one state."""
    jb.set_compute_dtype(None)
    cfg = _detector_cfg("convnext")
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
    assert all(np.all(g == np.float32(1e-6)) for p, g in bridge._flatten(
        variables["params"]).items() if p[-1] == "gamma")
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.1, v.shape)).astype(np.float32),
        variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
                      if p[-1].key == "gamma" else v), variables["params"])
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

    tx_, _ = jax_build_optimizer(cfg["optimizer"], total_steps=TOTAL_STEPS)
    jstate = jstate_mod.TrainState.create(jax.tree.map(np.array, variables),
                                          tx_)
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


def test_convnext_head_maps_and_decode_match_jax(convnext):
    assert [m.shape for m in convnext["tmaps"]] == [
        (2, SIZE // s, SIZE // s, 5 + NUM_CLASSES) for s in (8, 16, 32)]
    for a, b in zip(convnext["tmaps"], convnext["jmaps"]):
        np.testing.assert_allclose(a, b, **MAPS_TOL)
    assert convnext["tdec"].shape == (2, 64 + 16 + 4, 5 + NUM_CLASSES)
    np.testing.assert_allclose(convnext["tdec"], convnext["jdec"],
                               **MAPS_TOL)


def test_convnext_postprocess_matches_jax(convnext):
    """The same decoded predictions through both postprocesses: equal."""
    preds = convnext["jdec"]
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


def test_convnext_loss_and_input_gradients_match_jax(convnext):
    maps, labels = convnext["jmaps"], convnext["labels"]
    loss_fn = convnext["jmodel"].loss.train_loss

    def jfn(outs):
        losses = loss_fn(outs, jnp.asarray(labels), use_l1=True)
        return losses["loss"], losses
    (_, jl), jg = _jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(m) for m in maps])
    outs = [torch.from_numpy(m).requires_grad_() for m in maps]
    tl = convnext["tmodel"].loss.train_loss(outs, torch.from_numpy(labels),
                                            use_l1=True)
    tl["loss"].backward()
    assert float(jl["proportion"]) > 0 and set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].detach().numpy(), np.asarray(jl[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for t, j in zip(outs, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7)


def test_convnext_train_losses_match_jax_step_by_step(convnext):
    for step, (tl, jl) in enumerate(zip(convnext["tlosses"],
                                        convnext["jlosses"])):
        assert set(tl) == set(jl) and float(jl["proportion"]) > 0
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-3,
                                       atol=1e-5, err_msg=f"step {step}: {k}")


@pytest.mark.parametrize("part", ["params", "batch_stats", "ema_params",
                                  "momentum"])
def test_convnext_train_state_after_three_steps_matches_jax(convnext, part):
    jstate, tstate = convnext["jstate"], convnext["tstate"]
    module = tstate.module
    assert tstate.step == int(jstate.step) == N_STEPS
    if part == "momentum":
        want = [s for s in jax.tree.leaves(
            jstate.opt_state,
            is_leaf=lambda s: isinstance(s, optax.TraceState))
            if isinstance(s, optax.TraceState)][0].trace
        got = bridge.momentum_to_trace(tstate.optimizer, module)
        init = jax.tree.map(np.zeros_like, convnext["init"]["params"])
    elif part == "ema_params":
        want = jstate.ema_params
        got = bridge.state_dict_to_variables(
            tstate.eval_module.state_dict(), module)["params"]
        init = convnext["init"]["params"]
    else:
        want = getattr(jstate, part)
        got = bridge.state_dict_to_variables(module.state_dict(),
                                             module)[part]
        init = convnext["init"][part]
    got, init = dict(bridge._flatten(got)), dict(bridge._flatten(init))
    want = dict(bridge._flatten(jax.device_get(want)))
    assert set(got) == set(want) == set(init)
    top = max(np.abs(want[p] - init[p]).max() for p in want)
    moved = 0
    for path in want:
        change = np.abs(want[path] - init[path]).max()
        if "/".join(path) in ZERO_GRADIENT:
            # rounding alone moves them, in either package
            for side in (want, got):
                assert np.abs(side[path] - init[path]).max() <= 1e-6 * top
            continue
        moved += change > 0
        err = np.abs(got[path] - want[path]).max()
        ulps = 2 * np.finfo(np.float32).eps * np.abs(want[path]).max()
        assert err <= SLICE_TOL * change + ulps, (
            f"{part}: {'/'.join(path)} differs by {err:.3e}, "
            f"{err / max(change, 1e-30):.3e} of its change {change:.3e}")
    assert moved > 0.9 * len(want)


# ------------------------------------------------------ the registry entries

@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_registry_defaults_match_jax(name):
    """A config that names only the backbone builds JAX's defaults (stage
    widths: EfficientRep 64/128/256, ResNet-18 128/256/512,
    ConvNeXt-T 192/384/768, GhostNet-1.0 40/112/160, VGG 256/512/512,
    MobileNeXt 128/256/512): the same flax tree and output widths."""
    cfg = {"name": name}
    tmod = tdet.BACKBONES[name](copy.deepcopy(cfg), None, (SIZE, SIZE))
    jmod = jdet.BACKBONES[name](copy.deepcopy(cfg))
    tree, outs = _flax_tree(jmod, jnp.zeros((1, SIZE, SIZE, 3)))
    variables = bridge.state_dict_to_variables(tmod.state_dict(), tmod)
    assert jax.tree.map(np.shape, {k: v for k, v in variables.items()
                                   if v}) == tree
    assert tmod.out_channels == [o.shape[-1] for o in outs] == {
        "efficientrep": [64, 128, 256], "resnet": [128, 256, 512],
        "convnext": [192, 384, 768], "ghostnet": [40, 112, 160],
        "vgg": [256, 512, 512], "mobilenext": [128, 256, 512]}[name]


def test_registry_ignores_the_keys_a_class_lacks():
    """As the JAX package's `_extras`: GhostNet reads neither `depths` nor
    `channels`, VGG no `depths`; ConvNeXt takes no compute dtype."""
    for name, cfg in (("ghostnet", {"depths": [1, 1, 1, 1],
                                    "channels": [8, 16, 32, 64]}),
                      ("vgg", {"depths": [1, 1, 1, 1],
                               "channels": [8, 16, 32, 64, 64]})):
        cfg = {"name": name, **cfg}
        tmod = tdet.BACKBONES[name](copy.deepcopy(cfg), None, (SIZE, SIZE))
        tree, _ = _flax_tree(jdet.BACKBONES[name](copy.deepcopy(cfg)),
                             jnp.zeros((1, SIZE, SIZE, 3)))
        variables = bridge.state_dict_to_variables(tmod.state_dict(), tmod)
        assert jax.tree.map(np.shape, {k: v for k, v in variables.items()
                                       if v}) == tree, name
    assert "dtype" not in inspect.signature(tx.ConvNeXt).parameters
    tmod = tdet.BACKBONES["convnext"]({"name": "convnext"}, torch.bfloat16,
                                      (SIZE, SIZE))
    assert all(p.dtype == torch.float32 for p in tmod.parameters())


@pytest.fixture(scope="module", params=sorted(EXTRAS))
def config_pair(request):
    """An extra backbone's tiny detector: the port model and the flax tree
    a JAX init would make."""
    cfg = _detector_cfg(request.param)
    tmodel = tdet.build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                              input_size=(SIZE, SIZE))
    jmodel = jdet.build_model(copy.deepcopy(cfg), NUM_CLASSES)
    want = jax.eval_shape(lambda k: jmodel.init(k, input_size=(SIZE, SIZE)),
                          jax.random.key(0))
    return request.param, cfg, tmodel, jax.tree.map(lambda v: v.shape,
                                                    dict(want))


def test_detector_builds_and_round_trips(config_pair):
    """Every tensor maps to the flax tree's leaf of the same shape and
    back; a forward at 64 px gives the three levels; the bare convs'
    biases and ConvNeXt's layer scale start at flax's init."""
    name, _, tmodel, want = config_pair
    module = tmodel.module
    variables = bridge.state_dict_to_variables(module.state_dict(), module)
    variables = {k: v for k, v in variables.items() if v}
    assert jax.tree.map(np.shape, variables) == want, name
    back = bridge.variables_to_state_dict(variables, module)
    for key, t in module.state_dict().items():
        assert torch.equal(back[key], t), key
    backbone = module.backbone
    for key, t in backbone.state_dict().items():
        if key.endswith("gamma"):
            assert torch.all(t == torch.tensor(1e-6))
        if key.endswith(".bias") and key.split(".")[-2].startswith(
                ("se_fc", "stem", "down", "dwconv", "pwconv")):
            assert not t.any(), key
    with torch.no_grad():
        maps = module(torch.zeros(1, SIZE, SIZE, 3))
    assert [tuple(m.shape) for m in maps] == [
        (1, SIZE // s, SIZE // s, 5 + NUM_CLASSES) for s in (8, 16, 32)]


def test_decayed_parameters_are_the_flax_kernels(config_pair):
    """Weight decay reaches the conv and dense kernels, flax's `kernel`
    leaves, only: not ConvNeXt's `gamma` or LayerNorms, not GhostNet's SE
    biases."""
    name, cfg, tmodel, want = config_pair
    optimizer, _ = build_optimizer(tmodel.module, cfg["optimizer"], 10)
    decayed, rest = optimizer.param_groups
    names = {id(p): n for n, p in tmodel.module.named_parameters()}
    got = {names[id(p)] for p in decayed["params"]}
    mask = _kernel_mask(jax.tree.map(np.zeros, want["params"]))
    flax_kernels = {"/".join(p) for p, m in
                    bridge._flatten(jax.tree.map(np.asarray, mask)).items()
                    if m}
    assert {n.replace(".", "/")[:-len("/weight")] + "/kernel"
            for n in got} == flax_kernels, name
    assert len(got) + len(rest["params"]) == len(names)
    assert rest["weight_decay"] == 0.0
