"""Port parity: the training path of `pl_yolo_tpu_torch` (train-mode
BatchNorm, LR schedule, optimizers, EMA, and the train step as a whole)
against the JAX package on the CPU, fp32, from bridged weights and seeded
numpy inputs. The model is tiny YOLOX (widths 8..128, depth 1) at 64 px.

Tolerances are stated at each test. flax computes a batch variance as
E[x^2] - E[x]^2 where torch takes two passes, and every sum runs in another
order, so equality is to fp32 rounding, not bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch import nn

from pl_yolo_tpu.layers import blocks as jb
from pl_yolo_tpu.layers.schedules import cosine_warmup_schedule as jax_schedule
from pl_yolo_tpu.models.detector import build_model as jax_build_model
from pl_yolo_tpu.train import state as jstate_mod
from pl_yolo_tpu.train.ema import ema_update as jax_ema_update
from pl_yolo_tpu.train.optim import build_optimizer as jax_build_optimizer
from pl_yolo_tpu_torch import bridge
from pl_yolo_tpu_torch.layers import blocks as tb
from pl_yolo_tpu_torch.layers.schedules import cosine_warmup_schedule
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.train.ema import ema_update
from pl_yolo_tpu_torch.train.optim import build_optimizer
from pl_yolo_tpu_torch.train.state import (TrainState, make_eval_step,
                                           make_train_step)
from pl_yolo_tpu_torch.utils.config import (CONFIG_DIR, load_config,
                                            validate_model_config)
from tests.test_torch_blocks import _randomize

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

NUM_CLASSES, SIZE = 3, 64


@pytest.fixture(autouse=True)
def _fp32_compute():
    """The JAX package's compute dtype is global state; these tests run fp32."""
    prev = jb.get_compute_dtype()
    jb.set_compute_dtype(None)
    yield
    jb.set_compute_dtype(prev)


def _assert_trees_close(got, want, what, rtol, atol):
    got = dict(bridge._flatten(got))
    want = dict(bridge._flatten(jax.device_get(want)))
    assert set(got) == set(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {'/'.join(path)}")


# ------------------------------------------------------- train-mode BatchNorm

BN_CASES = {
    "conv3x3": (lambda: jb.ConvBlock(12, ksize=3),
                lambda: tb.ConvBlock(8, 12, 3), 8, 16),
    "dwconv": (lambda: jb.DWConvBlock(12, ksize=3, stride=2),
               lambda: tb.DWConvBlock(8, 12, 3, stride=2), 8, 16),
    "csp": (lambda: jb.CSPLayer(16, num_bottle=2),
            lambda: tb.CSPLayer(8, 16, num_bottle=2), 8, 16),
    "focus": (lambda: jb.Focus(16, ksize=3),
              lambda: tb.Focus(3, 16, ksize=3), 3, 32),
    # 2x2 maps at B=2: n = 8 values a channel, where the unbiased variance
    # torch's own BatchNorm2d would keep is 14% off
    "conv_n8": (lambda: jb.ConvBlock(12, ksize=3),
                lambda: tb.ConvBlock(8, 12, 3), 8, 2),
}


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_train_mode_block_and_running_stats_match_flax(name):
    """Output and new running stats (momentum 0.97/0.03, biased variance) to
    rtol=atol=1e-5: fp32 on both sides, variance by another formula."""
    make_j, make_t, cin, size = BN_CASES[name]
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (2, size, size, cin)).astype(np.float32)
    jmod = make_j()
    variables = _randomize(jmod.init(jax.random.key(0), jnp.asarray(x), False),
                           rng)
    want, mutated = jmod.apply(variables, jnp.asarray(x), True,
                               mutable=["batch_stats"])
    tmod = bridge.load_variables(make_t(), variables).train()
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    new = bridge.state_dict_to_variables(tmod.state_dict())
    _assert_trees_close(new["batch_stats"], mutated["batch_stats"],
                        "batch_stats", rtol=1e-5, atol=1e-5)
    for m in tmod.modules():
        if isinstance(m, nn.BatchNorm2d):
            assert isinstance(m, tb.BatchNorm2d)
            assert int(m.num_batches_tracked) == 1


def test_eval_mode_leaves_running_stats_alone():
    m = tb.ConvBlock(4, 6, 3).eval()
    before = copy.deepcopy(m.state_dict())
    with torch.no_grad():
        m(torch.rand(2, 4, 8, 8))
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_bf16_train_mode_keeps_fp32_stats():
    m = tb.ConvBlock(4, 8, 3, dtype=torch.bfloat16).train()
    y = m(torch.rand(2, 4, 8, 8))
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16
    assert m.bn.running_var.dtype == torch.float32
    assert m.conv.weight.grad.dtype == torch.float32
    assert not torch.equal(m.bn.running_mean, torch.zeros(8))


# ------------------------------------------------------------------ schedule

@pytest.mark.parametrize("base_lr,warmup,total", [(0.01, 0.1, 1000),
                                                  (0.1, 0.3, 10),
                                                  (0.01, 0.0, 50)])
def test_schedule_matches_jax_over_the_horizon(base_lr, warmup, total):
    """The JAX schedule computes in fp32: rtol 1e-5, atol 1e-6 x base_lr
    (the cosine's absolute error where the factor nears 0)."""
    want_fn = jax_schedule(base_lr, warmup * total, total)
    got_fn = cosine_warmup_schedule(base_lr, warmup * total, total)
    steps = np.arange(total + 1)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(steps)))
    got = np.array([got_fn(int(s)) for s in steps])
    assert all(isinstance(got_fn(int(s)), float) for s in steps[:3])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * base_lr)


def test_schedule_drives_a_lambda_lr():
    fn = cosine_warmup_schedule(0.5, 2.0, 10)
    opt = torch.optim.SGD([nn.Parameter(torch.zeros(1))], lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, fn)
    for n in range(4):
        assert opt.param_groups[0]["lr"] == pytest.approx(fn(n))
        opt.step()
        sched.step()


# ----------------------------------------------------------------- optimizer

class _SmallNet(nn.Module):
    """A conv with BatchNorm and a biased conv: a decayed weight, a BN
    weight/bias pair and a conv bias (no decay)."""

    def __init__(self):
        super().__init__()
        self.c1 = tb.ConvBlock(3, 4, 3)
        self.c2 = nn.Conv2d(4, 2, 1)


def _set_grads(module, grads_tree):
    sd = bridge.variables_to_state_dict({"params": grads_tree})
    for name, p in module.named_parameters():
        p.grad = sd[name].clone()


OPT_CASES = {
    "sgd": dict(name="SGD", momentum=0.9, weight_decay=0.05),
    "sgd_nesterov": dict(name="SGD", momentum=0.8, nesterov=True,
                         weight_decay=0.05),
    "sgd_clip": dict(name="SGD", momentum=0.9, weight_decay=0.05,
                     clip_grad_norm=0.5),
    "sgd_clip_idle": dict(name="SGD", momentum=0.9, clip_grad_norm=1e6),
    "adamw": dict(name="AdamW", weight_decay=0.05),
    "adamw_clip": dict(name="AdamW", weight_decay=0.05, clip_grad_norm=0.5),
    "adam": dict(name="Adam", weight_decay=0.05),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_updates_match_optax(case):
    """Five updates from the same gradients: params to rtol 1e-5, atol 1e-6
    (the same fp32 formulas in another operation order). Adam and AdamW get
    atol 1e-5: optax takes the bias correction 1 - b2^t in fp32, a
    cancellation that leaves ~6e-5 of relative error in the size of the
    first updates (0.1 each here), where torch takes it in python floats.
    The short horizon puts the five learning rates between 0 and the base
    rate."""
    opt_cfg = dict(OPT_CASES[case], learning_rate=0.1, warmup=0.3)
    rng = np.random.default_rng(3)
    net = _SmallNet()
    params = _randomize(bridge.state_dict_to_variables(
        {k: v for k, v in net.state_dict().items()
         if "running" not in k and "num_batches" not in k})["params"], rng)
    net.load_state_dict(bridge.variables_to_state_dict({"params": params}),
                        strict=False)
    tx, jsched = jax_build_optimizer(opt_cfg, total_steps=10)
    optimizer, tsched = build_optimizer(net, opt_cfg, total_steps=10)
    jparams, opt_state = params, tx.init(params)
    for n in range(5):
        grads = jax.tree.map(
            lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _set_grads(net, grads)
        optimizer.step()
        assert optimizer.param_groups[0]["lr"] == pytest.approx(
            float(jsched(n)), rel=1e-5, abs=1e-9)
        assert tsched(n) == optimizer.param_groups[0]["lr"]
    assert optimizer.updates == 5
    got = bridge.state_dict_to_variables(
        {k: v for k, v in net.named_parameters()})["params"]
    _assert_trees_close(got, jparams, case, rtol=1e-5,
                        atol=1e-5 if case.startswith("adam") else 1e-6)
    if case == "sgd":
        trace = [s for s in jax.tree.leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
            if isinstance(s, optax.TraceState)][0].trace
        _assert_trees_close(bridge.momentum_to_trace(optimizer, net), trace,
                            "momentum", rtol=1e-5, atol=1e-6)


def test_weight_decay_reaches_conv_weights_only():
    net = _SmallNet()
    optimizer, _ = build_optimizer(net, dict(name="SGD", weight_decay=0.01), 10)
    decayed, plain = optimizer.param_groups
    assert decayed["weight_decay"] == 0.01 and plain["weight_decay"] == 0.0
    assert {id(p) for p in decayed["params"]} == {id(net.c1.conv.weight),
                                                  id(net.c2.weight)}
    assert {id(p) for p in plain["params"]} == {
        id(net.c1.bn.weight), id(net.c1.bn.bias), id(net.c2.bias)}


def test_momentum_round_trip_through_the_bridge():
    net = _SmallNet()
    optimizer, _ = build_optimizer(net, dict(name="SGD"), 10)
    rng = np.random.default_rng(4)
    trace = _randomize(bridge.state_dict_to_variables(
        dict(net.named_parameters()))["params"], rng)
    bridge.load_momentum(optimizer, net, trace)
    assert optimizer.state[net.c1.conv.weight]["momentum_buffer"].shape == \
        net.c1.conv.weight.shape
    _assert_trees_close(bridge.momentum_to_trace(optimizer, net), trace,
                        "momentum", rtol=0, atol=0)
    del trace["c2"]
    with pytest.raises(KeyError, match="momentum trace mismatch"):
        bridge.load_momentum(optimizer, net, trace)


def test_unported_optimizer_options_raise():
    """An unknown optimizer raises; `accumulate_steps` is ported
    (test_torch_options holds it to optax.MultiSteps)."""
    net = _SmallNet()
    optimizer, _ = build_optimizer(net, dict(name="SGD", accumulate_steps=4),
                                   10)
    assert optimizer.accumulate_steps == 4 and optimizer.mini_step == 0
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        build_optimizer(net, dict(name="LAMB"), 10)


# ----------------------------------------------------------------------- EMA

@pytest.mark.parametrize("updates", [1, 10, 5000])
def test_ema_update_matches_jax(updates):
    """Params and BN running stats, rtol 1e-6 + atol 1e-7: one fp32 lerp,
    its decay computed in fp32 there and in python floats here."""
    rng = np.random.default_rng(5)
    new, ema = _SmallNet(), _SmallNet().eval().requires_grad_(False)
    new_vars = _randomize(bridge.state_dict_to_variables(new.state_dict()), rng)
    ema_vars = _randomize(bridge.state_dict_to_variables(ema.state_dict()), rng)
    bridge.load_variables(new, new_vars)
    bridge.load_variables(ema, ema_vars)
    new.c1.bn.num_batches_tracked.fill_(7)
    want = jax_ema_update(ema_vars, new_vars, jnp.asarray(updates, jnp.int32))
    ema_update(ema, new, updates)
    _assert_trees_close(bridge.state_dict_to_variables(ema.state_dict()), want,
                        "ema", rtol=1e-6, atol=1e-7)
    assert int(ema.c1.bn.num_batches_tracked) == 7


# ------------------------------------------------- the train slice as a whole

def _tiny_cfg():
    cfg = validate_model_config(load_config(
        CONFIG_DIR / "model" / "yolox_s.yaml"))
    cfg["backbone"]["channels"] = [8, 16, 32, 64, 128]
    cfg["backbone"]["depths"] = [1, 1, 1, 1]
    cfg["neck"]["channels"] = [32, 64, 128]
    cfg["head"]["channels"] = [32, 64, 128]
    cfg["dtype"] = None  # fp32 on both sides (yolox_s.yaml says bfloat16)
    return cfg


def _batch(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (batch, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((batch, 6, 5), np.float32)
    labels[:, :3, 0] = rng.integers(0, NUM_CLASSES, (batch, 3))
    labels[:, :3, 1:3] = rng.uniform(12, 52, (batch, 3, 2))
    labels[:, :3, 3:] = rng.uniform(8, 40, (batch, 3, 2))
    return images, labels


# A short horizon, so that the updates run at real learning rates: ~0, then
# 0.98 and 0.90 of the base rate. The base rate is 0.0005 here, not the
# yaml's 0.01: the random tiny model's gradient norm is ~700 at B=2, and at
# 0.01 the second update throws the wh logits into exp() overflow, where
# rounding differences between the frameworks grow a thousandfold.
TOTAL_STEPS, N_STEPS, BASE_LR = 10, 3, 0.0005


@pytest.fixture(scope="module")
def trained():
    """Three train steps, without augmentation, in both packages from the
    same weights, images and labels."""
    jb.set_compute_dtype(None)
    cfg = _tiny_cfg()
    cfg["optimizer"]["learning_rate"] = BASE_LR
    images, labels = _batch()
    jmodel = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
    # jitted: eagerly, a flax init compiles its ops one by one
    variables = jax.device_get(jax.jit(lambda k: jmodel.init(
        k, input_size=(SIZE, SIZE)))(jax.random.key(0)))
    tx, _ = jax_build_optimizer(cfg["optimizer"], total_steps=TOTAL_STEPS)
    jstate = jstate_mod.TrainState.create(variables, tx)
    jstep = jstate_mod.make_train_step(
        jmodel.module.apply, jmodel.loss.train_loss, donate=False)
    jlosses = []
    for i in range(N_STEPS):
        jstate, losses = jstep(jstate, jnp.asarray(images),
                               jnp.asarray(labels), jax.random.key(i),
                               use_l1=jnp.asarray(1.0))
        jlosses.append(jax.device_get(losses))

    tmodel = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu")
    bridge.load_variables(tmodel.module, variables)
    optimizer, schedule = build_optimizer(tmodel.module, cfg["optimizer"],
                                          total_steps=TOTAL_STEPS)
    tstate = TrainState.create(tmodel.module, optimizer)
    tstep = make_train_step(tmodel.loss.train_loss)
    tlosses = [tstep(tstate, torch.from_numpy(images),
                     torch.from_numpy(labels), use_l1=torch.tensor(1.0))
               for _ in range(N_STEPS)]
    return dict(jmodel=jmodel, jstate=jstate, jlosses=jlosses, tmodel=tmodel,
                tstate=tstate, tlosses=tlosses, init=variables,
                schedule=schedule, images=images)


# What the slice's tolerances rest on. At this size the train-mode network is
# badly conditioned in fp32: BatchNorm over as few as 8 values a channel,
# ~70 layers deep, on 0-255 inputs. On the first step's batch the two
# packages' head maps sit 2e-5 of their scale apart (the JAX maps 1.3e-4 and
# the port's 3e-5 from a float64 run of the port), and their parameter
# gradients 1e-4 (median) to 4e-4 (worst tensor) of each tensor's scale apart.
# Three steps carry that along: the worst tensor of the momentum trace ends
# 2.4e-3 of its scale apart. So a state tensor is compared by its change
# since the initial state, to 5e-3 of that change's scale (plus two ulps of
# the value itself), and a loss to rtol 1e-3. That still tells the biased
# from the unbiased variance (14% here), one learning rate of the schedule
# from the next (8%) and a wrong momentum. Sharper checks of the update
# rules are the optimizer, BatchNorm and EMA tests above, which feed both
# sides the same gradients.
SLICE_TOL = 5e-3


def test_train_step_losses_match_jax_step_by_step(trained):
    assert [lr > 0.8 * BASE_LR for lr in
            map(trained["schedule"], range(N_STEPS))] == [False, True, True]
    for step, (tl, jl) in enumerate(zip(trained["tlosses"],
                                        trained["jlosses"])):
        assert set(tl) == set(jl)
        assert float(jl["proportion"]) > 0 and float(jl["loss_l1"]) > 0
        for k in jl:
            assert not tl[k].requires_grad
            np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-3,
                                       atol=1e-5, err_msg=f"step {step}: {k}")


@pytest.mark.parametrize("part", ["params", "batch_stats", "ema_params",
                                  "ema_batch_stats", "momentum"])
def test_train_state_after_three_steps_matches_jax(trained, part):
    """Every piece of the state, as its change since the initial state:
    max |port - jax| <= SLICE_TOL x max |jax change| (+ 2 ulps) per tensor.
    `batch_stats` holds the biased variance on both sides."""
    jstate, tstate = trained["jstate"], trained["tstate"]
    assert tstate.step == int(jstate.step) == N_STEPS
    raw = bridge.state_dict_to_variables(tstate.raw_module.state_dict())
    ema = bridge.state_dict_to_variables(tstate.eval_module.state_dict())
    if part == "momentum":
        want = [s for s in jax.tree.leaves(
            jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
            if isinstance(s, optax.TraceState)][0].trace
        got = bridge.momentum_to_trace(tstate.optimizer, tstate.module)
        init = jax.tree.map(np.zeros_like, trained["init"]["params"])
    elif part.startswith("ema_"):
        want, got = getattr(jstate, part), ema[part[len("ema_"):]]
        init = trained["init"][part[len("ema_"):]]
    else:
        want, got, init = getattr(jstate, part), raw[part], trained["init"][part]
    got, init = dict(bridge._flatten(got)), dict(bridge._flatten(init))
    want = dict(bridge._flatten(jax.device_get(want)))
    assert set(got) == set(want) == set(init)
    moved = 0
    for path in want:
        change = np.abs(want[path] - init[path]).max()
        moved += change > 0  # a branch no foreground anchor reaches stays put
        err = np.abs(got[path] - want[path]).max()
        ulps = 2 * np.finfo(np.float32).eps * np.abs(want[path]).max()
        assert err <= SLICE_TOL * change + ulps, (
            f"{part}: {'/'.join(path)} differs by {err:.3e}, "
            f"{err / change:.3e} of its change {change:.3e}")
    assert moved > 0.9 * len(want)


def test_ema_copy_is_in_eval_mode_and_takes_no_gradient(trained):
    tstate = trained["tstate"]
    assert tstate.eval_module is tstate.ema_module is not tstate.raw_module
    assert not tstate.ema_module.training and tstate.raw_module.training
    assert not any(p.requires_grad for p in tstate.ema_module.parameters())
    no_ema = TrainState.create(tstate.module, tstate.optimizer, use_ema=False)
    assert no_ema.ema_module is None and no_ema.eval_module is no_ema.module


def test_eval_step_on_ema_weights_matches_jax(trained):
    """Decoded predictions of the EMA weights after the three steps, to
    rtol=atol=1e-3: the eval forward's own 1e-4 (see the inference slice)
    on weights that already differ as the state test allows."""
    jeval = jstate_mod.make_eval_step(trained["jmodel"].module.apply,
                                      trained["jmodel"].loss.eval_decode)
    want = np.asarray(jeval(trained["jstate"].eval_variables,
                            jnp.asarray(trained["images"])))
    teval = make_eval_step(trained["tmodel"].loss.eval_decode)
    got = teval(trained["tstate"].eval_module,
                torch.from_numpy(trained["images"]))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_step_takes_uint8_images_and_reports_gradient_health():
    cfg = _tiny_cfg()
    images, labels = _batch(seed=1)
    images = np.floor(images)
    results = []
    for feed in (torch.from_numpy(images),
                 torch.from_numpy(images.astype(np.uint8))):
        model = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu")
        optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 10)
        state = TrainState.create(model.module, optimizer, use_ema=False)
        step = make_train_step(model.loss.train_loss, sanitize=True)
        losses = step(state, feed, torch.from_numpy(labels))
        grads = [p.grad for p in model.module.parameters()]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        assert losses["grad_norm"].item() == pytest.approx(norm.item(), rel=1e-5)
        assert losses["nonfinite_grads"].item() == 0.0
        assert losses["loss_l1"].item() == 0.0  # the config's use_l1 default
        results.append(losses["loss"])
    assert torch.equal(*results)


def test_train_state_follows_the_module_and_models_default_to_cuda():
    """The chain starts at `build_model`, which takes the card unless asked
    for the CPU; the optimizer, the EMA copy and the step live where the
    module lives."""
    cfg = _tiny_cfg()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg, NUM_CLASSES)
    module = build_model(cfg, NUM_CLASSES, device="cpu").module
    optimizer, _ = build_optimizer(module, cfg["optimizer"], 10)
    state = TrainState.create(module, optimizer)
    devices = {p.device.type for g in optimizer.param_groups
               for p in g["params"]}
    devices |= {t.device.type for t in state.ema_module.state_dict().values()}
    assert devices == {"cpu"} and state.step == 0


# ------------------------------------------------------------- config copies

@pytest.mark.parametrize(
    "path", sorted((CONFIG_DIR / "model").glob("*.yaml"))
    + sorted((CONFIG_DIR / "data").glob("*.yaml")),
    ids=lambda p: p.name if p.parent.name == "model" else f"data/{p.name}")
def test_config_copy_equals_the_jax_packages(path):
    original = (CONFIG_DIR.parents[1] / "pl_yolo_tpu" / "configs"
                / path.parent.name / path.name)
    assert load_config(path) == yaml.safe_load(original.read_text())
    assert path.read_bytes() == original.read_bytes()


def test_all_yolox_configs_are_copied():
    """The model YAMLs the port builds: the YOLOX family (with DropBlock,
    ZeRO, and tensor x spatial parallelism), the anchor families (YOLOv7, YOLOv5-s), the transformer
    backbones (Swin, ViT with and without MoE, the pipelined ViT, ResTv2,
    MCTformer) and e-YOLOX."""
    names = {p.name for p in (CONFIG_DIR / "model").glob("*.yaml")}
    assert names == (
        {f"yolox_{s}.yaml" for s in ("nano", "tiny", "s", "m", "l", "x",
                                     "s_dropblock", "s_zero", "s_tp2sp2")}
        | {f"{n}.yaml" for n in ("yolov7", "yolov7_tiny", "al_yolov7",
                                 "al_yolov7_tiny", "gc10_yolov7",
                                 "neu_yolov7", "neu_yolov7_tiny",
                                 "yolov5_s")}
        | {f"{n}.yaml" for n in ("swin_tiny", "swin_small", "swin_base",
                                 "swin_large", "vit_tiny", "vit_tiny_moe",
                                 "vit_tiny_pp2",
                                 "restv2_tiny", "mctformer_small")}
        | {f"e-yolox_{s}.yaml" for s in ("tiny", "s", "m", "l", "x")})
