"""Port parity for the YOLOX trainer's remaining options, against the JAX
package on the CPU, fp32, at tiny widths and 64-96 px: DropBlock and
DropPath (`layers/drops.py`), `norm: ln`, `remat: true`, `optimizer:
{accumulate_steps}`, `multiscale_resize` and the multi-scale buckets, and
the general-gather augmentation (degrees, shear, perspective).

Random draws: the port draws up front into tensors, the JAX package inside
its functions from a key. Each test hands both sides the same numbers (the
JAX key's Bernoulli draws, `_jax_draws` of `test_torch_augment`), and the
port's own draws are held to their distributions. Tolerances are stated at
each test.
"""

import copy
import types

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pl_yolo_tpu.data import augment as ja
from pl_yolo_tpu.layers import blocks as jb
from pl_yolo_tpu.layers import drops as jd
from pl_yolo_tpu.models.backbones.cspdarknet import CSPDarkNet as JCSPDarkNet
from pl_yolo_tpu.models.detector import build_model as jax_build_model
from pl_yolo_tpu.train import trainer as jtrainer_mod
from pl_yolo_tpu.train.ema import ema_update as jax_ema_update
from pl_yolo_tpu.train.optim import build_optimizer as jax_build_optimizer
from pl_yolo_tpu_torch import bridge
from pl_yolo_tpu_torch.data import augment as ta
from pl_yolo_tpu_torch.layers import blocks as tb
from pl_yolo_tpu_torch.layers import drops as td
from pl_yolo_tpu_torch.models.backbones.cspdarknet import CSPDarkNet
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.ops.cuda.mosaic_warp import mosaic_warp
from pl_yolo_tpu_torch.train.ema import ema_update
from pl_yolo_tpu_torch.train.optim import build_optimizer
from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
from pl_yolo_tpu_torch.train.trainer import Trainer
from synthetic_coco import make_coco
from tests.test_torch_augment import BASE, _jax_draws
from tests.test_torch_augment import _batch as _aug_batch
from tests.test_torch_blocks import _randomize
from tests.test_torch_train import (NUM_CLASSES, SIZE, _assert_trees_close,
                                    _batch, _set_grads, _SmallNet, _tiny_cfg)
from tests.test_torch_trainer import _data_cfg, _model_cfg

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

# the JAX references compile at XLA's backend optimization level 0: the
# same functions, compiled in about three quarters of the time (results
# within an ulp or so of level 2's)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(autouse=True)
def _fp32_no_remat():
    """The JAX package's compute dtype and remat flag are global state that
    its build_model sets; these tests run fp32 and restore both."""
    prev = jb.get_compute_dtype(), jb.get_remat()
    jb.set_compute_dtype(None)
    yield
    jb.set_compute_dtype(prev[0])
    jb.set_remat(prev[1])


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------- drops

@pytest.mark.parametrize("rate,block", [(0.1, 3), (0.3, 7), (0.05, 5)])
def test_drop_block_matches_jax_on_the_same_seeds(rate, block):
    """The JAX seeds (`jax.random.bernoulli` with the same key and gamma,
    NHWC) transposed to NCHW: outputs to 1e-6 (the mean over the mask is
    the same sum of 0s and 1s in another order)."""
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 6)).astype(
        np.float32)
    key = jax.random.key(int(rate * 100) + block)
    want = np.asarray(jd.drop_block_2d(key, jnp.asarray(x), rate, block))
    gamma = td.drop_block_gamma(rate, 16, 16, block)
    seeds = np.asarray(jax.random.bernoulli(key, gamma, x.shape),
                       np.float32)
    got = td.drop_block_2d(_nchw(x), _nchw(seeds), block)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert (want == 0).any()


def test_drop_path_matches_jax_on_the_same_draw():
    x = np.random.default_rng(1).normal(size=(16, 4, 4, 3)).astype(
        np.float32)
    key = jax.random.key(3)
    want = np.asarray(jd.drop_path(key, jnp.asarray(x), 0.25))
    keep = np.array(jax.random.bernoulli(key, 0.75, (16, 1, 1, 1)))
    got = td.drop_path(_nchw(x), torch.from_numpy(keep).permute(0, 3, 1, 2),
                       0.25)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert 0 < keep.sum() < 16


def test_port_draws_follow_their_distributions():
    """The port's own draws: the seed share within 3 sigma of gamma, the
    dropped-sample share within 3 sigma of rate (binomial counts)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(8, 16, 40, 40)
    gamma = td.drop_block_gamma(0.1, 40, 40, 7)
    seeds = td.draw_drop_block(gen, x, 0.1, 7)
    n = seeds.numel()
    assert abs(float(seeds.mean()) - gamma) <= 3 * np.sqrt(
        gamma * (1 - gamma) / n)
    keep = td.draw_drop_path(gen, torch.zeros(20000, 1, 1, 1), 0.2)
    assert keep.shape == (20000, 1, 1, 1) and keep.dtype == torch.bool
    dropped = 1.0 - float(keep.float().mean())
    assert abs(dropped - 0.2) <= 3 * np.sqrt(0.2 * 0.8 / 20000)
    # a generator gives the same draws again; eval mode is the identity
    again = td.draw_drop_block(torch.Generator().manual_seed(0), x, 0.1, 7)
    assert torch.equal(seeds, again)
    m = td.DropBlock2d(0.1, 7).eval()
    assert m(x) is x and td.DropPath(0.2).eval()(x) is x


def test_cspdarknet_train_forward_with_dropblock_matches_jax(monkeypatch):
    """A CSPDarknet in train mode with DropBlock after each stage, both
    packages fed the same seeds (the JAX ones, recorded as drawn, handed to
    the port in stage order): the dropped cells equal (exact zeros), the
    three maps and the new BN statistics to rtol=atol=1e-4. That is the
    bound of the net itself: without DropBlock the same backbone's
    train-mode maps on this 0-255 input sit up to 1.2e-4 apart (fp32
    train-mode BN through ~25 layers, sums in another order; measured on
    the CPU), where single blocks meet 1e-5 (test_torch_train)."""
    kw = dict(depths=(1, 1, 1, 1), channels=(8, 16, 32, 64, 128),
              drop_block_rate=0.2, drop_block_size=3)
    x = np.random.default_rng(2).uniform(0, 255, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    tmod = CSPDarkNet(**kw)
    variables = _randomize(bridge.state_dict_to_variables(tmod.state_dict()),
                           np.random.default_rng(3))
    bridge.load_variables(tmod, variables).train()
    jmod = JCSPDarkNet(**kw)
    drawn = []
    orig = jd.drop_block_2d

    def recording(rng, x, rate, block_size=7, deterministic=False):
        gamma = td.drop_block_gamma(rate, x.shape[1], x.shape[2],
                                    block_size)
        drawn.append(jax.random.bernoulli(rng, gamma, x.shape))
        return orig(rng, x, rate, block_size, deterministic)
    monkeypatch.setattr(jd, "drop_block_2d", recording)

    def forward(v, x):   # jitted: the recorded draws leave as outputs
        out, mutated = jmod.apply(v, x, True, mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.key(5)})
        return out, mutated, list(drawn)
    want, mutated, seeds = _jit(forward)(variables, jnp.asarray(x))
    seeds = [np.asarray(s, np.float32) for s in seeds]
    assert len(seeds) == 4 and all(s.any() for s in seeds)

    feed = iter(_nchw(s) for s in seeds)
    monkeypatch.setattr(td, "draw_drop_block",
                        lambda gen, x, rate, block_size=7: next(feed))
    got = tmod(_nchw(x))
    for g, w in zip(got, want):
        g, w = g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w)
        np.testing.assert_array_equal(g == 0, w == 0)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert (np.asarray(want[-1]) == 0).any()
    new = bridge.state_dict_to_variables(tmod.state_dict())
    _assert_trees_close(new["batch_stats"], mutated["batch_stats"],
                        "batch_stats", rtol=1e-4, atol=1e-4)


def test_train_step_hands_the_dropout_layers_its_generator():
    """The step's generator reaches the DropBlocks (the same seed, the same
    update) and is taken back after the forward."""
    cfg = _tiny_cfg()
    cfg["backbone"]["drop_block"] = {"rate": 0.2, "size": 3}
    images, labels = _batch()
    results = []
    for seed in (4, 4, 5):
        model = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu")
        optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 10)
        state = TrainState.create(model.module, optimizer, use_ema=False)
        losses = make_train_step(model.loss.train_loss)(
            state, torch.from_numpy(images), torch.from_numpy(labels),
            generator=torch.Generator().manual_seed(seed))
        blocks = [m for m in model.module.modules()
                  if isinstance(m, td.DropBlock2d)]
        assert len(blocks) == 4 and all(m.generator is None for m in blocks)
        results.append(float(losses["loss"]))
    assert np.isfinite(results).all()
    assert results[0] == results[1] != results[2]


# ------------------------------------------------------------- norm: ln

LN_CASES = {
    "conv3x3": (lambda: jb.ConvBlock(12, ksize=3, norm="ln"),
                lambda: tb.ConvBlock(8, 12, 3, norm="ln"), 8, 16),
    "dwconv": (lambda: jb.DWConvBlock(12, ksize=3, stride=2, norm="ln"),
               lambda: tb.DWConvBlock(8, 12, 3, stride=2, norm="ln"), 8, 16),
    "focus_fused": (lambda: jb.Focus(16, ksize=3, norm="ln"),
                    lambda: tb.Focus(3, 16, ksize=3, norm="ln"), 3, 32),
}


@pytest.mark.parametrize("name", sorted(LN_CASES))
def test_layernorm_blocks_match_flax_through_the_bridge(name):
    """flax's LayerNorm (eps 1e-6, fast variance) over the channels, its
    `ln/scale` and `ln/bias` moved by the bridge and back unchanged:
    outputs to 1e-5 (fp32, sums in another order)."""
    make_j, make_t, cin, size = LN_CASES[name]
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (2, size, size, cin)).astype(np.float32)
    jmod = make_j()
    variables = _randomize(jmod.init(jax.random.key(0), jnp.asarray(x), False),
                           rng)
    assert any("ln" in p for p in bridge._flatten(variables))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    tmod = bridge.load_variables(make_t(), variables).eval()
    with torch.no_grad():
        got = tmod(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    back = bridge.state_dict_to_variables(tmod.state_dict())
    _assert_trees_close(back["params"], variables["params"], "params",
                        rtol=0, atol=0)


# ----------------------------------------------------------------- remat

def test_bridge_variables_are_copies_of_the_module_state():
    """The bridge's numpy tree does not share memory with the module: a
    train-mode forward after the conversion (BN statistics updated in
    place) leaves it as it was. (It once returned views of the 1-d
    tensors, so a JAX computation dispatched on them asynchronously could
    read statistics the port had updated since.)"""
    module = tb.ConvBlock(3, 4, 3).train()
    variables = bridge.state_dict_to_variables(module.state_dict())
    before = jax.tree.map(np.copy, variables)
    module(torch.rand(2, 3, 8, 8))
    assert not torch.equal(module.bn.running_mean, torch.zeros(4))
    _assert_trees_close(variables, before, "variables", rtol=0, atol=0)


def _step_once(remat):
    """One train step of the tiny model (seeded build), without the update:
    the loss, every gradient and the BN statistics after it."""
    cfg = _tiny_cfg()
    cfg["remat"] = remat
    model = build_model(cfg, NUM_CLASSES, device="cpu", seed=3)
    images, labels = _batch()
    module = model.module.train()
    losses = model.loss.train_loss(module(torch.from_numpy(images)),
                                   torch.from_numpy(labels))
    losses["loss"].backward()
    grads = {k: p.grad.clone() for k, p in module.named_parameters()}
    return model, float(losses["loss"]), grads, module.state_dict()


def test_remat_gives_the_same_loss_gradients_and_one_bn_update():
    """With and without `remat: true`: the loss, every gradient and every
    BN running statistic to 1e-6 (the recompute repeats the same fp32
    ops), and each BatchNorm updated once, not twice."""
    plain, loss, grads, stats = _step_once(False)
    model, loss_r, grads_r, stats_r = _step_once(True)
    assert model.module.backbone.remat and model.module.neck.remat
    assert not plain.module.backbone.remat
    assert loss_r == pytest.approx(loss, rel=1e-6)
    for k in grads:
        torch.testing.assert_close(grads_r[k], grads[k], rtol=1e-6, atol=1e-6)
    for k in stats:
        torch.testing.assert_close(stats_r[k], stats[k], rtol=1e-6, atol=1e-6)
    bns = [m for m in model.module.modules() if isinstance(m, tb.BatchNorm2d)]
    assert all(int(m.num_batches_tracked) == 1 and m.update_stats
               for m in bns)
    # a recompute that updated the statistics would have lerped them twice
    fresh = build_model(_tiny_cfg(), NUM_CLASSES, device="cpu", seed=3)
    m = model.module.backbone.stage1_csp.conv1.bn
    m0 = fresh.module.backbone.stage1_csp.conv1.bn
    once = torch.lerp(m0.running_mean, m.batch_mean, m.momentum)
    torch.testing.assert_close(m.running_mean, once, rtol=1e-6, atol=1e-7)


def test_remat_forward_matches_jax_remat():
    """JAX `remat: true` (nn.remat around the same CSP layers) against the
    port's on the port's seeded weights: train-mode maps and the new BN
    statistics to 1e-4 (the tiny train-mode net's fp32 bound of
    test_torch_model)."""
    cfg = _tiny_cfg()
    cfg["remat"] = True
    tmodel = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                         seed=3)
    jmodel = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
    assert jb.get_remat()
    variables = bridge.state_dict_to_variables(tmodel.module.state_dict())
    images, _ = _batch()
    want, mutated = jax.block_until_ready(_jit(
        lambda v, x: jmodel.module.apply(v, x, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(images)))
    got = tmodel.module.train()(torch.from_numpy(images))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
    new = bridge.state_dict_to_variables(tmodel.module.state_dict())
    _assert_trees_close(new["batch_stats"], mutated["batch_stats"],
                        "batch_stats", rtol=1e-4, atol=1e-4)


# ----------------------------------------------------- accumulate_steps

def test_accumulate_steps_matches_optax_multisteps():
    """`accumulate_steps: 2` over 4 micro-steps against the JAX
    `build_optimizer` (optax.MultiSteps), fed the same gradients, with the
    EMA at each micro-step's count: params, the momentum trace and the EMA
    to 1e-6; the schedule spans total // 2 updates, the same indices."""
    opt_cfg = dict(name="SGD", momentum=0.9, weight_decay=0.05,
                   clip_grad_norm=2.0, learning_rate=0.1, warmup=0.3,
                   accumulate_steps=2)
    rng = np.random.default_rng(4)
    net = _SmallNet()
    params = _randomize(bridge.state_dict_to_variables(
        {k: v for k, v in net.state_dict().items()
         if "running" not in k and "num_batches" not in k})["params"], rng)
    net.load_state_dict(bridge.variables_to_state_dict({"params": params}),
                        strict=False)
    ema_net = copy.deepcopy(net)
    tx, jsched = jax_build_optimizer(opt_cfg, total_steps=20)
    optimizer, tsched = build_optimizer(net, opt_cfg, total_steps=20)
    assert [tsched(n) for n in range(12)] == pytest.approx(
        [float(jsched(n)) for n in range(12)], rel=1e-5, abs=1e-9)
    jparams, jema, opt_state = params, params, tx.init(params)
    before = {k: v.clone() for k, v in net.named_parameters()}
    for n in range(4):
        grads = jax.tree.map(
            lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = jax_ema_update(jema, jparams, jnp.asarray(n + 1))
        _set_grads(net, grads)
        optimizer.step()
        ema_update(ema_net, net, n + 1)
        after = {k: v.clone() for k, v in net.named_parameters()}
        changed = any(not torch.equal(after[k], before[k]) for k in after)
        assert changed == (n % 2 == 1), n
        before = after
        assert optimizer.updates == (n + 1) // 2
        assert optimizer.mini_step == (n + 1) % 2
    assert int(opt_state.gradient_step) == optimizer.updates == 2
    got = bridge.state_dict_to_variables(dict(net.named_parameters()))
    _assert_trees_close(got["params"], jparams, "params", rtol=1e-6,
                        atol=1e-6)
    got = bridge.state_dict_to_variables(dict(ema_net.named_parameters()))
    _assert_trees_close(got["params"], jema, "ema", rtol=1e-6, atol=1e-6)
    trace = [s for s in jax.tree.leaves(
        opt_state.inner_opt_state,
        is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)][0].trace
    _assert_trees_close(bridge.momentum_to_trace(optimizer, net), trace,
                        "momentum", rtol=1e-6, atol=1e-6)


def test_accumulated_train_step_moves_params_every_second_micro_step():
    """The train step under `accumulate_steps: 2`: the params stay between
    updates while the BN statistics, `step` and the EMA move on every
    micro-step."""
    cfg = _tiny_cfg()
    cfg["optimizer"].update(accumulate_steps=2, learning_rate=5e-4)
    model = build_model(cfg, NUM_CLASSES, device="cpu")
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 8)
    state = TrainState.create(model.module, optimizer)
    step = make_train_step(model.loss.train_loss)
    images, labels = _batch()
    w = model.module.head.cls_pred0.weight
    for n in range(4):
        w0 = w.detach().clone()
        bn0 = model.module.backbone.stem.conv.bn.running_mean.clone()
        ema0 = state.ema_module.head.cls_pred0.weight.clone()
        losses = step(state, torch.from_numpy(images),
                      torch.from_numpy(labels))
        assert np.isfinite(float(losses["loss"]))
        assert torch.equal(w, w0) == (n % 2 == 0), n
        assert not torch.equal(model.module.backbone.stem.conv.bn.running_mean,
                               bn0)
        assert state.step == n + 1 and optimizer.updates == (n + 1) // 2
        if n % 2 == 1:
            assert not torch.equal(state.ema_module.head.cls_pred0.weight,
                                   ema0)


# -------------------------------------------------- multi-scale buckets

@pytest.mark.parametrize("out_hw", [(96, 96), (48, 80), (64, 64)])
def test_multiscale_resize_matches_jax(out_hw):
    """Up, down, two aspect ratios and the identity: pixels to 1e-5 (the
    same fp32 lerps, op by op; JAX's column pass is a 2-sparse
    contraction), labels equal."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    lab = rng.uniform(0, 60, (2, 7, 5)).astype(np.float32)
    wi, wl = ja.multiscale_resize(jnp.asarray(x), jnp.asarray(lab), out_hw)
    gi, gl = ta.multiscale_resize(torch.from_numpy(x), torch.from_numpy(lab),
                                  out_hw)
    assert gi.shape == (2,) + tuple(out_hw) + (3,) and gi.is_contiguous()
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


# 16 images at B=8 (the JAX trainer's 8 host devices each take a row): 2
# steps an epoch, the last epoch without augmentation
MS_EPOCHS, MS_SIZES, MS_INTERVAL, MS_BATCH = 5, [[32, 32], [96, 96]], 2, 8


def _ms_data_cfg(root):
    cfg = _data_cfg(root)
    cfg["dataset"]["train_batch_size"] = MS_BATCH
    cfg["transform"].update(multiscale_sizes=MS_SIZES,
                            multiscale_interval=MS_INTERVAL)
    return cfg


def _jax_bucket_sequence(root, tmp_path, monkeypatch):
    """The JAX trainer's fit with its steps recorded in place of run: the
    bucket index of each step (the model, the optimizer state, the
    summary and the validation are stubbed out; the loop, its data and its
    bucket draws are the JAX trainer's own)."""
    made, calls = [], []

    def fake_make_train_step(*args, **kw):
        index = len(made)

        def step(state, images, labels, rng, **flags):
            calls.append(index)
            return state, {"loss": jnp.zeros(())}
        made.append(step)
        return step
    monkeypatch.setattr(jtrainer_mod, "make_train_step", fake_make_train_step)
    monkeypatch.setattr(jtrainer_mod, "model_summary",
                        lambda *a, **k: (0, 0, ""))
    monkeypatch.setattr(jtrainer_mod.Trainer, "_build_state",
                        lambda self, total: types.SimpleNamespace(
                            step=0, raw_variables=None))
    monkeypatch.setattr(jtrainer_mod.Trainer, "validate",
                        lambda self, *a, **k: (0.0, 0.0))
    monkeypatch.setattr(jtrainer_mod.Trainer, "_save", lambda self, *a: None)
    trainer = jtrainer_mod.Trainer(
        _model_cfg(), _ms_data_cfg(root), max_epochs=MS_EPOCHS,
        check_val_every_n_epoch=MS_EPOCHS, output_dir=str(tmp_path / "jax"),
        logger="csv", log_every_n_steps=10 ** 6)
    trainer.fit()
    assert len(made) == 1 + len(MS_SIZES)
    return calls


def test_bucket_sequence_equals_the_jax_trainers(tmp_path, monkeypatch):
    """`Trainer.fit` with `multiscale_sizes` [[32,32],[96,96]] on a 64 px
    base, switched every 2 steps, 5 epochs of 2 steps, the last without
    augmentation: the bucket of each step equals the JAX trainer's (same
    seed), each bucket's step sees its size, and the no-aug epoch runs at
    the base size on the s2d route."""
    root = make_coco(tmp_path / "coco", num_images=16)
    want = _jax_bucket_sequence(root, tmp_path, monkeypatch)
    trainer = Trainer(_model_cfg(), _ms_data_cfg(root), max_epochs=MS_EPOCHS,
                      check_val_every_n_epoch=MS_EPOCHS,
                      output_dir=str(tmp_path / "port"), logger="csv",
                      device="cpu")
    sizes = [(64, 64)] + [tuple(s) for s in MS_SIZES]
    buckets, seen = [], []
    make_step = trainer.make_step

    def recording_make_step(out_hw=None):
        step_fn = make_step(out_hw)

        def step(*args, **kw):
            buckets.append(sizes.index(out_hw or (64, 64)))
            return step_fn(*args, **kw)
        return step
    trainer.make_step = recording_make_step
    trainer.model.module.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)) if m.training
        else None)
    trainer.fit()
    assert buckets == want
    assert len(want) == MS_EPOCHS * 2 and len(set(want[:8])) > 1
    assert want[8:] == [0] * 2
    for bucket, shape in zip(want, seen):
        if bucket == 0:   # the stem's space-to-depth input
            assert shape == (MS_BATCH, 32, 32, 12)
        else:
            assert shape == (MS_BATCH,) + sizes[bucket] + (3,)
    assert np.isfinite(trainer.best_map)


# ------------------------------------------------ the general-gather path

GENERAL = dict(degrees=10.0, shear=2.0, perspective=0.0005)
# (pixel dtype, enable, out_s2d), each axis both ways (enable=False computes
# the general mosaic and gates it off, as the separable route's tests show).
# The JAX reference runs jitted: compiled once, not op by op. Pixel bounds
# (max, mean |diff|, grey levels):
# * fp32: the 3x3 affine products and their inverse round differently in
#   the two libraries (the matrices ~1e-5 apart, as
#   test_affine_matrix_and_points_match_jax allows), i.e. source
#   coordinates ~1e-5 px apart, and a noise image moves up to 255 grey
#   levels a pixel (~85 on average): 1e-2 and 1e-3;
# * bf16: the lerps round in bf16 on both sides; the bf16 bounds of
#   test_device_augment_matches_jax, 8 and 0.5.
GENERAL_CASES = [("float32", True, False), ("bfloat16", False, True)]


@pytest.mark.parametrize("dtype,enable,out_s2d", GENERAL_CASES)
def test_general_gather_augment_matches_jax(dtype, enable, out_s2d):
    """`device_augment` with degrees 10, shear 2 and perspective 5e-4 on
    the same draws: labels to 1e-4 px (fp32 rounding of the 3-term point
    products) with the same kept set, pixels to the bounds above; neither
    side's kernel runs (the port's mosaic_warp is not launched)."""
    cfg = dict(BASE, pixel_dtype=dtype, **GENERAL)
    jcfg = ja.AugmentConfig(**cfg)
    key = jax.random.key(7)
    draws, _ = _jax_draws(key, 4, 64, 64, jcfg)
    assert bool((draws.affine[:, 0] != 0).all())
    images, labels = _aug_batch()
    images = images.astype(np.uint8)
    want_img, want_lab = _jit(
        ja.device_augment, static_argnames=("cfg", "out_s2d"))(
        key, jnp.asarray(images), jnp.asarray(labels), cfg=jcfg,
        enable=enable, out_s2d=out_s2d)
    before = mosaic_warp.launches
    got_img, got_lab = ta.device_augment(
        draws, torch.from_numpy(images), torch.from_numpy(labels),
        ta.AugmentConfig(**cfg), enable=enable, out_s2d=out_s2d)
    assert mosaic_warp.launches == before
    want_lab = np.asarray(want_lab)
    np.testing.assert_array_equal(got_lab.abs().sum(-1).numpy() > 0,
                                  np.abs(want_lab).sum(-1) > 0)
    np.testing.assert_allclose(got_lab.numpy(), want_lab, rtol=0, atol=1e-4)
    want_img = np.asarray(want_img).astype(np.float32)
    assert got_img.shape == want_img.shape
    max_tol, mean_tol = (1e-2, 1e-3) if dtype == "float32" else (8.0, 0.5)
    diff = np.abs(got_img.float().numpy() - want_img)
    assert diff.max() <= max_tol and diff.mean() <= mean_tol, (
        diff.max(), diff.mean())


def test_general_gather_labels_stay_inside_the_canvas():
    """The port's own draws at larger angles: every kept label box lies in
    the output image and passes the box-candidate rule."""
    cfg = ta.AugmentConfig(**dict(BASE, pixel_dtype="float32", degrees=30.0,
                                  shear=5.0, perspective=0.001))
    images, labels = _aug_batch(seed=8)
    draws = ta.sample_draws(torch.Generator().manual_seed(3), 4, (64, 64),
                            cfg)
    _, lab = ta.device_augment(draws, torch.from_numpy(images),
                               torch.from_numpy(labels), cfg)
    kept = lab[lab.abs().sum(-1) > 0]
    assert len(kept) > 0
    cx, cy, w, h = kept[:, 1:].unbind(-1)
    assert bool(((cx - w / 2 >= -1e-4) & (cx + w / 2 <= 64 + 1e-4)
                 & (cy - h / 2 >= -1e-4) & (cy + h / 2 <= 64 + 1e-4)
                 & (w > 2) & (h > 2)).all())
