"""Port parity: the YOLOv7 slice of `pl_yolo_tpu_torch` (E-ELAN, the YOLOv7
neck with and without RepConv, the implicit head, the OTA loss and its
assignment, the eval decode, the train step, the weight bridge and the
RepConv fusion) against the JAX package on the CPU, fp32, on seeded numpy
inputs at tiny widths (those of tests/test_yolov7.py) and 64 px.

Tolerances: the backbone, neck and head maps and the decode rtol = atol =
1e-4 (fp32 on both sides, convolution sums in another order through ~60
layers); the candidate slab and the OTA assignment (`flat_idx`,
`matched_gt`, `fg`) equal; loss values and input gradients rtol 1e-5 with a
small atol (sums in another order); the train state as
tests/test_torch_train.py holds it; the bridge round trip exact; the fused
RepConv's eval output 1e-4 of the unfused one's.
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
from pl_yolo_tpu.models.detector import build_model as jax_build_model
from pl_yolo_tpu.models.losses import yolov7 as jv7
from pl_yolo_tpu.models.necks.yolov7_neck import RepConv as JaxRepConv
from pl_yolo_tpu.train import state as jstate_mod
from pl_yolo_tpu.train.optim import build_optimizer as jax_build_optimizer
from pl_yolo_tpu.utils.fuse import fuse_repconv as jax_fuse_repconv
from pl_yolo_tpu_torch import bridge
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.models.losses import yolov7 as tv7
from pl_yolo_tpu_torch.models.necks.yolov7_neck import RepConv
from pl_yolo_tpu_torch.ops import topk as ttopk
from pl_yolo_tpu_torch.train.optim import build_optimizer
from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config
from pl_yolo_tpu_torch.utils.fuse import FusedRepConv, fuse_repconvs_

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

NUM_CLASSES, SIZE, STRIDES = 3, 64, (8, 16, 32)
ANCHORS = jv7.yolov7_loss.__defaults__[1]  # the JAX default anchor table
MAPS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _fp32_compute():
    """The JAX package's compute dtype is global state; these tests run fp32."""
    prev = jb.get_compute_dtype()
    jb.set_compute_dtype(None)
    yield
    jb.set_compute_dtype(prev)


def _tiny_cfg(use_repconv=False):
    cfg = load_config(CONFIG_DIR / "model" / "yolov7.yaml")
    cfg["backbone"].update(channels=[8, 16, 32, 64, 64], depths=[1, 1, 1, 1])
    cfg["neck"].update(channels=[32, 64, 64], depths=[1, 1, 1, 1],
                       use_repconv=use_repconv)
    cfg["head"]["channels"] = [16, 32, 64]
    cfg["dtype"] = None  # fp32 on both sides (yolov7.yaml says bfloat16)
    return cfg


def _randomize_bn(variables, rng):
    """Non-trivial BN statistics and affine params, so that a wrong mapping
    of RepConv's batch norms shows."""
    def walk(tree, in_bn=False):
        out = {}
        for k, v in tree.items():
            bn = in_bn or k in ("bn", "rbr_dense_bn", "rbr_1x1_bn",
                                "rbr_identity")
            if isinstance(v, dict):
                out[k] = walk(v, bn)
            elif bn and k in ("mean", "bias"):
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif bn and k in ("var", "scale"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(variables)


def _models(cfg):
    """Both packages' models of `cfg`, and the torch model's seeded init as
    flax variables, whose tree is held to the one flax's init would make
    (traced, not run: a JAX init at this depth takes ~10 s to compile)."""
    jmodel = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
    tmodel = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu")
    variables = bridge.state_dict_to_variables(tmodel.module.state_dict())
    want = jax.eval_shape(lambda k: jmodel.init(k, input_size=(SIZE, SIZE)),
                          jax.random.key(0))
    assert (jax.tree.map(lambda v: v.shape, dict(want))
            == jax.tree.map(np.shape, variables))
    return jmodel, tmodel, variables


@pytest.fixture(scope="module", params=[False, True],
                ids=["convblock_out", "repconv_out"])
def model_pair(request):
    """The tiny yolov7.yaml in both packages from the same weights, and the
    features of one seeded batch at each stage."""
    jb.set_compute_dtype(None)
    cfg = _tiny_cfg(use_repconv=request.param)
    jmodel, tmodel, variables = _models(cfg)
    variables = _randomize_bn(variables, np.random.default_rng(1))
    bridge.load_variables(tmodel.module, variables)
    x = np.random.default_rng(0).uniform(0, 255, (2, SIZE, SIZE, 3)
                                         ).astype(np.float32)
    def stages(m, x):
        feats = m.backbone(x, False)
        neck = m.neck(feats, False)
        return feats, neck, m.head(neck, False)
    jfeats, jneck, jmaps = jax.jit(functools.partial(
        jmodel.module.apply, method=stages))(variables, jnp.asarray(x))
    tm = tmodel.module
    with torch.no_grad():
        tfeats = tm.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        tneck = tm.neck(tfeats)
        tmaps = tm(torch.from_numpy(x))
    nhwc = lambda ts: [t.permute(0, 2, 3, 1).numpy() for t in ts]
    return dict(cfg=cfg, jmodel=jmodel, tmodel=tmodel, variables=variables,
                x=x, jfeats=[np.asarray(f) for f in jfeats],
                tfeats=nhwc(tfeats), jneck=[np.asarray(f) for f in jneck],
                tneck=nhwc(tneck), jmaps=[np.asarray(m) for m in jmaps],
                tmaps=[m.numpy() for m in tmaps])


@pytest.mark.parametrize("stage", ["feats", "neck", "maps"])
def test_eelan_neck_and_head_maps_match_jax(model_pair, stage):
    j, t = model_pair["j" + stage], model_pair["t" + stage]
    assert [a.shape for a in j] == [a.shape for a in t]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **MAPS_TOL)


def test_eval_decode_matches_jax(model_pair):
    jdec = np.asarray(jax.jit(model_pair["jmodel"].loss.eval_decode)(
        [jnp.asarray(m) for m in model_pair["jmaps"]]))
    tdec = model_pair["tmodel"].loss.eval_decode(
        [torch.from_numpy(m) for m in model_pair["tmaps"]]).numpy()
    assert tdec.shape == jdec.shape == (2, 3 * (64 + 16 + 4), 5 + NUM_CLASSES)
    np.testing.assert_allclose(tdec, jdec, **MAPS_TOL)


def test_bridge_round_trip_is_exact(model_pair):
    """flax variables -> torch -> flax, with RepConv's batch norms and the
    implicit head's [1,1,1,C] priors; and an SGD momentum trace."""
    tm, variables = model_pair["tmodel"].module, model_pair["variables"]
    back = bridge.state_dict_to_variables(tm.state_dict())
    want, got = dict(bridge._flatten(variables)), dict(bridge._flatten(back))
    assert set(got) == set(want)
    assert any(p[-1] == "ia0" for p in want)
    assert any("rbr_1x1_bn" in p for p in want) == model_pair["cfg"][
        "neck"]["use_repconv"]
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))
    assert tuple(tm.head.ia0.shape) == (1, 16, 1, 1)
    np.testing.assert_array_equal(
        tm.head.im2.detach().numpy().transpose(0, 2, 3, 1),
        variables["params"]["head"]["im2"])

    optimizer, _ = build_optimizer(tm, {"name": "SGD"}, 10)
    rng = np.random.default_rng(3)
    trace = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(np.float32),
                         variables["params"])
    bridge.load_momentum(optimizer, tm, trace)
    got = dict(bridge._flatten(bridge.momentum_to_trace(optimizer, tm)))
    for path, v in bridge._flatten(trace).items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))


@pytest.mark.parametrize("model_pair", [True], ids=["repconv_out"],
                         indirect=True)
def test_fused_repconv_gives_the_same_eval_output(model_pair):
    """Each RepConv collapses to one biased 3x3 conv, with the kernel and
    bias of the JAX package's fuse_repconv (1e-6), and the model's eval
    head maps stay within 1e-4."""
    tm = copy.deepcopy(model_pair["tmodel"].module)
    reps = {n: m for n, m in tm.named_modules() if isinstance(m, RepConv)}
    assert sorted(reps) == ["neck.n3_out", "neck.n4_out", "neck.n5_out"]
    variables = model_pair["variables"]
    fuse_repconvs_(tm)
    for name in reps:
        fused = tm.get_submodule(name)
        assert isinstance(fused, FusedRepConv)
        key = name.split(".")[1]
        k, b = jax_fuse_repconv(variables["params"]["neck"][key],
                                variables["batch_stats"]["neck"][key])
        np.testing.assert_allclose(
            fused.conv.weight.detach().numpy(),
            np.asarray(k).transpose(3, 2, 0, 1), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(fused.conv.bias.detach().numpy(),
                                   np.asarray(b), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        got = tm(torch.from_numpy(model_pair["x"]))
    for a, b in zip(got, model_pair["tmaps"]):
        np.testing.assert_allclose(a.numpy(), b, **MAPS_TOL)


def test_fused_repconv_with_an_identity_branch():
    """A RepConv whose input and output widths agree (none in the shipped
    necks) has the identity BN branch: fused as the JAX package fuses it,
    and its eval output kept within 1e-4."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    jmod = JaxRepConv(8)
    variables = _randomize_bn(jax.device_get(
        jmod.init(jax.random.key(1), jnp.asarray(x), False)), rng)
    tmod = bridge.load_variables(RepConv(8, 8), variables).eval()
    assert tmod.rbr_identity is not None
    with torch.no_grad():
        want = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
        fused = FusedRepConv(tmod).eval()
        got = fused(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MAPS_TOL)
    np.testing.assert_allclose(
        want.permute(0, 2, 3, 1).numpy(),
        np.asarray(jmod.apply(variables, jnp.asarray(x), False)), **MAPS_TOL)
    k, b = jax_fuse_repconv(variables["params"], variables["batch_stats"])
    np.testing.assert_allclose(fused.conv.weight.detach().numpy(),
                               np.asarray(k).transpose(3, 2, 0, 1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fused.conv.bias.detach().numpy(),
                               np.asarray(b), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the OTA loss

def _labels(rng, batch=3, slots=5, empty_image=True):
    """[B, M, 5] labels; image 0 also carries boxes on the neighbour tests'
    edges (a centre on a cell border, at the map's first and last cells)."""
    labels = np.zeros((batch, slots, 5), np.float32)
    for b in range(batch):
        n = int(rng.integers(3, slots + 1))
        labels[b, :n, 0] = rng.integers(0, NUM_CLASSES, n)
        labels[b, :n, 1:3] = rng.uniform(4, 60, (n, 2))
        labels[b, :n, 3:] = rng.uniform(6, 48, (n, 2))
    labels[0, :3, 1:3] = [[4.0, 12.0], [63.5, 0.5], [8.0, 60.25]]
    if empty_image:
        labels[batch - 1] = 0.0
    return labels


def _maps(rng, batch=3, scale=1.0):
    na, ch = 3, 5 + NUM_CLASSES
    return [rng.normal(0.0, scale, (batch, SIZE // s, SIZE // s, na * ch)
                       ).astype(np.float32) for s in STRIDES]


def _shapes():
    return tuple((SIZE // s, SIZE // s) for s in STRIDES)


def test_candidate_slab_matches_jax():
    rng = np.random.default_rng(10)
    labels = _labels(rng)
    gb, gv = labels[..., 1:5], labels.sum(2) > 0
    want = jax.jit(jax.vmap(lambda b, v: jv7._find_positive_candidates(
        b, v, _shapes(), STRIDES, ANCHORS)))(jnp.asarray(gb), jnp.asarray(gv))
    got = tv7._find_positive_candidates(
        torch.from_numpy(gb), torch.from_numpy(gv), _shapes(), STRIDES,
        ANCHORS)
    assert got[0].shape == (3, 5, 3, 3, 3, 2)
    assert bool(got[1].any()) and not bool(got[1].all())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@jax.jit
def _jax_assign(maps, labels):
    jd = jv7.flatten_v7_outputs(maps, STRIDES, ANCHORS, NUM_CLASSES)
    return jax.vmap(lambda gb, gc, gv, fp: jv7._assign_one(
        gb, gc, gv, fp, jd, _shapes(), STRIDES, ANCHORS, NUM_CLASSES))(
        labels[..., 1:5], labels[..., 0].astype(jnp.int32),
        labels.sum(2) > 0, jd.flat)


@pytest.mark.parametrize("seed", [11, 12])
def test_ota_assignment_matches_jax(seed):
    """flat_idx, matched_gt and fg equal, with M=5 label slots (Ca = 135 >
    64, so both top-k calls take the kernel's branch: `topk_plain` on the
    CPU)."""
    rng = np.random.default_rng(seed)
    maps, labels = _maps(rng, scale=1.0 + seed % 2), _labels(rng)
    want = _jax_assign([jnp.asarray(m) for m in maps], jnp.asarray(labels))
    td = tv7.flatten_v7_outputs([torch.from_numpy(m) for m in maps], STRIDES,
                                ANCHORS, NUM_CLASSES)
    before = ttopk.topk_rows.launches
    lab = torch.from_numpy(labels)
    got = tv7.ota_assign(lab[..., 1:5], lab[..., 0].long(), lab.sum(2) > 0,
                         td, _shapes(), STRIDES, ANCHORS, NUM_CLASSES)
    assert ttopk.topk_rows.launches == before  # the CPU runs no kernel
    fg = np.asarray(want[2])
    assert 0 < fg.sum() < fg.size
    for g, w, what in zip(got[:3], want[:3], ("flat_idx", "matched_gt", "fg")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    np.testing.assert_array_equal(got.level_ids.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want[4]))


@functools.cache
def _jax_loss_fn(kw):
    """The JAX loss's value and map gradients, jitted (one compile for each
    set of keywords; eagerly, its ops compile one by one, ~5x slower)."""
    def fn(outs, labels):
        losses = jv7.yolov7_loss(outs, labels, NUM_CLASSES, STRIDES, **{
            k: dict(v) if k == "gain" else v for k, v in kw})
        return losses["loss"], losses
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


def _jax_loss_and_grads(maps, labels, **kw):
    key = tuple(sorted((k, tuple(sorted(v.items())) if isinstance(v, dict)
                        else v) for k, v in kw.items()))
    (_, losses), grads = _jax_loss_fn(key)([jnp.asarray(m) for m in maps],
                                           jnp.asarray(labels))
    return losses, grads


def _torch_loss_and_grads(maps, labels, **kw):
    outs = [torch.from_numpy(m).requires_grad_() for m in maps]
    losses = tv7.yolov7_loss(outs, torch.from_numpy(labels), NUM_CLASSES,
                             STRIDES, **kw)
    losses["loss"].backward()
    return losses, [o.grad for o in outs]


def _assert_loss_matches(got, want):
    (tl, tg), (jl, jg) = got, want
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].detach().numpy(), np.asarray(jl[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("kw", [
    {}, {"label_smoothing": 0.1, "balance": (0.4, 1.0, 4.0),
         "gain": {"box": 0.1, "obj": 0.7}}], ids=["defaults", "smoothed"])
def test_yolov7_loss_and_grads_match_jax(kw):
    rng = np.random.default_rng(13)
    maps, labels = _maps(rng), _labels(rng)
    want = _jax_loss_and_grads(maps, labels, **kw)
    got = _torch_loss_and_grads(maps, labels, **kw)
    assert float(want[0]["proportion"]) > 0
    assert float(want[0]["loss_iou"]) > 0 and float(want[0]["loss_cls"]) > 0
    _assert_loss_matches(got, want)


def test_yolov7_loss_without_any_label_matches_jax():
    """No valid label: the box and cls terms are 0, the background obj BCE
    remains."""
    rng = np.random.default_rng(14)
    maps, labels = _maps(rng), np.zeros((3, 5, 5), np.float32)
    got = _torch_loss_and_grads(maps, labels)
    losses = {k: float(v.detach()) for k, v in got[0].items()}
    assert losses["loss_iou"] == losses["loss_cls"] == 0.0
    assert losses["loss_obj"] > 0.0 and losses["proportion"] == 0.0
    _assert_loss_matches(got, _jax_loss_and_grads(maps, labels))


def test_loss_spec_reads_the_config_keys():
    cfg = _tiny_cfg()
    cfg["loss"].update(label_smoothing=0.05, gain={"cls": 0.3})
    spec = build_model(cfg, NUM_CLASSES, device="cpu").loss
    assert spec.train_loss.func is tv7.yolov7_loss
    assert spec.train_loss.keywords == dict(
        num_classes=NUM_CLASSES, strides=STRIDES, anchors=ANCHORS,
        label_smoothing=0.05, balance=(4.0, 1.0, 0.4), gain={"cls": 0.3})
    assert spec.eval_decode.func is tv7.yolov7_eval_decode
    assert spec.strides == STRIDES


# ---------------------------------------------------- the train slice as a whole

# The tiny model's train-mode step is badly conditioned in fp32 (see
# tests/test_torch_train.py, where the same bounds are argued): a state
# tensor is compared by its change since the initial state, to SLICE_TOL of
# that change's scale (plus two ulps), and a loss to rtol 1e-3. The base
# rate is 5e-6, not YOLOX's 5e-4. fp32 rounding alone puts each package's
# first update 0.1-0.3% of a tensor's scale from a float64 step of the
# port, and the two packages as far from each other
# (test_first_update_of_both_packages_sits_near_a_float64_step, which
# holds the JAX step to the port's float64 one). Three steps at 5e-4 (and at
# 5e-5) grow that gap past SLICE_TOL of the change; at 5e-6 it stays inside,
# and every tensor still moves.
TOTAL_STEPS, N_STEPS, BASE_LR, SLICE_TOL = 10, 3, 5e-6, 5e-3
FIRST_UPDATE_TOL = 1e-2  # of a tensor's scale, against the float64 step


def _batch(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (batch, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((batch, 6, 5), np.float32)
    labels[:, :3, 0] = rng.integers(0, NUM_CLASSES, (batch, 3))
    labels[:, :3, 1:3] = rng.uniform(12, 52, (batch, 3, 2))
    labels[:, :3, 3:] = rng.uniform(8, 40, (batch, 3, 2))
    return images, labels


@pytest.fixture(scope="module")
def trained():
    """Three train steps, without augmentation, in both packages from the
    same weights (the port's seeded init), images and labels (RepConv
    outputs, so that its batch norms train too); and each package's
    momentum after the first step, which is its first update."""
    jb.set_compute_dtype(None)
    cfg = _tiny_cfg(use_repconv=True)
    cfg["optimizer"]["learning_rate"] = BASE_LR
    images, labels = _batch()
    jmodel, tmodel, variables = _models(cfg)
    variables = jax.tree.map(np.array, variables)  # not views of the module
    tx, _ = jax_build_optimizer(cfg["optimizer"], total_steps=TOTAL_STEPS)
    jstate = jstate_mod.TrainState.create(variables, tx)
    jstep = jstate_mod.make_train_step(
        jmodel.module.apply, jmodel.loss.train_loss, donate=False)
    jlosses = []
    for i in range(N_STEPS):
        jstate, losses = jstep(jstate, jnp.asarray(images),
                               jnp.asarray(labels), jax.random.key(i))
        jlosses.append(jax.device_get(losses))
        if i == 0:
            jfirst = _flat(_jax_trace(jstate))

    optimizer, _ = build_optimizer(tmodel.module, cfg["optimizer"],
                                   total_steps=TOTAL_STEPS)
    tstate = TrainState.create(tmodel.module, optimizer)
    tstep = make_train_step(tmodel.loss.train_loss)
    tlosses = []
    for i in range(N_STEPS):
        # use_l1 is a YOLOX flag: the step does not hand it to the v7 loss
        tlosses.append(tstep(tstate, torch.from_numpy(images),
                             torch.from_numpy(labels), use_l1=True))
        if i == 0:
            tfirst = _flat(bridge.momentum_to_trace(optimizer, tmodel.module))
    return dict(cfg=cfg, images=images, labels=labels, jstate=jstate,
                jlosses=jlosses, tstate=tstate, tlosses=tlosses,
                init=variables, jfirst=jfirst, tfirst=tfirst)


def _jax_trace(jstate):
    return [s for s in jax.tree.leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)][0].trace


def _flat(tree):
    """A tree as {path: float64 copy}."""
    return {k: np.array(v, np.float64)
            for k, v in bridge._flatten(jax.device_get(tree)).items()}


def test_first_update_of_both_packages_sits_near_a_float64_step(trained):
    """The port's first update, in float64 from the same weights, is the
    witness for BASE_LR: each package's fp32 update sits within
    FIRST_UPDATE_TOL of a tensor's scale from it (the worst tensor), so the
    gap between the packages is fp32 rounding, not a fault of the port."""
    model = build_model(copy.deepcopy(trained["cfg"]), NUM_CLASSES,
                        device="cpu")
    module = bridge.load_variables(model.module, trained["init"]).double()
    optimizer, _ = build_optimizer(module, trained["cfg"]["optimizer"],
                                   total_steps=TOTAL_STEPS)
    make_train_step(model.loss.train_loss)(
        TrainState.create(module, optimizer),
        torch.from_numpy(trained["images"]).double(),
        torch.from_numpy(trained["labels"]))
    exact = _flat(bridge.momentum_to_trace(optimizer, module))

    def worst(got, ref):
        return max((np.abs(got[p] - ref[p]).max()
                    / max(np.abs(ref[p]).max(), 1e-30), "/".join(p))
                   for p in ref)
    port, jax_ = (worst(trained[k], exact) for k in ("tfirst", "jfirst"))
    gap = worst(trained["jfirst"], trained["tfirst"])
    print(f"first update against float64: port {port[0]:.3e} ({port[1]}), "
          f"JAX {jax_[0]:.3e} ({jax_[1]}); JAX against port {gap[0]:.3e}")
    assert set(exact) == set(trained["tfirst"]) == set(trained["jfirst"])
    assert port[0] <= FIRST_UPDATE_TOL and jax_[0] <= FIRST_UPDATE_TOL
    assert gap[0] <= port[0] + jax_[0]


def test_train_step_losses_match_jax_step_by_step(trained):
    for step, (tl, jl) in enumerate(zip(trained["tlosses"],
                                        trained["jlosses"])):
        assert set(tl) == set(jl)
        assert float(jl["proportion"]) > 0
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-3,
                                       atol=1e-5, err_msg=f"step {step}: {k}")


@pytest.mark.parametrize("part", ["params", "batch_stats", "ema_params",
                                  "momentum"])
def test_train_state_after_three_steps_matches_jax(trained, part):
    jstate, tstate = trained["jstate"], trained["tstate"]
    assert tstate.step == int(jstate.step) == N_STEPS
    if part == "momentum":
        want = _jax_trace(jstate)
        got = bridge.momentum_to_trace(tstate.optimizer, tstate.module)
        init = jax.tree.map(np.zeros_like, trained["init"]["params"])
    elif part == "ema_params":
        want = jstate.ema_params
        got = bridge.state_dict_to_variables(
            tstate.eval_module.state_dict())["params"]
        init = trained["init"]["params"]
    else:
        want = getattr(jstate, part)
        got = bridge.state_dict_to_variables(tstate.module.state_dict())[part]
        init = trained["init"][part]
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


def test_weight_decay_skips_the_priors_and_batch_norms(trained):
    """Decay reaches conv weights only: not `ia`/`im`, not RepConv's or any
    other BN's params, not the head's conv biases."""
    tstate = trained["tstate"]
    decayed, plain = tstate.optimizer.param_groups
    names = {id(p): n for n, p in tstate.module.named_parameters()}
    dec = {names[id(p)] for p in decayed["params"]}
    rest = {names[id(p)] for p in plain["params"]}
    assert all(n.endswith("conv.weight") or n.endswith("_conv.weight")
               or n.split(".")[-2].startswith("conv") for n in dec)
    assert {"head.ia0", "head.im0", "head.conv0.bias",
            "neck.n3_out.rbr_1x1_bn.weight",
            "neck.n5_out.rbr_dense_bn.bias"} <= rest
    assert not any(n.endswith(("ia0", "im0", "bias")) for n in dec)
