"""Port parity: the device augmentation of `pl_yolo_tpu_torch`
(`data.augment`) against the JAX package's `data/augment.py` on the CPU.

The JAX package draws its random numbers inside its functions from a key
tree; the port draws them all up front into `AugmentDraws`. `_jax_draws`
walks the same key tree as `device_augment` (split into perm / mix / each,
each image's key into gate / mosaic / hsv / mixup, the mosaic key into
centre / affine, the centre's y from `fold_in(k_c, 1)`) and hands both sides
the same numbers.

Tolerances, stated at each test: labels come out equal (the same fp32 label
math), pixels to the rounding of each route (see `test_device_augment_...`).
The wiring into the train step is held torch against torch: the step with
`augment_fn` and the s2d `apply_fn` against the same step fed the batch
augmented beforehand.
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pl_yolo_tpu.data import augment as ja
from pl_yolo_tpu.layers.blocks import space_to_depth as jax_s2d
from pl_yolo_tpu_torch.data import augment as ta
from pl_yolo_tpu_torch.layers import blocks as tb
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.ops.cuda.mosaic_warp import mosaic_warp
from pl_yolo_tpu_torch.train.optim import build_optimizer
from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
from tests.test_torch_train import NUM_CLASSES, _tiny_cfg

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

B, H, W, M = 4, 64, 64, 10
BASE = dict(max_labels=20, mosaic_prob=1.0, mixup_prob=1.0, hsv_prob=1.0,
            flip_prob=0.5)


def _jax_draws(key, b, h, w, cfg):
    """`AugmentDraws` of JAX `device_augment(key, ...)`, and the per-image
    keys [B] of its mosaic, HSV and mixup draws."""
    k_perm, k_mix, k_each = jax.random.split(key, 3)
    perm = jax.random.permutation(k_perm, b)
    mix_idx = jax.random.permutation(k_mix, b)

    def one(k):
        k_gate, k_mosaic, k_hsv, k_mixt = jax.random.split(k, 4)
        k_c, k_aff = jax.random.split(k_mosaic)
        cx = jax.random.uniform(k_c, (), minval=0.5 * w, maxval=1.5 * w)
        cy = jax.random.uniform(jax.random.fold_in(k_c, 1), (),
                                minval=0.5 * h, maxval=1.5 * h)
        kf, kflip, ky, kx = jax.random.split(k_mixt, 4)
        draws = (jax.random.uniform(k_gate, (4,)), jnp.stack([cx, cy]),
                 jnp.stack(ja._affine_params(k_aff, cfg)),
                 jax.random.uniform(k_hsv, (3,), minval=-1.0, maxval=1.0),
                 jax.random.uniform(kf, (), minval=cfg.mixup_scale[0],
                                    maxval=cfg.mixup_scale[1]),
                 jax.random.uniform(kflip, ()) > 0.5,
                 jnp.stack([jax.random.uniform(ky, ()),
                            jax.random.uniform(kx, ())]))
        return draws, (k_mosaic, k_hsv, k_mixt)

    draws, keys = jax.vmap(one)(jax.random.split(k_each, b))
    t = [torch.from_numpy(np.array(a)) for a in (perm, mix_idx) + draws]
    return ta.AugmentDraws(t[0].long(), t[1].long(), *t[2:]), keys


def _batch(seed=31, dtype=np.float32):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (B, H, W, 3)).astype(dtype)
    labels = np.zeros((B, M, 5), np.float32)
    labels[:, :3, 0] = rng.integers(0, 3, (B, 3))
    labels[:, :3, 1:] = rng.uniform(10, 50, (B, 3, 4))
    return images, labels


@pytest.fixture(scope="module")
def drawn():
    key = jax.random.key(7)
    cfg = ja.AugmentConfig(**BASE)
    draws, keys = _jax_draws(key, B, H, W, cfg)
    return dict(key=key, cfg=cfg, draws=draws, keys=keys)


# ------------------------------------------------- modules 4-10, one by one

def test_affine_matrix_and_points_match_jax():
    """Any affine (rotation and shear too, which only the port's matrix
    sees): [B,3,3] matrices and transformed points, to fp32 rounding of a
    3-term product chain (rtol 1e-6 of entries up to ~1e3)."""
    rng = np.random.default_rng(1)
    params = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(0.1, 2.0, B),
                       rng.uniform(-0.05, 0.05, B), rng.uniform(-0.05, 0.05, B),
                       rng.uniform(0.4, 0.6, B), rng.uniform(0.4, 0.6, B)],
                      1).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p: ja._affine_matrix(
        tuple(p), H, W, H // 2, W // 2))(jnp.asarray(params)))
    got = ta._affine_matrix(torch.from_numpy(params), H, W, H // 2, W // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    pts = rng.uniform(0, 2 * W, (B, 7, 4, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(ja._apply_affine_to_points)(
        jnp.asarray(want), jnp.asarray(pts)))
    got = ta._apply_affine_to_points(got, torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)


def test_mosaic_geometry_and_labels_match_jax(drawn):
    """Tile origins (truncating casts) equal; coordinates and label
    candidates to 1e-3 px; the box_candidates mask equal."""
    _, labels = _batch()
    labels4 = np.stack([np.concatenate(
        [labels[b:b + 1], labels[np.roll(np.arange(B), -b)[1:]]])
        for b in range(B)])                                   # [B,4,M,5]
    want = jax.vmap(lambda k, l4: ja._mosaic_geometry(
        k, l4, H, W, drawn["cfg"]))(drawn["keys"][0], jnp.asarray(labels4))
    got = ta._mosaic_geometry(drawn["draws"], torch.from_numpy(labels4), H, W)
    for name, g, w in zip(["oxw", "oyw", "xs_raw", "ys_raw", "cand", "valid"],
                          got, want):
        w = np.asarray(w)
        if name in ("oxw", "oyw", "valid"):
            assert g.dtype in (torch.int32, torch.bool), name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3,
                                       err_msg=name)
    assert got[5].any() and not got[5].all()


def test_mixup_geometry_matches_jax(drawn):
    _, labels = _batch()
    want = jax.vmap(lambda k, lab: ja._mixup_geometry(
        k, lab, drawn["cfg"], H, W))(drawn["keys"][2], jnp.asarray(labels))
    got = ta._mixup_geometry(drawn["draws"], torch.from_numpy(labels), H, W)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert bool(drawn["draws"].mix_flip.any())


@pytest.mark.parametrize("max_labels", [5, 12, 40])
def test_compact_labels_is_a_stable_partition(max_labels):
    rng = np.random.default_rng(max_labels)
    cand = rng.uniform(0, 64, (B, 30, 5)).astype(np.float32)
    valid = rng.uniform(size=(B, 30)) < 0.4
    want = np.asarray(jax.vmap(lambda c, v: ja._compact_labels(
        c, v, max_labels))(jnp.asarray(cand), jnp.asarray(valid)))
    got = ta._compact_labels(torch.from_numpy(cand), torch.from_numpy(valid),
                             max_labels)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hsv_planes_and_jitter_match_jax(drawn):
    """The RGB<->HSV planes to fp32 rounding (atol 1e-3 on 0..255, 1e-6 on
    h, s in [0,1]), including grey pixels and max-channel ties; the jitter,
    gated per image, in fp32 (atol 1e-3) and bf16 (one bf16 step, 2 grey
    levels at 128..255)."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (B, 3, H, W)).astype(np.float32)
    img[:, :, :4] = np.floor(img[:, :1, :4] / 32) * 32     # grey and ties
    img[:, 1, 4:8] = img[:, 0, 4:8]                         # r == g
    planes = [jnp.asarray(img[:, c]) for c in range(3)]
    want_hsv = ja._rgb_to_hsv_planes(*planes)
    got_hsv = ta._rgb_to_hsv_planes(*torch.from_numpy(img).unbind(1))
    for g, w, tol in zip(got_hsv, want_hsv, (1e-6, 1e-6, 1e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    want_rgb = ja._hsv_to_rgb_planes(*want_hsv)
    got_rgb = ta._hsv_to_rgb_planes(*got_hsv)
    for g, w in zip(got_rgb, want_rgb):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)
    enable = np.array([True, False, True, True])
    for dtype, tol in ((jnp.float32, 1e-3), (jnp.bfloat16, 2.0)):
        want = np.asarray(jax.vmap(lambda k, x, e: ja.hsv_jitter(
            k, x, enable=e, channel_axis=0))(
            drawn["keys"][1], jnp.asarray(img, dtype),
            jnp.asarray(enable))).astype(np.float32)
        x = torch.from_numpy(img).to(torch.float32 if dtype == jnp.float32
                                     else torch.bfloat16)
        got = ta.hsv_jitter(drawn["draws"].hsv_gains, x,
                            enable=torch.from_numpy(enable))
        assert got.dtype == x.dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_chw_to_s2d_matches_jax():
    x = np.random.default_rng(4).uniform(0, 255, (2, 3, H, W)).astype(
        np.float32)
    want = np.asarray(ja._chw_to_s2d(jnp.asarray(x)))
    got = ta._chw_to_s2d(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(jax_s2d(jnp.asarray(x.transpose(0, 2, 3, 1)))))


# ------------------------------------------------------ device_augment whole

# (JAX route, pixel dtype, enable, out_s2d): each axis takes both values.
# Pixel tolerances (max |diff|, mean |diff|), in grey levels:
# * "off", fp32: the canvas route in fp32; the same sums in another order,
#   then the HSV roundtrip: 1e-3 and 1e-5;
# * "interpret": the Pallas kernel rounds to bf16 (~2 grey levels), and the
#   HSV sector selects can amplify that where two channels tie: the bounds of
#   the JAX package's own chw-vs-jnp test, 12 and 0.5;
# * bf16 pixels: the canvas route lerps in bf16 and the port rounds once;
#   one bf16 step is 1-2 grey levels at 128..255, and HSV doubles it: 8, 0.5.
E2E_CASES = [("off", "float32", True, False), ("off", "bfloat16", True, True),
             ("off", "float32", False, True),
             ("interpret", "float32", True, True),
             ("interpret", "bfloat16", True, False),
             ("interpret", "bfloat16", False, False)]


@pytest.mark.parametrize("route,dtype,enable,out_s2d", E2E_CASES)
def test_device_augment_matches_jax(drawn, route, dtype, enable, out_s2d):
    images, labels = _batch()
    images = images.astype(np.uint8) if enable else images  # both feeds
    cfg = dict(BASE, pixel_dtype=dtype)
    want_img, want_lab = ja.device_augment(
        drawn["key"], jnp.asarray(images), jnp.asarray(labels),
        ja.AugmentConfig(**cfg, use_pallas=route), enable=enable,
        out_s2d=out_s2d)
    before = mosaic_warp.launches
    got_img, got_lab = ta.device_augment(
        drawn["draws"], torch.from_numpy(images), torch.from_numpy(labels),
        ta.AugmentConfig(**cfg), enable=torch.tensor(float(enable)),
        out_s2d=out_s2d)
    assert mosaic_warp.launches == before  # the CPU runs the plain version
    want_img = np.asarray(want_img).astype(np.float32)
    pixel = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if out_s2d:
        assert got_img.shape == (B, H // 2, W // 2, 12)
        assert got_img.dtype == pixel and got_img.is_contiguous()
    else:
        assert got_img.shape == (B, H, W, 3)
        assert got_img.dtype == torch.float32 and got_img.is_contiguous()
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    n_valid = (got_lab.abs().sum(-1) > 0).sum(1)
    assert bool((n_valid > 0).all())
    max_tol, mean_tol = ((1e-3, 1e-5) if (route, dtype) == ("off", "float32")
                         else (8.0, 0.5) if route == "off" else (12.0, 0.5))
    diff = np.abs(got_img.float().numpy() - want_img)
    assert diff.max() <= max_tol and diff.mean() <= mean_tol, (
        diff.max(), diff.mean())


def test_disabled_augment_keeps_the_image_geometry(drawn):
    """enable=False: no mosaic, no mixup; the labels are the input's (up to
    the flip) and the pixels the HSV and flip of the input."""
    images, labels = _batch()
    cfg = ta.AugmentConfig(**dict(BASE, pixel_dtype="float32", hsv_prob=0.0))
    got_img, got_lab = ta.device_augment(
        drawn["draws"], torch.from_numpy(images), torch.from_numpy(labels),
        cfg, enable=False)
    flip = (drawn["draws"].gates[:, 3] < 0.5).numpy()
    want = np.where(flip[:, None, None, None], images[:, :, ::-1], images)
    np.testing.assert_array_equal(got_img.numpy(), want)
    want_lab = labels.copy()
    want_lab[flip, :3, 1] = W - labels[flip, :3, 1]
    np.testing.assert_array_equal(got_lab.numpy()[:, :M], want_lab)


# ------------------------------------------------ draws, config and wiring

def test_sampled_draws_lie_in_their_ranges():
    cfg = ta.AugmentConfig(mosaic_scale=(0.25, 1.75), translate=0.2,
                           mixup_scale=(0.6, 1.4))
    d = ta.sample_draws(torch.Generator().manual_seed(5), 512, (48, 80), cfg)
    n = 512
    for t in (d.perm, d.mix_idx):
        assert t.dtype == torch.int64
        assert torch.equal(t.sort().values, torch.arange(n))
    assert d.gates.shape == (n, 4) and d.hsv_gains.shape == (n, 3)
    assert bool(((d.gates >= 0) & (d.gates < 1)).all())
    assert bool(((d.hsv_gains >= -1) & (d.hsv_gains < 1)).all())
    cx, cy = d.center.unbind(1)
    assert bool(((cx >= 40) & (cx <= 120)).all())
    assert bool(((cy >= 24) & (cy <= 72)).all())
    ang, s, shx, shy, tx, ty = d.affine.unbind(1)
    assert bool((ang == 0).all() & (shx == 0).all() & (shy == 0).all())
    assert bool(((s >= 0.25) & (s <= 1.75)).all())
    for t in (tx, ty):
        assert bool(((t >= 0.3) & (t <= 0.7)).all())
    assert bool(((d.mix_scale >= 0.6) & (d.mix_scale <= 1.4)).all())
    assert d.mix_flip.dtype == torch.bool and 0.3 < d.mix_flip.float().mean() < 0.7
    assert bool(((d.mix_offset >= 0) & (d.mix_offset < 1)).all())
    # seeded: the same generator state gives the same draws
    again = ta.sample_draws(torch.Generator().manual_seed(5), 512, (48, 80),
                            cfg)
    assert all(torch.equal(a, b) for a, b in zip(d, again))


# err None: ported since (the general-gather route, test_torch_options),
# so the option builds an augment fn and augments a batch
@pytest.mark.parametrize("over,err", [
    (dict(degrees=5.0), None),
    (dict(shear=2.0), None),
    (dict(perspective=1e-4), None),
    (dict(use_pallas="off"), ValueError),
    (dict(use_pallas="interpret"), ValueError),
])
def test_unported_config_options_raise(over, err):
    cfg = ta.AugmentConfig(**over)
    images, labels = _batch()
    draws = ta.sample_draws(torch.Generator().manual_seed(0), B, (H, W), cfg)
    if err is None:
        assert not cfg.separable
        ta.make_augment_fn(cfg)
        img, lab = ta.device_augment(draws, torch.from_numpy(images),
                                     torch.from_numpy(labels), cfg)
        assert img.shape == (B, H, W, 3) and bool(torch.isfinite(img).all())
        # 4 mosaic tiles' and the mixup partner's rows, compacted
        assert lab.shape == (B, min(cfg.max_labels, 5 * M), 5)
        return
    with pytest.raises(err):
        ta.make_augment_fn(cfg)
    with pytest.raises(err):
        ta.device_augment(draws, torch.from_numpy(images),
                          torch.from_numpy(labels), cfg)


DATA_DIR = pathlib.Path(ja.__file__).parents[1] / "configs" / "data"
DATA_CONFIGS = sorted(p.name for p in DATA_DIR.glob("*.yaml"))


@pytest.mark.parametrize("name", DATA_CONFIGS)
def test_from_dict_matches_jax_on_every_shipped_data_config(name):
    """Every shipped data config parses to the JAX package's config, takes
    the separable route and builds an augment fn."""
    t = yaml.safe_load((DATA_DIR / name).read_text()).get("transform") or {}
    want = ja.AugmentConfig.from_dict(t, max_labels=50)
    got = ta.AugmentConfig.from_dict(t, max_labels=50)
    assert tuple(got) == tuple(want) and got._fields == want._fields
    assert got.separable
    ta.make_augment_fn(got)


def _s2d_apply(module, images):
    with tb.stem_input_s2d():
        return module(images)


def test_stem_input_s2d_is_consumed_once():
    """Inside the context, the first Focus takes [B,4c,H/2,W/2] and runs
    only its conv (train and eval alike); a second Focus in the same
    context runs its own space_to_depth; the flag is restored on exit."""
    torch.manual_seed(0)
    focus = tb.Focus(3, 8, ksize=3)
    x = torch.rand(2, 3, 16, 16) * 255
    s2d = tb.space_to_depth(x)
    for train in (True, False):
        focus.train(train)
        with torch.no_grad():
            want = focus(x)
            with tb.stem_input_s2d():
                got = focus(s2d)
                again = focus(x)
        assert not tb._PENDING_S2D_INPUT[0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(again, want, rtol=0, atol=0)


def test_train_step_with_augment_fn_equals_step_on_the_augmented_batch():
    """One step through `augment_fn` (s2d output, uint8 in) and the s2d
    `apply_fn`, against one step on the batch augmented beforehand (NHWC)
    with no augment_fn: the same losses and the same updated weights."""
    cfg = _tiny_cfg()
    images, labels = _batch(seed=2)
    images = torch.from_numpy(images.astype(np.uint8))
    labels = torch.from_numpy(labels)
    acfg = ta.AugmentConfig(**BASE, pixel_dtype="float32")
    results = []
    for fused in (True, False):
        model = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu")
        optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 10)
        state = TrainState.create(model.module, optimizer, use_ema=False)
        gen = torch.Generator().manual_seed(9)
        if fused:
            step = make_train_step(
                model.loss.train_loss, apply_fn=_s2d_apply,
                augment_fn=ta.make_augment_fn(acfg, out_s2d=True))
            losses = step(state, images, labels, generator=gen,
                          aug_enable=torch.tensor(1.0))
        else:
            draws = ta.sample_draws(gen, B, (H, W), acfg)
            aug_img, aug_lab = ta.device_augment(draws, images, labels, acfg)
            losses = make_train_step(model.loss.train_loss)(
                state, aug_img, aug_lab)
        assert not tb._PENDING_S2D_INPUT[0]
        results.append((losses, model.module.state_dict()))
    (l_fused, w_fused), (l_plain, w_plain) = results
    assert float(l_fused["proportion"]) > 0
    for k in l_plain:
        torch.testing.assert_close(l_fused[k], l_plain[k], rtol=1e-6,
                                   atol=1e-7)
    for k in w_plain:
        torch.testing.assert_close(w_fused[k], w_plain[k], rtol=1e-6,
                                   atol=1e-7)
