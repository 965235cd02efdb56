"""Port parity: the YOLOX training loss of `pl_yolo_tpu_torch` (box IoU
family, SimOTA assignment, `yolox_loss` and its gradients) against the JAX
package on the CPU, fp32, on seeded numpy inputs at a small size (64 px,
84 anchors, 6 label slots, 3 classes).

Tolerances: IoU functions 1e-6 (a handful of fp32 operations); the discrete
assignment (`fg_mask`, `matched_gt`) must be equal; loss values and gradients
rtol 1e-5 with a small atol, for sums taken in another order. Boxes and
logits are drawn from continuous distributions, so no clamp, max or abs sits
exactly at its kink, where the two frameworks split a subgradient
differently.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.models.losses import yolox as jyolox
from pl_yolo_tpu.ops import boxes as jboxes
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.models.losses import yolox as tyolox
from pl_yolo_tpu_torch.ops import boxes as tboxes
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

# the JAX references compile at XLA's backend optimization level 0: the
# same functions, compiled in about three quarters of the time (results
# within an ulp or so of level 2's)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

STRIDES, SIZE, NUM_CLASSES, MAX_LABELS = (8, 16, 32), 64, 3, 6


def _cxcywh(rng, shape, lo=4.0, hi=60.0):
    cxy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(4.0, 40.0, shape + (2,))
    return np.concatenate([cxy, wh], -1).astype(np.float32)


# ------------------------------------------------------------------ boxes

def test_box_conversions_match_jax():
    b = _cxcywh(np.random.default_rng(0), (5, 7))
    xyxy = tboxes.cxcywh2xyxy(torch.from_numpy(b))
    np.testing.assert_allclose(xyxy.numpy(), np.asarray(jboxes.cxcywh2xyxy(b)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tboxes.xyxy2cxcywh(xyxy).numpy(),
        np.asarray(jboxes.xyxy2cxcywh(np.asarray(xyxy))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt_cxcywh", [False, True])
def test_pairwise_iou_matches_jax(fmt_cxcywh):
    rng = np.random.default_rng(1)
    a, b = _cxcywh(rng, (3, 5)), _cxcywh(rng, (3, 9))
    if not fmt_cxcywh:
        a, b = (np.array(jboxes.cxcywh2xyxy(v)) for v in (a, b))
    want = jax.vmap(functools.partial(jboxes.pairwise_iou,
                                      fmt_cxcywh=fmt_cxcywh))(a, b)
    got = tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b),
                              fmt_cxcywh=fmt_cxcywh)
    assert got.shape == (3, 5, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # an unbatched pair works too
    np.testing.assert_allclose(
        tboxes.pairwise_iou(torch.from_numpy(a[0]), torch.from_numpy(b[0]),
                            fmt_cxcywh=fmt_cxcywh).numpy(),
        np.asarray(want[0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn,kw", [
    ("elementwise_iou", {}), ("giou", {}),
    ("iou_loss", {"loss_type": "iou"}), ("iou_loss", {"loss_type": "giou"}),
])
def test_elementwise_iou_family_matches_jax(fn, kw):
    rng = np.random.default_rng(2)
    p, t = _cxcywh(rng, (4, 11)), _cxcywh(rng, (4, 11))
    t[0, :3] = 0.0  # a zero box, what an unmatched anchor's target is
    want = getattr(jboxes, fn)(jnp.asarray(p), jnp.asarray(t), **kw)
    got = getattr(tboxes, fn)(torch.from_numpy(p), torch.from_numpy(t), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_unported_iou_loss_types_raise():
    """Only an unknown type raises: 'ciou' and 'diou' came with the anchor
    families (held to JAX in test_torch_anchor.py)."""
    b = torch.ones(2, 4)
    with pytest.raises(ValueError, match="Unsupported iou loss type"):
        tboxes.iou_loss(b, b, "nope")
    for loss_type in ("ciou", "diou"):
        assert torch.isfinite(tboxes.iou_loss(b, b, loss_type)).all()


# ------------------------------------------------------- SimOTA and loss

def _problem(seed, batch=3, empty_image=True, scale=1.0):
    """Seeded head maps [B,h,w,5+C] per level and labels [B,M,5]."""
    rng = np.random.default_rng(seed)
    maps = [rng.normal(0.0, scale, (batch, SIZE // s, SIZE // s,
                                    5 + NUM_CLASSES)).astype(np.float32)
            for s in STRIDES]
    labels = np.zeros((batch, MAX_LABELS, 5), np.float32)
    for b in range(batch):
        n = int(rng.integers(1, MAX_LABELS + 1))
        labels[b, :n, 0] = rng.integers(0, NUM_CLASSES, n)
        labels[b, :n, 1:] = _cxcywh(rng, (n,))
    if empty_image:
        labels[1] = 0.0
    return maps, labels


def _assign_inputs(maps, labels):
    d = jyolox.yolox_decode([jnp.asarray(m) for m in maps], STRIDES)
    jargs = (jnp.asarray(labels[..., 1:5]),
             jnp.asarray(labels[..., 0]).astype(jnp.int32),
             jnp.asarray(labels.sum(2) > 0), d.preds[..., :4],
             d.preds[..., 4], d.preds[..., 5:],
             d.x_shifts, d.y_shifts, d.strides)
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    targs[1] = targs[1].long()
    return jargs, targs


@functools.cache
def _jax_assign_fn(chunk):
    """The JAX assignment, vmapped and jitted (eagerly, its ops compile one
    by one)."""
    return _jit(jax.vmap(
        functools.partial(jyolox.simota_assign, chunk=chunk),
        in_axes=(0, 0, 0, 0, 0, 0, None, None, None)))


def _jax_assign(jargs, chunk=None):
    return _jax_assign_fn(chunk)(*jargs)


def _assert_assign_equal(got, want):
    fg = np.asarray(want.fg_mask)
    assert fg.sum() > 0
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    # matched_gt is meaningful where fg; elsewhere both sides give 0
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(want.matched_gt))
    np.testing.assert_allclose(got.pred_ious.numpy(),
                               np.asarray(want.pred_ious), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.num_fg.numpy(), np.asarray(want.num_fg))
    np.testing.assert_array_equal(got.num_gt.numpy(), np.asarray(want.num_gt))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_simota_assign_matches_jax_vmap(seed):
    jargs, targs = _assign_inputs(*_problem(seed, scale=0.5 + seed))
    _assert_assign_equal(tyolox.simota_assign(*targs), _jax_assign(jargs))


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_simota_chunked_equals_dense_and_jax_chunked(chunk):
    jargs, targs = _assign_inputs(*_problem(5))
    dense = tyolox.simota_assign(*targs)
    chunked = tyolox.simota_assign(*targs, chunk=chunk)
    for a, b in zip(chunked, dense):
        assert torch.equal(a, b)
    _assert_assign_equal(chunked, _jax_assign(jargs, chunk=chunk))


@functools.cache
def _jax_loss_fn(static_kw):
    """The JAX loss's value and map gradients, jitted for one set of Python
    keywords; array keywords are traced arguments."""
    def fn(outs, labels, array_kw):
        losses = jyolox.yolox_loss(outs, labels, NUM_CLASSES, STRIDES,
                                   **dict(static_kw), **array_kw)
        return losses["loss"], losses
    return _jit(jax.value_and_grad(fn, has_aux=True))


def _jax_loss_and_grads(maps, labels, **kw):
    array_kw = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
    static_kw = tuple(sorted((k, v) for k, v in kw.items()
                             if k not in array_kw))
    (_, losses), grads = _jax_loss_fn(static_kw)(
        [jnp.asarray(m) for m in maps], jnp.asarray(labels), array_kw)
    return losses, grads


def _torch_loss_and_grads(maps, labels, **kw):
    outs = [torch.from_numpy(m).requires_grad_() for m in maps]
    losses = tyolox.yolox_loss(outs, torch.from_numpy(labels), NUM_CLASSES,
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


@pytest.mark.parametrize("use_l1", [False, True, 0.0, 1.0])
def test_yolox_loss_and_grads_match_jax(use_l1):
    """`use_l1` as a bool, and as a 0/1 array that gates a computed term."""
    maps, labels = _problem(7)
    if isinstance(use_l1, bool):
        jl1 = tl1 = use_l1
    else:
        jl1, tl1 = jnp.asarray(use_l1), torch.tensor(use_l1)
    want = _jax_loss_and_grads(maps, labels, use_l1=jl1)
    got = _torch_loss_and_grads(maps, labels, use_l1=tl1)
    assert float(want[0]["proportion"]) > 0
    assert (got[0]["loss_l1"].item() > 0) == bool(use_l1)
    _assert_loss_matches(got, want)


def test_yolox_loss_chunked_assignment_matches_jax():
    maps, labels = _problem(8)
    _assert_loss_matches(
        _torch_loss_and_grads(maps, labels, use_l1=True, assign_chunk=4),
        _jax_loss_and_grads(maps, labels, use_l1=True, assign_chunk=4))


def test_yolox_loss_without_any_label_matches_jax():
    """No valid label in the batch: num_fgs clamps to 1, only the obj BCE
    (all-background) and the cls term's zeros remain."""
    maps, labels = _problem(9)
    labels[:] = 0.0
    got = _torch_loss_and_grads(maps, labels, use_l1=True)
    assert float(got[0]["proportion"]) == 0.0
    _assert_loss_matches(got, _jax_loss_and_grads(maps, labels, use_l1=True))


def test_loss_spec_reads_the_config_keys():
    cfg = load_config(CONFIG_DIR / "model" / "yolox_nano.yaml")
    cfg["loss"].update(use_l1=True, assign_chunk=2, stride=list(STRIDES))
    spec = build_model(cfg, NUM_CLASSES, device="cpu").loss
    assert spec.train_loss.func is tyolox.yolox_loss
    assert spec.train_loss.keywords == dict(
        num_classes=NUM_CLASSES, strides=STRIDES, use_l1=True, assign_chunk=2,
        pallas_assign=False)
    maps, labels = _problem(7)
    got = spec.train_loss([torch.from_numpy(m) for m in maps],
                          torch.from_numpy(labels))
    want = _jax_loss_and_grads(maps, labels, use_l1=True, assign_chunk=2)[0]
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
