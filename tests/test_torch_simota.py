"""Port parity: the fused SimOTA assignment of `pl_yolo_tpu_torch`
(`ops.simota.simota_assign_fused`, `ops.cuda.simota`) and the loss through
it, against the JAX package on the CPU, fp32, on seeded numpy inputs at the
size of `tests/test_simota_pallas.py` (2 images, 10 label slots, 7 classes,
128 px, 320 anchors).

On the CPU the wrapper runs its plain version, which repeats the CUDA
kernel's arithmetic. Tolerances:
* against the Pallas kernel in interpret mode, the JAX test's own bounds
  (fg agreement above 0.999, `matched` equal where both are fg, IoU 1e-5,
  fg counts within 2): the TPU kernel rounds log p and log(1 - p) to bf16,
  the port does not;
* against the port's dense and chunked SimOTA, equal `fg` and `matched` and
  IoU within 1e-6: the same fp32 formulas, with S and the top-10 IoU sum
  added in a fixed order where the dense path leaves it to a reduction;
* the loss through the fused assignment against JAX's, 1e-5 on the loss
  entries and `tests/test_torch_loss.py`'s tolerance on the map gradients.
The Pallas kernel in interpret mode takes ~10 s a call on one core, so it
runs twice in this file: once in a module-scoped fixture, once in the loss.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.models.losses import yolox as jyolox
from pl_yolo_tpu.ops.pallas.simota_pallas import simota_assign_pallas
from pl_yolo_tpu_torch.data import augment as taug
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.models.losses import yolox as tyolox
from pl_yolo_tpu_torch.ops.cuda.simota import simota_fused, simota_fused_plain
from pl_yolo_tpu_torch.ops.simota import simota_assign_fused
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_loss import (NUM_CLASSES, STRIDES, _assert_loss_matches,  # noqa: E402
                             _problem, _torch_loss_and_grads)

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)


def _case(seed, b=2, m=10, c=7, size=128, n_valid=None, kind="random"):
    """`tests/test_simota_pallas.py::_random_case`'s inputs as numpy: a
    two-level anchor grid, labels in the first n slots of an image, boxes
    and logits drawn around their anchors."""
    rng = np.random.default_rng(seed)
    xs, ys, st = [], [], []
    for stride in (8, 16):
        g = size // stride
        gy, gx = np.mgrid[0:g, 0:g]
        xs.append(gx.reshape(-1))
        ys.append(gy.reshape(-1))
        st.append(np.full(g * g, stride, np.float32))
    xs = np.concatenate(xs).astype(np.float32)
    ys = np.concatenate(ys).astype(np.float32)
    st = np.concatenate(st)
    a = xs.shape[0]
    gt = np.zeros((b, m, 4), np.float32)
    gcls = rng.integers(0, c, (b, m)).astype(np.int64)
    gval = np.zeros((b, m), bool)
    for i in range(b):
        n = int(rng.integers(1, m)) if n_valid is None else n_valid
        gval[i, :n] = True
        gt[i, :n, 0] = rng.uniform(10, size - 10, n)
        gt[i, :n, 1] = rng.uniform(10, size - 10, n)
        gt[i, :n, 2:] = rng.uniform(8, 60, (n, 2))
    preds = np.zeros((b, a, 4), np.float32)
    preds[..., 0] = (xs + rng.uniform(-1, 1, (b, a))) * st
    preds[..., 1] = (ys + rng.uniform(-1, 1, (b, a))) * st
    preds[..., 2:] = rng.uniform(4, 80, (b, a, 2))
    obj = rng.normal(-2, 2, (b, a)).astype(np.float32)
    cls = rng.normal(-2, 2, (b, a, c)).astype(np.float32)
    if kind == "class out of range":
        gcls[:, ::2] = -2
        gcls[:, 1::2] = c + 3
    if kind == "few candidates":
        # image 0: 4x4 px labels centred 15 px outside the grid's corner,
        # inside the centre gate of 1 + 4 anchors only (fewer than 10);
        # image 1: labels far outside, inside no gate at all
        gt[0, :, :2], gt[0, :, 2:] = -15.0, 4.0
        gt[1, :, :2] = size + 500.0
    return gt, gcls, gval, preds, obj, cls, xs, ys, st


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in args)


@pytest.fixture(scope="module")
def pallas_case():
    """`_random_case(seed 13)` through the Pallas kernel in interpret mode."""
    args = _case(13)
    jargs = tuple(jnp.asarray(v) for v in args)
    jargs = (jargs[0], jargs[1].astype(jnp.int32)) + jargs[2:]
    out = simota_assign_pallas(*jargs, interpret=True)
    return args, tuple(np.asarray(o) for o in out)


def test_plain_matches_pallas_interpret(pallas_case):
    args, (fg_ref, matched_ref, piou_ref) = pallas_case
    fg, matched, piou = (t.numpy() for t in simota_fused_plain(*_torch(args)))
    assert (fg == fg_ref).mean() > 0.999
    both = fg & fg_ref
    assert both.sum() > 0
    np.testing.assert_array_equal(matched[both], matched_ref[both])
    np.testing.assert_allclose(piou[both], piou_ref[both], atol=1e-5)
    assert abs(int(fg.sum()) - int(fg_ref.sum())) <= 2


def test_entry_matches_pallas_signature(pallas_case):
    """`simota_assign_fused` takes the JAX entry's dtypes (int32 classes)
    and returns bool, int64 and fp32 [B,A], on the CPU the plain version's
    values."""
    args, (fg_ref, _, _) = pallas_case
    targs = list(_torch(args))
    targs[1] = targs[1].to(torch.int32)
    fg, matched, piou = simota_assign_fused(*targs)
    assert (fg.dtype, matched.dtype, piou.dtype) == (
        torch.bool, torch.int64, torch.float32)
    assert fg.shape == matched.shape == piou.shape == fg_ref.shape
    for got, want in zip((fg, matched, piou),
                         simota_fused_plain(*_torch(args))):
        assert torch.equal(got, want)


CASES = {
    "m10": dict(seed=0),
    "m13": dict(seed=1, m=13),
    "one label": dict(seed=2, n_valid=1),
    "no valid label": dict(seed=3, n_valid=0),
    "class out of range": dict(seed=4, kind="class out of range"),
    "A=180, not a multiple of 128": dict(seed=5, m=13, size=96),
    "5 and 0 candidates in two images": dict(seed=10, b=3, m=12,
                                              kind="few candidates"),
}


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_dense_and_chunked(name, chunk):
    targs = _torch(_case(**CASES[name]))
    fg, matched, piou = simota_fused(*targs)
    want = tyolox.simota_assign(*targs, chunk=chunk)
    if name == "no valid label":
        assert not bool(fg.any())
    else:
        assert int(fg.sum()) > 0
    assert torch.equal(fg, want.fg_mask)
    assert torch.equal(matched, want.matched_gt)
    np.testing.assert_allclose(piou.numpy(), want.pred_ious.numpy(),
                               rtol=0, atol=1e-6)


def test_few_candidates_match_pallas_interpret():
    """Rows whose image has fewer than 10 candidates, and valid rows of an
    image with none: the k-th cost and the top-10 IoU sum reach past the
    candidates. Against the Pallas kernel at the bounds of
    `test_plain_matches_pallas_interpret`."""
    args = _case(**CASES["5 and 0 candidates in two images"])
    fg, matched, piou = (t.numpy() for t in simota_fused_plain(*_torch(args)))
    jargs = tuple(jnp.asarray(v) for v in args)
    jargs = (jargs[0], jargs[1].astype(jnp.int32)) + jargs[2:]
    fg_ref, matched_ref, piou_ref = (np.asarray(o) for o in
                                     simota_assign_pallas(*jargs,
                                                          interpret=True))
    assert not fg[1].any() and not fg_ref[1].any()
    assert 0 < int(fg[0].sum()) <= 5
    assert (fg == fg_ref).mean() > 0.999
    both = fg & fg_ref
    np.testing.assert_array_equal(matched[both], matched_ref[both])
    np.testing.assert_allclose(piou[both], piou_ref[both], atol=1e-5)
    assert abs(int(fg.sum()) - int(fg_ref.sum())) <= 2


def test_loss_with_pallas_assign_matches_jax_few_candidates():
    """The loss through the fused assignment against JAX's, where one image
    has a label with 9 candidates (4x4 px, 15 px beyond the corner) and
    another only labels outside every gate."""
    maps, labels = _problem(11, empty_image=False)
    labels[0, 0] = (1.0, 79.0, 79.0, 4.0, 4.0)
    labels[2, :, 1:3] = np.where(labels[2, :, 3:4] > 0, 600.0, 0.0)
    want = _jax_pallas_loss_and_grads(maps, labels)
    got = _torch_loss_and_grads(maps, labels, use_l1=True, pallas_assign=True)
    _assert_loss_matches(got, want)


def test_ties_and_duplicate_labels_match_dense():
    """Identical predictions at every anchor and labels repeated twice:
    costs tie in large groups and anchors are claimed more than once, so
    the k-th cost counts ties and the argmin takes the first label."""
    gt, gcls, gval, preds, obj, cls, xs, ys, st = _case(6, m=12, n_valid=6)
    gt[:, 6:], gcls[:, 6:], gval[:, 6:] = gt[:, :6], gcls[:, :6], True
    preds[:] = preds[:1, :1]
    obj[:] = obj[0, 0]
    cls[:] = cls[0, 0]
    targs = _torch((gt, gcls, gval, preds, obj, cls, xs, ys, st))
    fg, matched, piou = simota_fused(*targs)
    want = tyolox.simota_assign(*targs)
    assert int(fg.sum()) > 0 and int(matched.max()) < 6
    assert torch.equal(fg, want.fg_mask)
    assert torch.equal(matched, want.matched_gt)
    assert torch.equal(piou, want.pred_ious)


def test_nan_logits_end_and_claim_nothing():
    """A NaN logit is outside the contract, but the plain version (as the
    kernel) ends on it: a NaN cost claims nothing, the other anchors are
    still assigned, and the outputs are finite."""
    args = _case(7)
    args[5][:, ::5, 2] = np.nan
    fg, _, piou = simota_fused(*_torch(args))
    assert not bool(fg[:, ::5].any())
    assert int(fg.sum()) > 0
    assert bool(torch.isfinite(piou).all())


@functools.lru_cache(maxsize=None)
def _jax_pallas_loss():
    """`_jax_loss_and_grads(..., use_l1=True, pallas_assign=True)` under
    `jax.jit`: the Pallas kernel in interpret mode is traced once a shape,
    not run op by op (16 s a call here)."""
    def fn(outs, labels):
        losses = jyolox.yolox_loss(outs, labels, NUM_CLASSES, STRIDES,
                                   use_l1=True, pallas_assign=True)
        return losses["loss"], losses
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


def _jax_pallas_loss_and_grads(maps, labels):
    (_, losses), grads = _jax_pallas_loss()([jnp.asarray(m) for m in maps],
                                            jnp.asarray(labels))
    return losses, grads


def test_loss_with_pallas_assign_matches_jax():
    """yolox_loss(pallas_assign=True): the port's fused assignment against
    JAX's Pallas kernel in interpret mode, then the same loss and map
    gradients."""
    maps, labels = _problem(7)
    want = _jax_pallas_loss_and_grads(maps, labels)
    got = _torch_loss_and_grads(maps, labels, use_l1=True, pallas_assign=True)
    assert float(want[0]["proportion"]) > 0
    _assert_loss_matches(got, want)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_loss_with_pallas_assign_equals_dense_and_wins_over_chunk(seed):
    """On the CPU the fused assignment equals the dense one on these
    inputs, so the loss equals the dense loss; `pallas_assign` wins over
    `assign_chunk`, as in the JAX package."""
    maps, labels = _problem(seed, scale=1.0 + seed / 4)
    fused = _torch_loss_and_grads(maps, labels, use_l1=True,
                                  pallas_assign=True, assign_chunk=2)
    dense = _torch_loss_and_grads(maps, labels, use_l1=True)
    for k in dense[0]:
        assert torch.equal(fused[0][k], dense[0][k]), k
    for a, b in zip(fused[1], dense[1]):
        assert torch.equal(a, b)


def test_loss_spec_forwards_pallas_assign():
    cfg = load_config(CONFIG_DIR / "model" / "yolox_nano.yaml")
    cfg["loss"].update(pallas_assign=True, stride=list(STRIDES))
    spec = build_model(cfg, NUM_CLASSES, device="cpu").loss
    assert spec.train_loss.keywords["pallas_assign"] is True
    maps, labels = _problem(8)
    got = spec.train_loss([torch.from_numpy(m) for m in maps],
                          torch.from_numpy(labels))
    want = _torch_loss_and_grads(maps, labels, pallas_assign=True)[0]
    assert torch.equal(got["loss"], want["loss"].detach())


def test_cpu_tensors_take_the_plain_version():
    targs = list(_torch(_case(0)))
    for i in (3, 4, 5):
        targs[i].requires_grad_()
    before = simota_fused.launches
    got = simota_fused(*targs)
    assert simota_fused.launches == before
    for g in got:
        assert not g.requires_grad and g.grad_fn is None
    with torch.no_grad():
        want = simota_fused_plain(*targs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bad(name):
    args = list(_torch(_case(0)))
    if name == "fp64 boxes":
        args[0] = args[0].double()
    elif name == "int32 classes":
        args[1] = args[1].int()
    elif name == "uint8 validity":
        args[2] = args[2].to(torch.uint8)
    elif name == "bf16 cls logits":
        args[5] = args[5].bfloat16()
    elif name == "predictions of another A":
        args[3] = args[3][:, :-1]
    elif name == "labels without a box dim of 4":
        args[0] = args[0][..., :3]
    elif name == "fewer than 10 anchors":
        args = [t[:, :9] if i in (3, 4, 5) else t[:9] if i >= 6 else t
                for i, t in enumerate(args)]
    elif name == "a device that is neither cpu nor cuda":
        args = [t.to("meta") for t in args]
    return args


@pytest.mark.parametrize("name,err", [
    ("fp64 boxes", TypeError), ("int32 classes", TypeError),
    ("uint8 validity", TypeError), ("bf16 cls logits", TypeError),
    ("predictions of another A", ValueError),
    ("labels without a box dim of 4", ValueError),
    ("fewer than 10 anchors", ValueError),
    ("a device that is neither cpu nor cuda", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(name, err):
    before = simota_fused.launches
    with pytest.raises(err):
        simota_fused(*_bad(name))
    assert simota_fused.launches == before


def test_sample_draws_without_a_generator_follows_resolve_device():
    """With no generator, `sample_draws` draws on the card, or raises
    without one; `device="cpu"` draws on the CPU."""
    cfg = taug.AugmentConfig()
    draws = taug.sample_draws(None, 4, (32, 48), cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in draws)
    assert draws.perm.shape == (4,)
    if torch.cuda.is_available():
        assert taug.sample_draws(None, 4, (32, 48), cfg).perm.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            taug.sample_draws(None, 4, (32, 48), cfg)
