"""Port parity: the anchor families' other pieces in `pl_yolo_tpu_torch`
against the JAX package on the CPU, fp32, on seeded numpy inputs at 64 px:
CIoU / DIoU and their `iou_loss` types, the YOLOv5 and YOLOv3 losses and
decodes; every copied anchor-family YAML built at tiny widths and trained a
step; the trainer on a tiny YOLOv7 (no Focus stem: NHWC augmentation); and
the repair of the visualization of a non-finite box.

Tolerances: IoU functions 1e-6 (a handful of fp32 operations), their
gradients and the losses' values and input gradients rtol 1e-5 with a small
atol (sums in another order), decodes rtol = atol = 1e-5 (the two
libraries' sigmoid and exp, scaled to pixels). YOLOv3 writes its targets by
label: two valid labels in one cell with one best anchor leave the last
label's values (a numpy loop is the oracle), a case where the JAX package's
result is unspecified, so it is held to JAX only on labels in distinct
cells.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.models.losses import yolov3 as jv3
from pl_yolo_tpu.models.losses import yolov5 as jv5
from pl_yolo_tpu.ops import boxes as jboxes
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.models.losses import yolov3 as tv3
from pl_yolo_tpu_torch.models.losses import yolov5 as tv5
from pl_yolo_tpu_torch.ops import boxes as tboxes
from pl_yolo_tpu_torch.train.optim import build_optimizer
from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
from pl_yolo_tpu_torch.train.trainer import Trainer, finite_detections
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config
from synthetic_coco import make_coco

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

# the JAX references compile at XLA's backend optimization level 0: the
# same functions, compiled in about three quarters of the time (results
# within an ulp or so of level 2's)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

NUM_CLASSES, SIZE = 3, 64
V5_STRIDES, V3_STRIDES = (8, 16, 32), (32, 16, 8)


def _cxcywh(rng, shape, lo=4.0, hi=60.0):
    cxy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(4.0, 40.0, shape + (2,))
    return np.concatenate([cxy, wh], -1).astype(np.float32)


# -------------------------------------------------------------- CIoU, DIoU

@pytest.mark.parametrize("fn,kw", [
    ("ciou", {}), ("diou", {}), ("ciou", {"fmt_cxcywh": False}),
    ("iou_loss", {"loss_type": "ciou"}), ("iou_loss", {"loss_type": "diou"}),
])
def test_ciou_diou_and_their_losses_match_jax(fn, kw):
    """Values to 1e-6, input gradients to rtol 1e-5 (CIoU's alpha is a
    constant to autograd on both sides)."""
    rng = np.random.default_rng(0)
    p, t = _cxcywh(rng, (4, 11)), _cxcywh(rng, (4, 11))
    if kw.get("fmt_cxcywh") is False:
        p, t = (np.array(jboxes.cxcywh2xyxy(v)) for v in (p, t))
    jfn = jax.jit(functools.partial(getattr(jboxes, fn), **kw))
    want, jgrad = _jit(jax.value_and_grad(
        lambda a: jfn(a, jnp.asarray(t)).sum()))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_()
    got = getattr(tboxes, fn)(tp, torch.from_numpy(t), **kw)
    got.sum().backward()
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jfn(jnp.asarray(p), jnp.asarray(t))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got.detach().sum()), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


def test_ciou_of_a_zero_target_box_is_finite_as_in_jax():
    """An unmatched candidate's target is a zero box."""
    p = _cxcywh(np.random.default_rng(1), (6,))
    t = np.zeros_like(p)
    np.testing.assert_allclose(
        tboxes.ciou(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
        np.asarray(_jit(jboxes.ciou)(jnp.asarray(p), jnp.asarray(t))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- YOLOv5

def _maps(rng, strides, batch=3, scale=1.0):
    ch = 3 * (5 + NUM_CLASSES)
    return [rng.normal(0.0, scale, (batch, SIZE // s, SIZE // s, ch)
                       ).astype(np.float32) for s in strides]


def _v5_labels(rng, batch=3, slots=5):
    labels = np.zeros((batch, slots, 5), np.float32)
    for b in range(batch - 1):  # the last image has no label
        n = int(rng.integers(3, slots + 1))
        labels[b, :n, 0] = rng.integers(0, NUM_CLASSES, n)
        labels[b, :n, 1:] = _cxcywh(rng, (n,))
    return labels


def _check_loss(tfn, jfn, maps, labels):
    def jloss(outs, lab):
        losses = jfn(outs, lab)
        return losses["loss"], losses
    (_, jl), jg = _jit(jax.value_and_grad(jloss, has_aux=True))(
        [jnp.asarray(m) for m in maps], jnp.asarray(labels))
    outs = [torch.from_numpy(m).requires_grad_() for m in maps]
    tl = tfn(outs, torch.from_numpy(labels))
    tl["loss"].backward()
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(np.asarray(tl[k].detach()),
                                   np.asarray(jl[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for o, g in zip(outs, jg):
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)
    return {k: float(v) for k, v in jl.items()}


def test_yolov5_loss_and_grads_match_jax():
    rng = np.random.default_rng(2)
    maps, labels = _maps(rng, V5_STRIDES), _v5_labels(rng)
    kw = dict(num_classes=NUM_CLASSES, strides=V5_STRIDES,
              anchors=jv5.DEFAULT_V5_ANCHORS, anchor_threshold=4.0,
              balance=(4.0, 1.0, 0.4), gain={"obj": 0.5})
    losses = _check_loss(functools.partial(tv5.yolov5_loss, **kw),
                         functools.partial(jv5.yolov5_loss, **kw),
                         maps, labels)
    assert losses["proportion"] > 0 and losses["loss_cls"] > 0


def test_yolov5_decode_matches_jax():
    maps = _maps(np.random.default_rng(3), V5_STRIDES)
    args = (V5_STRIDES, jv5.DEFAULT_V5_ANCHORS, NUM_CLASSES)
    got = tv5.yolov5_eval_decode([torch.from_numpy(m) for m in maps], *args)
    want = _jit(lambda ms: jv5.yolov5_eval_decode(ms, *args))(
        [jnp.asarray(m) for m in maps])
    assert got.shape == (3, 3 * (64 + 16 + 4), 5 + NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- YOLOv3

def _v3_labels(rng, batch=3, slots=6):
    """At most one label in each quadrant of an image: distinct cells at
    every level (the coarsest is 2x2), so that no two labels share a target
    slot."""
    labels = np.zeros((batch, slots, 5), np.float32)
    for b in range(batch - 1):
        quads = rng.permutation(4)[:int(rng.integers(2, 5))]
        for i, q in enumerate(quads):
            labels[b, 2 * i, 0] = rng.integers(0, NUM_CLASSES)
            labels[b, 2 * i, 1] = 32 * (q % 2) + rng.uniform(2, 30)
            labels[b, 2 * i, 2] = 32 * (q // 2) + rng.uniform(2, 30)
            labels[b, 2 * i, 3:] = rng.uniform(6, 60, 2)
    return labels


def test_yolov3_loss_and_grads_match_jax():
    rng = np.random.default_rng(4)
    maps, labels = _maps(rng, V3_STRIDES), _v3_labels(rng)
    kw = dict(num_classes=NUM_CLASSES, img_size=(SIZE, SIZE),
              anchors=jv3.DEFAULT_V3_ANCHORS, ignore_threshold=0.5)
    losses = _check_loss(functools.partial(tv3.yolov3_loss, **kw),
                         functools.partial(jv3.yolov3_loss, **kw),
                         maps, labels)
    assert losses["loss"] > 0


def test_yolov3_decode_matches_jax():
    maps = _maps(np.random.default_rng(5), V3_STRIDES, scale=0.5)
    args = (V3_STRIDES, jv3.DEFAULT_V3_ANCHORS, NUM_CLASSES)
    got = tv3.yolov3_eval_decode([torch.from_numpy(m) for m in maps], *args,
                                 img_size=(SIZE, SIZE))
    want = _jit(lambda ms: jv3.yolov3_eval_decode(
        ms, *args, img_size=(SIZE, SIZE)))([jnp.asarray(m) for m in maps])
    assert got.shape == (3, 3 * (4 + 16 + 64), 5 + NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_yolov3_decode_differentiates_after_a_decode_in_inference_mode():
    """The cached anchor tables are made outside inference mode: a decode
    served first under `inference_mode` does not stop a later one from
    saving them for backward."""
    anchors = ((((17, 23),) * 3),) * 3  # a table no other test caches
    maps = [torch.from_numpy(m) for m in
            _maps(np.random.default_rng(5), V3_STRIDES, batch=1)]
    with torch.inference_mode():
        served = tv3.yolov3_eval_decode(maps, V3_STRIDES, anchors,
                                        NUM_CLASSES, img_size=(SIZE, SIZE))
    outs = [m.clone().requires_grad_() for m in maps]
    got = tv3.yolov3_eval_decode(outs, V3_STRIDES, anchors, NUM_CLASSES,
                                 img_size=(SIZE, SIZE))
    got.sum().backward()
    assert torch.equal(got.detach(), served)
    assert all(bool(torch.isfinite(o.grad).all()) for o in outs)


def _targets_by_loop(labels, h, w, sa, num_classes, thr):
    """The reference's rule in numpy: labels in order, each valid one
    writing its best anchor's slot at its cell (a later write wins)."""
    b_, m_ = labels.shape[:2]
    na = len(sa)
    shape = (b_, na, h, w)
    mask, tx, ty, tw, th = (np.zeros(shape, np.float32) for _ in range(5))
    noobj = np.ones(shape, np.float32)
    tcls = np.zeros(shape + (num_classes,), np.float32)
    for b in range(b_):
        for m in range(m_):
            if labels[b, m].sum() <= 0:
                continue
            c, gx, gy, gw, gh = labels[b, m].astype(np.float64)
            gx, gy, gw, gh = gx / SIZE * w, gy / SIZE * h, gw / SIZE * w, \
                gh / SIZE * h
            gi, gj = min(max(int(gx), 0), w - 1), min(max(int(gy), 0), h - 1)
            inter = ((np.minimum(gw, sa[:, 0]) + 1) * (np.minimum(gh, sa[:, 1]) + 1))
            iou = inter / ((gw + 1) * (gh + 1) + (sa[:, 0] + 1) * (sa[:, 1] + 1)
                           - inter + 1e-16)
            a = int(np.argmax(iou))
            mask[b, a, gj, gi] = 1.0
            tx[b, a, gj, gi], ty[b, a, gj, gi] = gx - gi, gy - gj
            tw[b, a, gj, gi] = np.log(gw / sa[a, 0] + 1e-16)
            th[b, a, gj, gi] = np.log(gh / sa[a, 1] + 1e-16)
            tcls[b, a, gj, gi] = 0.0
            tcls[b, a, gj, gi, int(c)] = 1.0
            noobj[b, iou > thr, gj, gi] = 0.0
    return mask, noobj, tx, ty, tw, th, tcls


def test_yolov3_duplicate_cell_keeps_the_last_valid_label():
    """Labels 0, 2 and 4 of image 0 fall in one cell with one best anchor
    (label 3 between them is padding): their targets are label 4's; image 1
    has two such labels in another cell, the second with another class."""
    labels = np.zeros((2, 5, 5), np.float32)
    labels[0, 0] = [0, 20.0, 20.0, 30.0, 24.0]
    labels[0, 1] = [1, 50.0, 52.0, 10.0, 12.0]
    labels[0, 2] = [2, 21.5, 19.0, 28.0, 26.0]
    labels[0, 4] = [1, 22.0, 23.0, 31.0, 22.0]
    labels[1, 0] = [2, 40.0, 10.0, 12.0, 14.0]
    labels[1, 1] = [0, 41.0, 11.0, 13.0, 12.0]
    for li, (h, w) in enumerate([(2, 2), (4, 4), (8, 8)]):
        sa = (np.asarray(jv3.DEFAULT_V3_ANCHORS[li], np.float32)
              / np.float32(SIZE / w))
        lab = torch.from_numpy(labels)
        got = tv3.build_targets(
            lab[..., 1:5] / SIZE, lab[..., 0].long(), lab.sum(2) > 0, h, w,
            torch.from_numpy(sa), NUM_CLASSES, 0.5)
        want = _targets_by_loop(labels, h, w, sa.astype(np.float64),
                                NUM_CLASSES, 0.5)
        for name, g, wv in zip(("mask", "noobj", "tx", "ty", "tw", "th",
                                "tcls"), got, want):
            np.testing.assert_allclose(g.numpy(), wv, rtol=1e-5, atol=1e-6,
                                       err_msg=f"level {li}: {name}")
    # the cell of labels 0, 2 and 4 on the 8x8 map carries label 4's class
    assert got[6][0, :, 2, 2].sum() == 1.0 and got[6][0, :, 2, 2, 1].sum() == 1


# ------------------------------------------------- the copied anchor YAMLs

ANCHOR_YAMLS = ("yolov7", "yolov7_tiny", "al_yolov7", "al_yolov7_tiny",
                "gc10_yolov7", "neu_yolov7", "neu_yolov7_tiny", "yolov5_s")


def _tiny(cfg):
    """Tiny widths and depth 1, the YAML's dtype (bf16) kept."""
    if cfg["backbone"]["name"] == "eelan":
        cfg["backbone"].update(channels=[8, 16, 32, 64, 64])
        cfg["neck"].update(channels=[32, 64, 64])
        cfg["head"]["channels"] = [16, 32, 64]
    else:
        cfg["backbone"].update(channels=[8, 16, 32, 64, 128])
        cfg["neck"].update(channels=[32, 64, 128])
        cfg["head"]["channels"] = [32, 64, 128]
    cfg["backbone"]["depths"] = [1, 1, 1, 1]
    cfg["neck"]["depths"] = [1, 1, 1, 1]
    return cfg


@pytest.mark.parametrize("name", ANCHOR_YAMLS)
def test_anchor_yaml_builds_and_takes_a_train_step(name):
    cfg = _tiny(load_config(CONFIG_DIR / "model" / f"{name}.yaml"))
    model = build_model(cfg, NUM_CLASSES, device="cpu")
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 10)
    state = TrainState.create(model.module, optimizer)
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.uniform(0, 255, (2, SIZE, SIZE, 3)
                                          ).astype(np.float32))
    labels = torch.from_numpy(_v5_labels(rng, batch=2))
    losses = make_train_step(model.loss.train_loss)(state, images, labels)
    assert np.isfinite(float(losses["loss"]))
    assert state.step == 1
    with torch.no_grad():
        maps = model.module.eval()(images)
    # the heads compute in fp32 under the YAML's bf16
    assert cfg["dtype"] == "bfloat16" and all(m.dtype == torch.float32
                                              for m in maps)
    dec = model.loss.eval_decode(maps)
    assert dec.shape == (2, 3 * (64 + 16 + 4), 5 + NUM_CLASSES)


# ------------------------------------------- the trainer on a tiny YOLOv7

def _data_cfg(root):
    cfg = load_config(CONFIG_DIR / "data" / "coco2017.yaml")
    cfg["dataset"].update(
        dir=str(root), train="images", val="images", test="images",
        train_json="annotations/instances.json",
        val_json="annotations/instances.json",
        test_json="annotations/instances.json",
        train_size=[SIZE, SIZE], val_size=[SIZE, SIZE],
        train_batch_size=2, val_batch_size=4)
    cfg["num_classes"], cfg["classes"] = 3, ["class0", "class1", "class2"]
    return cfg


@pytest.fixture(scope="module")
def v7_trainer(tmp_path_factory):
    """One epoch of 2 steps of `Trainer.fit` on a tiny YOLOv7, with the
    images each step received."""
    root = make_coco(tmp_path_factory.mktemp("coco"), num_images=4)
    cfg = _tiny(load_config(CONFIG_DIR / "model" / "yolov7.yaml"))
    cfg.update(dtype=None, name="tiny_v7")
    trainer = Trainer(cfg, _data_cfg(root), max_epochs=1,
                      output_dir=str(tmp_path_factory.mktemp("runs")),
                      logger="csv", log_every_n_steps=1, device="cpu")
    seen = []
    make_step = trainer.make_step

    def recording_make_step():
        step_fn = make_step()

        def step(state, images, labels, **kw):
            losses = step_fn(state, images, labels, **kw)
            seen.append((tuple(images.shape), float(losses["loss"])))
            return losses
        return step
    trainer.make_step = recording_make_step
    trainer.fit()
    return trainer, seen


def test_trainer_fits_a_yolov7_on_nhwc_augmentation(v7_trainer):
    """E-ELAN has no Focus stem: the step takes the augmentation's NHWC
    batch (not the s2d layout) and the model's own input permute."""
    trainer, seen = v7_trainer
    assert not getattr(type(trainer.model.module.backbone), "STEM_S2D")
    assert [s for s, _ in seen] == [(2, SIZE, SIZE, 3)] * 2
    assert all(np.isfinite(loss) for _, loss in seen)
    assert trainer.state.step == 2
    assert 0.0 <= trainer.best_map <= 1.0


def test_visualizing_a_non_finite_box_drops_it_with_a_warning(v7_trainer,
                                                             tmp_path):
    """The repair of ROADMAP C2 in the port's caller: `test(visualize=True)`
    drops a detection with an infinite box (which the drawing cannot take)
    with a warning, as the COCO evaluation does, and draws the rest."""
    trainer, _ = v7_trainer
    decode = trainer.model.loss.eval_decode

    def with_an_infinite_box(outputs):
        preds = decode(outputs).clone()
        preds[:, :2, 2:4] = torch.inf     # xyxy x2, y2 of two anchors
        preds[:, :2, 4:] = 1.0            # scored to be kept and drawn
        return preds
    loss = dataclasses.replace(trainer.model.loss,
                               eval_decode=with_an_infinite_box)
    trainer.model = dataclasses.replace(trainer.model, loss=loss)
    try:
        with pytest.warns(RuntimeWarning, match="non-finite detections "
                          "before drawing"):
            trainer.test(visualize=True, show_dir=str(tmp_path),
                         show_score_thr=0.0)
    finally:
        trainer.model = dataclasses.replace(trainer.model,
                                            loss=dataclasses.replace(
                                                loss, eval_decode=decode))
    assert len(list(tmp_path.glob("*.jpg"))) == 4

    dets = [{"score": 0.9, "bbox": [1.0, 2.0, 3.0, 4.0]},
            {"score": 0.8, "bbox": [1.0, 2.0, np.inf, 4.0]},
            {"score": np.nan, "bbox": [1.0, 2.0, 3.0, 4.0]}]
    with pytest.warns(RuntimeWarning, match="dropped 2 non-finite"):
        assert finite_detections(dets, "drawing") == dets[:1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert finite_detections(dets[:1], "drawing") == dets[:1]
