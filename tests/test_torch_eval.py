"""Port parity: the evaluation side of `pl_yolo_tpu_torch` (output
formatting, COCO and VOC metrics, RLE masks, `Trainer.validate`) against the
JAX package on the CPU, tiny widths at 64 px.

`format_outputs`, the COCO and VOC evaluators and the RLE ops must give the
same results, exactly. `Trainer.validate` on weights bridged from a JAX init
must give the JAX pipeline's mAP (`_eval_fn` -> `postprocess` ->
`format_outputs` -> `coco_evaluator`) within 1e-6: the two forwards differ
by ~1e-5 (the convolution sums run in another order), which moves a box by
far less than any IoU threshold, on a case whose NMS has no near-ties (the
test checks that first).
"""

import copy
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.data.datasets import COCODataset as JaxCOCODataset
from pl_yolo_tpu.evaluators import coco_eval as jeval
from pl_yolo_tpu.evaluators import format as jformat
from pl_yolo_tpu.evaluators import mask_ops as jmask
from pl_yolo_tpu.evaluators import voc_eval as jvoc
from pl_yolo_tpu.models.detector import build_model as jax_build_model
from pl_yolo_tpu.ops import nms as jnms
from pl_yolo_tpu.ops.nms import Detections as JaxDetections
from pl_yolo_tpu.train.trainer import Trainer as JaxTrainer
from pl_yolo_tpu.data.loader import eval_batches
from pl_yolo_tpu_torch.bridge import load_variables, state_dict_to_variables
from pl_yolo_tpu_torch.data.datasets import COCODataset
from pl_yolo_tpu_torch.evaluators import coco_eval as teval
from pl_yolo_tpu_torch.evaluators import format as tformat
from pl_yolo_tpu_torch.evaluators import mask_ops as tmask
from pl_yolo_tpu_torch.evaluators import voc_eval as tvoc
from pl_yolo_tpu_torch.ops.nms import Detections
from pl_yolo_tpu_torch.train.trainer import Trainer
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config
from synthetic_coco import make_coco

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

NUM_CLASSES, SIZE, CONF, IOU = 3, 64, 0.3, 0.65
VAL_TOL = 1e-6  # on mAP and mAP50, port validate vs the JAX pipeline


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return make_coco(tmp_path_factory.mktemp("coco"), num_images=4)


def _dataset(cls, root, json_file="annotations/instances.json"):
    return cls(str(root), json_file, "images", img_size=(SIZE, SIZE),
               max_labels=100)


def _random_detections(rng, b=4, n=40):
    x1y1 = rng.uniform(0, 50, (b, n, 2))
    wh = rng.uniform(2, 30, (b, n, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    classes = rng.integers(0, NUM_CLASSES, (b, n)).astype(np.int32)
    valid = rng.uniform(0, 1, (b, n)) < 0.7
    valid[1] = False  # an image without detections
    return boxes, scores, classes, valid


def test_format_and_evaluators_match_jax(coco_root):
    rng = np.random.default_rng(0)
    arrays = _random_detections(rng)
    jset, tset = _dataset(JaxCOCODataset, coco_root), _dataset(COCODataset,
                                                               coco_root)
    ids = np.arange(1, 5)
    hs, ws = np.full(4, 120), np.full(4, 160)
    jl, dl = jformat.format_outputs(JaxDetections(*arrays), ids, hs, ws,
                                    (SIZE, SIZE), jset.class_ids,
                                    NUM_CLASSES, count=3)
    tl, tdl = tformat.format_outputs(
        Detections(*map(torch.from_numpy, arrays)), ids, hs, ws,
        (SIZE, SIZE), tset.class_ids, NUM_CLASSES, count=3)
    assert len(tl) > 20 and tl == jl
    for a, b in zip(dl, tdl):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
            assert y.dtype == x.dtype
    assert teval.coco_evaluator(tl, tset) == jeval.coco_evaluator(jl, jset)
    want = jeval.evaluate_coco(jl, jset.eval_annotations)
    got = teval.evaluate_coco(tl, tset.eval_annotations)
    assert got == want and got.per_class_ap == want.per_class_ap
    gt = jset.gt_per_class(NUM_CLASSES)[:4]
    assert (tvoc.voc_evaluator(tdl, gt, class_names=["a", "b", "c"])
            == jvoc.voc_evaluator(dl, gt, class_names=["a", "b", "c"]))


def test_rle_ops_match_jax():
    """The port builds its own copy of the RLE library (into
    pl_yolo_tpu_torch/build/) and gives the JAX package's results."""
    rng = np.random.default_rng(1)
    masks = (rng.uniform(size=(3, 23, 17)) < 0.4).astype(np.uint8)
    j = [jmask.encode(m) for m in masks]
    t = [tmask.encode(m) for m in masks]
    assert t == j
    assert Path(tmask._LIB_PATH).parent.name == "build"
    for r in t:
        np.testing.assert_array_equal(tmask.decode(r), jmask.decode(r))
        assert tmask.area(r) == jmask.area(r)
        np.testing.assert_array_equal(tmask.toBbox(r), jmask.toBbox(r))
    np.testing.assert_array_equal(tmask.iou(t, t, [0, 1, 0]),
                                  jmask.iou(j, j, [0, 1, 0]))
    assert tmask.merge(t) == jmask.merge(j)
    poly = [[2.0, 2.0, 15.0, 3.0, 9.0, 20.0]]
    assert tmask.frPyObjects(poly, 23, 17) == jmask.frPyObjects(poly, 23, 17)


# -------------------------------------------------- validate on bridged weights

def _tiny_cfg():
    cfg = load_config(CONFIG_DIR / "model" / "yolox_s.yaml")
    cfg["backbone"]["channels"] = [8, 16, 32, 64, 128]
    cfg["backbone"]["depths"] = [1, 1, 1, 1]
    cfg["neck"]["channels"] = [32, 64, 128]
    cfg["head"]["channels"] = [32, 64, 128]
    cfg["dtype"] = None  # fp32 on both sides (yolox_s.yaml says bfloat16)
    return cfg


def _randomize(variables, rng):
    """Seeded values for every leaf; biases N(0, 1), so that the scores
    spread over (0, 1) instead of sitting at the heads' prior."""
    def leaf(path, x):
        name = path[-1].key
        if name == "var":
            v = rng.uniform(0.5, 2.0, x.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.1, x.shape)
        elif name == "bias":
            v = rng.normal(0.0, 1.0, x.shape)
        else:  # kernel: unit-variance outputs
            v = rng.normal(0.0, np.sqrt(1.0 / np.prod(x.shape[:-1])), x.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _derived_gt(root, json_list):
    """An annotation file whose boxes are each image's three best-scored
    detections: the mAP then depends on every stage of the pipeline."""
    doc = json.loads((root / "annotations/instances.json").read_text())
    doc["annotations"] = []
    for img in doc["images"]:
        dets = sorted((d for d in json_list if d["image_id"] == img["id"]),
                      key=lambda d: -d["score"])[:3]
        for d in dets:
            doc["annotations"].append({
                "id": len(doc["annotations"]) + 1, "image_id": img["id"],
                "category_id": d["category_id"], "bbox": d["bbox"],
                "area": d["bbox"][2] * d["bbox"][3], "iscrowd": 0})
    (root / "annotations/derived.json").write_text(json.dumps(doc))
    return "annotations/derived.json"


def _no_near_ties(preds):
    """No two candidates of a class within 1e-5 in score (the two
    pipelines' scores differ by ~1e-7; NMS and the COCO matching both walk
    the scores in order), and no candidate pair's IoU within 1e-4 of the
    NMS threshold."""
    preds = np.asarray(preds, np.float64)
    conf = preds[..., 4] * preds[..., 5:].max(-1)
    cls = preds[..., 5:].argmax(-1)
    for c in range(NUM_CLASSES):
        s = np.sort(conf[(conf > CONF) & (cls == c)])
        if len(s) > 1 and np.diff(s).min() < 1e-5:
            return False
    for p, keep in zip(preds, conf > CONF):
        b = p[keep, :4]
        lt = np.maximum(b[:, None, :2], b[None, :, :2])
        rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), -1)
        area = np.prod(b[:, 2:] - b[:, :2], -1)
        iou = inter / (area[:, None] + area[None] - inter)
        if np.any(np.abs(iou[np.triu_indices(len(b), 1)] - IOU) < 1e-4):
            return False
    return True


def test_validate_on_bridged_weights_matches_the_jax_pipeline(coco_root,
                                                              tmp_path):
    cfg = _tiny_cfg()
    data_cfg = load_config(CONFIG_DIR / "data" / "coco2017.yaml")
    data_cfg["dataset"].update(
        dir=str(coco_root), val="images", val_size=[SIZE, SIZE],
        val_batch_size=4, val_json="annotations/derived.json")
    data_cfg["num_classes"] = NUM_CLASSES
    data_cfg["classes"] = ["class0", "class1", "class2"]
    trainer = Trainer(copy.deepcopy(cfg), data_cfg,
                      output_dir=str(tmp_path), logger="csv", device="cpu")
    trainer.state = trainer._build_state(total_steps=10)
    # seeded weights, bridged into the JAX model and the port's EMA copy;
    # seed 2 is a case without near-ties (seeds 0 and 1 have scores of one
    # class within 1e-5 of each other, which the check below refuses)
    variables = _randomize(state_dict_to_variables(
        trainer.state.ema_module.state_dict()), np.random.default_rng(2))
    load_variables(trainer.state.ema_module, variables)
    jmodel = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
    eval_fn = JaxTrainer._eval_fn(types.SimpleNamespace(model=jmodel))
    jset = _dataset(JaxCOCODataset, coco_root)
    json_list, preds = [], []
    for batch in eval_batches(jset, 4):
        p = eval_fn(variables, jnp.asarray(batch["images"]))
        preds.append(np.asarray(p))
        det = jnms.postprocess(p, conf_threshold=CONF, iou_threshold=IOU)
        json_list += jformat.format_outputs(
            det, batch["img_id"], batch["img_h"], batch["img_w"],
            (SIZE, SIZE), jset.class_ids, NUM_CLASSES,
            count=batch["count"])[0]
    assert _no_near_ties(np.concatenate(preds))
    _derived_gt(coco_root, json_list)
    jset = _dataset(JaxCOCODataset, coco_root, "annotations/derived.json")
    want_ap, want_ap50, _ = jeval.coco_evaluator(json_list, jset)
    assert 0.05 < want_ap < 1.0 and want_ap50 > want_ap

    ap, ap50 = trainer.validate(conf=CONF, nms=IOU)
    assert abs(ap - want_ap) <= VAL_TOL and abs(ap50 - want_ap50) <= VAL_TOL
    assert trainer.eval_times["batches"] == 1
    assert trainer.eval_times["detections"] > 0
    assert set(trainer.eval_times) == {"batches", "detections", "infer_s",
                                       "nms_s", "format_s", "coco_eval_s"}
