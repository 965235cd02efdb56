"""Port parity: the YOLOX inference slice of `pl_yolo_tpu_torch` against the
JAX package on the CPU, fp32, with tiny widths at 64 px.

Head maps and the eval decode are held within rtol=atol=1e-4: both sides
compute in fp32, but the convolution sums run in another order through ~70
layers (and exp() of the wh logits grows the decode's absolute error).
NMS and `postprocess`, fed the same decoded predictions, must be equal.
"""

import copy
from pathlib import Path

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.models.detector import build_model as jax_build_model
from pl_yolo_tpu.ops import nms as jnms
from pl_yolo_tpu_torch.bridge import load_variables
from pl_yolo_tpu_torch.layers.drops import DropBlock2d, dropout_generator
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.ops import nms as tnms
from pl_yolo_tpu_torch.utils.config import load_config, validate_model_config

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

# the JAX references compile at XLA's backend optimization level 0: the
# same functions, compiled in about three quarters of the time (results
# within an ulp or so of level 2's)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

ROOT = Path(__file__).resolve().parents[1]
MAPS_TOL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES, SIZE = 3, 64


def _tiny_cfg():
    cfg = validate_model_config(load_config(
        ROOT / "pl_yolo_tpu_torch/configs/model/yolox_s.yaml"))
    cfg["backbone"]["channels"] = [8, 16, 32, 64, 128]
    cfg["backbone"]["depths"] = [1, 1, 1, 1]
    cfg["neck"]["channels"] = [32, 64, 128]
    cfg["head"]["channels"] = [32, 64, 128]
    cfg["dtype"] = None  # fp32 on both sides (yolox_s.yaml says bfloat16)
    return cfg


@pytest.fixture(scope="module")
def slice_outputs():
    """JAX and torch head maps and decodes of one seeded batch."""
    cfg = _tiny_cfg()
    jmodel = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
    # jitted: eagerly, a flax init and apply compile their ops one by one
    variables = jax.device_get(_jit(lambda k: jmodel.init(
        k, input_size=(SIZE, SIZE)))(jax.random.key(0)))
    tmodel = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu")
    load_variables(tmodel.module, variables)
    x = np.random.default_rng(0).uniform(0, 255, (2, SIZE, SIZE, 3)
                                         ).astype(np.float32)
    jmaps = _jit(lambda v, x: jmodel.module.apply(v, x, False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        tmaps = tmodel.module(torch.from_numpy(x))
    return dict(jmaps=[np.asarray(m) for m in jmaps], tmaps=tmaps,
                jdec=np.asarray(_jit(jmodel.loss.eval_decode)(jmaps)),
                tdec=tmodel.loss.eval_decode(tmaps).numpy())


def test_head_maps_match_jax(slice_outputs):
    jmaps, tmaps = slice_outputs["jmaps"], slice_outputs["tmaps"]
    assert [m.shape for m in jmaps] == [tuple(m.shape) for m in tmaps]
    for j, t in zip(jmaps, tmaps):
        np.testing.assert_allclose(t.numpy(), j, **MAPS_TOL)


def test_eval_decode_matches_jax(slice_outputs):
    jdec, tdec = slice_outputs["jdec"], slice_outputs["tdec"]
    assert tdec.shape == jdec.shape == (2, 64 + 16 + 4, 5 + NUM_CLASSES)
    np.testing.assert_allclose(tdec, jdec, **MAPS_TOL)


def _clustered_predictions(rng, b=2, a=400, c=NUM_CLASSES):
    """Decoded predictions with heavy overlap: boxes jittered around a few
    centres, so that suppression, class offsets and ties all matter."""
    centres = rng.uniform(40, 600, (b, 6, 2))
    pick = rng.integers(0, 6, (b, a))
    cxy = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 6, (b, a, 2))
    wh = rng.uniform(40, 120, (b, a, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    obj = rng.uniform(0, 1, (b, a, 1))
    cls = rng.uniform(0, 1, (b, a, c))
    obj[:, 1::2], cls[:, 1::2] = obj[:, 0::2], cls[:, 0::2]  # tied scores
    return np.concatenate([boxes, obj, cls], -1).astype(np.float32)


MODES = {
    "plain": dict(),
    "class_agnostic": dict(class_agnostic=True),
    "multi_label": dict(multi_label=True),
    "merge": dict(merge=True),
}


def _jax_postprocess(preds, conf, iou, mode):
    if mode != "merge":
        return jnms.postprocess(jnp.asarray(preds), conf_threshold=conf,
                                iou_threshold=iou, max_det=100,
                                pre_nms_topk=256, **MODES[mode])
    # the JAX postprocess has no merge option: call batched_nms as it would
    p = jnp.asarray(preds)
    cls = p[..., 5:]
    return jnms.batched_nms(p[..., :4], p[..., 4] * jnp.max(cls, -1),
                            jnp.argmax(cls, -1).astype(jnp.int32),
                            conf_threshold=conf, iou_threshold=iou,
                            max_det=100, pre_nms_topk=256, merge=True)


@pytest.mark.parametrize("source", ["model", "clustered"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_postprocess_matches_jax(slice_outputs, source, mode):
    if source == "model":
        preds, conf = slice_outputs["jdec"], 1e-5  # random init: scores ~1e-4
    else:
        preds, conf = _clustered_predictions(np.random.default_rng(3)), 0.05
    want = _jax_postprocess(preds, conf, 0.5, mode)
    got = tnms.postprocess(torch.from_numpy(preds.copy()), conf_threshold=conf,
                           iou_threshold=0.5, max_det=100, pre_nms_topk=256,
                           device="cpu", **MODES[mode])
    assert int(np.asarray(want.valid).sum()) > 0
    for field in ("valid", "classes", "scores"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    if mode == "merge":
        # merged boxes are a [K,K]x[K,4] product: the sum order differs
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   rtol=1e-6, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))


def test_unknown_registry_name_raises():
    cfg = _tiny_cfg()
    cfg["neck"]["name"] = "bifpn"  # a name neither package registers
    with pytest.raises(KeyError, match="Unknown neck 'bifpn'"):
        build_model(cfg, NUM_CLASSES, device="cpu")


def test_build_is_seeded_and_defaults_to_cuda():
    a = build_model(_tiny_cfg(), NUM_CLASSES, device="cpu", seed=5).module
    b = build_model(_tiny_cfg(), NUM_CLASSES, device="cpu", seed=5).module
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(_tiny_cfg(), NUM_CLASSES)


def test_drop_block_train_mode_not_ported_yet():
    """DropBlock (ported since, `layers/drops.py`): identity in eval mode,
    and in train mode a DropBlock after each backbone stage that draws
    from the generator it is given."""
    cfg = _tiny_cfg()
    cfg["backbone"]["drop_block"] = {"rate": 0.1, "size": 3}
    module = build_model(cfg, NUM_CLASSES, device="cpu").module
    plain = build_model(_tiny_cfg(), NUM_CLASSES, device="cpu").module
    x = torch.rand(1, SIZE, SIZE, 3) * 255
    with torch.no_grad():
        for got, want in zip(module(x), plain(x)):  # eval: identity
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        blocks = [m for m in module.backbone.modules()
                  if isinstance(m, DropBlock2d)]
        assert len(blocks) == 4 and blocks[0].block_size == 3
        outs = []
        for seed in (0, 0, 1):
            with dropout_generator(module, torch.Generator().manual_seed(seed)):
                outs.append(module.train()(x))
        assert all(torch.isfinite(o).all() for o in outs[0])
        assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
        assert not all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))
