"""Port parity: the NMS suppression's plain version against the JAX package's
Pallas kernel (interpret mode) and jnp `greedy_suppress`, exactly; the
weight bridge; and the port's independence from JAX.
"""

import ast
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.models.detector import build_model as jax_build_model
from pl_yolo_tpu.ops.nms import _iou_matrix as jax_iou_matrix
from pl_yolo_tpu.ops.nms import greedy_suppress as jax_greedy_suppress
from pl_yolo_tpu.ops.pallas.nms_pallas import pallas_suppress
from pl_yolo_tpu_torch.bridge import (load_variables, state_dict_to_variables,
                                      variables_to_state_dict)
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.ops.cuda.nms_suppress import nms_suppress
from pl_yolo_tpu_torch.utils.config import load_config

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _sorted_boxes(rng, b, k, n_classes):
    """Score-sorted xyxy boxes with the class offset added in fp32, as
    batched_nms hands them to the suppression step."""
    cxy = rng.uniform(0, 100, (b, k, 2))
    wh = rng.uniform(20, 80, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    cls = rng.integers(0, n_classes, (b, k)).astype(np.float32)
    boxes = boxes + (cls * np.float32(4096.0))[..., None]
    valid = rng.uniform(0, 1, (b, k)) < 0.85
    return boxes, valid


@pytest.mark.parametrize("k", [64, 300])
@pytest.mark.parametrize("thr", [0.5, 0.65])
def test_suppress_plain_matches_jax(k, thr):
    boxes, valid = _sorted_boxes(np.random.default_rng(k), 2, k, 3)
    got = nms_suppress(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    want_pallas = pallas_suppress(jnp.asarray(boxes), jnp.asarray(valid), thr,
                                  interpret=True)
    want_jnp = jax.vmap(
        lambda b, v: jax_greedy_suppress(jax_iou_matrix(b), v, thr))(
        jnp.asarray(boxes), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jnp))
    assert 0 < int(got.sum()) < int(valid.sum())  # something was suppressed


def test_suppress_cpu_path_counts_no_launch():
    before = nms_suppress.launches
    boxes, valid = _sorted_boxes(np.random.default_rng(0), 1, 64, 2)
    nms_suppress(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert nms_suppress.launches == before


@pytest.mark.parametrize("bad", ["rank", "dtype", "valid_shape"])
def test_suppress_rejects_bad_input(bad):
    boxes = torch.zeros(2, 8, 4)
    valid = torch.ones(2, 8, dtype=torch.bool)
    if bad == "rank":
        boxes = boxes[0]
    elif bad == "dtype":
        boxes = boxes.double()
    else:
        valid = valid[:, :4]
    with pytest.raises((ValueError, TypeError)):
        nms_suppress(boxes, valid, 0.5)


@pytest.fixture(scope="module")
def tiny_variables():
    cfg = load_config(ROOT / "pl_yolo_tpu/configs/model/yolox_s.yaml")
    cfg["backbone"]["channels"] = [8, 16, 32, 64, 128]
    cfg["backbone"]["depths"] = [1, 1, 1, 1]
    cfg["neck"]["channels"] = [32, 64, 128]
    cfg["head"]["channels"] = [32, 64, 128]
    cfg["dtype"] = None
    jmodel = jax_build_model(copy.deepcopy(cfg), 3)
    # jitted: eagerly, a flax init compiles its ops one by one
    variables = jax.device_get(jax.jit(lambda k: jmodel.init(
        k, input_size=(64, 64)))(jax.random.key(1)))
    return cfg, variables


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def test_bridge_round_trip_is_identity(tiny_variables):
    cfg, variables = tiny_variables
    module = build_model(copy.deepcopy(cfg), 3, device="cpu").module
    load_variables(module, variables)
    back = _flat(state_dict_to_variables(module.state_dict()))
    want = _flat(variables)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_bridge_accepts_flat_npz_keys(tiny_variables):
    """The flat `params/...`, `batch_stats/...` keys of tools/export_npz.py."""
    cfg, variables = tiny_variables
    flat = _flat(variables)
    flat["__meta__"] = np.asarray("{}")
    module = build_model(copy.deepcopy(cfg), 3, device="cpu").module
    a = variables_to_state_dict(flat, module)
    b = variables_to_state_dict(variables, module)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("broken", ["missing", "unmapped"])
def test_bridge_raises_on_bad_key(tiny_variables, broken):
    cfg, variables = tiny_variables
    flat = _flat(variables)
    if broken == "missing":
        del flat["params/head/obj_pred0/bias"]
    else:
        flat["params/head/obj_pred0/extra"] = np.zeros(3, np.float32)
    module = build_model(copy.deepcopy(cfg), 3, device="cpu").module
    with pytest.raises(KeyError):
        variables_to_state_dict(flat, module)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_never_imports_jax():
    files = sorted((ROOT / "pl_yolo_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_topk_ab.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "pl_yolo_tpu", "tools", "make_shapes_dataset"
                               ), f"{path}: imports {name}"
