"""Port parity: the NMS suppression's plain version against the JAX package's
Pallas kernel (interpret mode) and jnp `greedy_suppress`, exactly; the
weight bridge; and the port's independence from JAX.
"""

import ast
import copy
import ctypes
import re
import types
from pathlib import Path

import functools

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
from pl_yolo_tpu_torch.ops.cuda import nms_suppress as nms_module
from pl_yolo_tpu_torch.ops.cuda.nms_suppress import nms_suppress
from pl_yolo_tpu_torch.utils.config import load_config

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

# the JAX references compile at XLA's backend optimization level 0: the
# same functions, compiled in about three quarters of the time (results
# within an ulp or so of level 2's)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

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


# 65: a ragged block; 525: the 160 px gate's candidate count
@pytest.mark.parametrize("k", [64, 300, 65, 525])
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
    before = nms_suppress.launches, nms_suppress.large_k_launches
    boxes, valid = _sorted_boxes(np.random.default_rng(0), 1, 64, 2)
    nms_suppress(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert (nms_suppress.launches, nms_suppress.large_k_launches) == before


_CSRC = ROOT / "pl_yolo_tpu_torch" / "csrc"


def test_traced_kernel_names_are_kernels():
    """Each kernel name chip_smoke.py looks for in a profiler trace is a
    __global__ function of the port's CUDA sources."""
    smoke = (ROOT / "chip_smoke.py").read_text()
    wanted = set(re.findall(r'"([a-z_]+_kernel)"', smoke))
    kernels = set()
    for src in _CSRC.glob("*.cu"):
        kernels.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
            src.read_text()))
    assert "nms_cluster_kernel" in wanted and len(wanted) >= 3
    assert wanted <= kernels, sorted(wanted - kernels)


def _c_argtypes(source: str, name: str) -> list:
    params = re.search(rf"\bint {name}\(([^)]*)\)", source).group(1)
    types_ = []
    for param in params.split(","):
        if "*" in param or "cudaStream_t" in param:
            types_.append(ctypes.c_void_p)
        elif param.split()[0] == "int":
            types_.append(ctypes.c_int)
        elif param.split()[0] == "float":
            types_.append(ctypes.c_float)
        else:
            raise AssertionError(f"unmapped parameter {param!r}")
    return types_


def test_nms_source_constants_and_signature_match_callers():
    """The capacity of the cluster kernel and the K limit in the source are
    the wrapper's, and the exported C function takes the argument types
    that the wrapper and chip_nms_ab.py give it."""
    import chip_nms_ab
    source = (_CSRC / "nms_suppress.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", source))
    assert int(const["kClusterMaxK"]) == nms_module.CLUSTER_MAX_K
    assert int(const["kMaxK"]) == nms_module.MAX_K
    assert nms_module.CLUSTER_MAX_K < nms_module.MAX_K
    want = _c_argtypes(source, "nms_suppress")
    assert list(nms_module.ARGTYPES) == want
    fake = types.SimpleNamespace(nms_suppress=types.SimpleNamespace())
    chip_nms_ab.bare_call(torch, fake)
    assert list(fake.nms_suppress.argtypes) == want


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
    variables = jax.device_get(_jit(lambda k: jmodel.init(
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
    chips = sorted(ROOT.glob("chip_*.py"))
    assert {"chip_smoke.py", "chip_nms_ab.py"} <= {p.name for p in chips}
    files += chips
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "pl_yolo_tpu", "tools", "make_shapes_dataset"
                               ), f"{path}: imports {name}"
