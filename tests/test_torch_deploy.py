"""Port parity: deployment from `pl_yolo_tpu_torch` (`deploy.export`, the
host runtimes copied into `deploy/`, the deploy tools) against the JAX
package on the CPU, fp32, at 64 px, with the tiny configs of the JAX deploy
tests (`test_numpy_deploy.TINY`, `test_deploy_v7.TINY_V7`,
`test_deploy_v5.TINY_V5`). Each model starts from the port's seeded init,
and the JAX side gets the same weights through the bridge (a flax init of
these models takes tens of seconds on the CPU).

Tolerances: the TorchScript file and the ONNX file (through the numpy
runtime) against the JAX eval forward at rtol 1e-3, atol 1e-4, the JAX
deploy tests' bound; the exported program's boxes against JAX
`postprocess` of the JAX decode at atol 1e-4 with `valid` equal
(`test_export.py`'s bound); the npz bit for bit; the NMS operator's CPU
version equal to `suppress_plain`; the port's forward against the JAX
package's torch rebuild of the same npz at rtol 1e-4, atol 1e-4 (two
torch forwards, BN folded in one of them).
"""

import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pl_yolo_tpu.deploy import numpy_infer as jni
from pl_yolo_tpu.models.detector import build_model as jax_build_model
from pl_yolo_tpu.ops.nms import postprocess as jax_postprocess
from pl_yolo_tpu_torch.bridge import load_variables, state_dict_to_variables
from pl_yolo_tpu_torch.deploy import export
from pl_yolo_tpu_torch.deploy import onnx_numpy_runtime as rt
from pl_yolo_tpu_torch.deploy import onnx_writer as ow
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.ops.cuda.nms_suppress import suppress_plain
from pl_yolo_tpu_torch.ops.nms import suppress_op
from pl_yolo_tpu_torch.train.checkpoint import CheckpointManager
from pl_yolo_tpu_torch.utils.fuse import fold_bn_
from test_deploy_v5 import TINY_V5
from test_deploy_v7 import TINY_V7
from test_numpy_deploy import TINY

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SIZE, BATCH, NUM_CLASSES = 64, 2, 3
RTOL, ATOL = 1e-3, 1e-4


def _variant(cfg, **sections):
    cfg = json.loads(json.dumps(cfg))
    for section, updates in sections.items():
        cfg[section].update(updates)
    return cfg


CONFIGS = {
    "yolox": TINY,
    "yolox_depthwise": _variant(TINY, **{s: {"depthwise": True} for s in
                                         ("backbone", "neck", "head")}),
    "yolov7": TINY_V7,
    "yolov7_repconv": _variant(TINY_V7, neck={"use_repconv": True}),
    "yolov5": TINY_V5,
}
FAMILIES = ("yolox", "yolov7", "yolov5")  # the npz's three


@functools.lru_cache(maxsize=None)
def case(name):
    """The port model (seeded init, CPU), its weights as JAX variables, a
    batch of images, the jitted JAX eval forward of them, and the ONNX
    bytes of the port model (made once: the ONNX tests share them)."""
    cfg = CONFIGS[name]
    model = build_model(dict(cfg), NUM_CLASSES, device="cpu")
    variables = state_dict_to_variables(model.module.state_dict(),
                                        model.module)
    jmodel = jax_build_model(dict(cfg), num_classes=NUM_CLASSES)
    img = np.random.default_rng(3).uniform(
        0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    # XLA's backend optimisations off: half the compile time, the same
    # fp32 operations
    forward = jax.jit(lambda v, x: jmodel.loss.eval_decode(
        jmodel.module.apply(v, x, False))).lower(
        variables, jnp.asarray(img)).compile(
        {"xla_backend_optimization_level": 0})
    jax_out = np.asarray(forward(variables, jnp.asarray(img)), np.float32)
    return dict(model=model, variables=variables, jax_forward=forward,
                img=img, nchw=np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
                jax_out=jax_out,
                onnx=export.export_onnx(model, batch=BATCH, size=SIZE))


# ------------------------------------------------- the copied host runtime

@pytest.mark.parametrize("name", ["numpy_infer.py", "onnx_writer.py",
                                  "onnx.proto", "torch_onnx.py",
                                  "onnx_numpy_runtime.py"])
def test_deploy_copies_are_the_jax_originals(name):
    """Four files byte-equal; the ONNX runtime keeps the original's bytes
    as its head and adds ops after them."""
    original = (ROOT / "pl_yolo_tpu" / "deploy" / name).read_bytes()
    copy = (ROOT / "pl_yolo_tpu_torch" / "deploy" / name).read_bytes()
    if name == "onnx_numpy_runtime.py":
        assert copy.startswith(original) and len(copy) > len(original)
    else:
        assert copy == original


@pytest.mark.parametrize("op,inputs,attrs,want", [
    ("Split", [np.arange(24.).reshape(2, 3, 4), np.array([1, 3])],
     {"axis": -1}, lambda x, s: tuple(np.split(x, [1], axis=-1))),
    ("Split", [np.arange(24.).reshape(2, 3, 4)], {"axis": 1,
                                                  "split": [2, 1]},
     lambda x: tuple(np.split(x, [2], axis=1))),
    ("Tile", [np.arange(6.).reshape(2, 3), np.array([2, 1])], {},
     lambda x, r: np.tile(x, (2, 1))),
    ("OneHot", [np.array([[0, 2], [-1, 5]]), np.array(3),
                np.array([0., 1.], np.float32)], {"axis": -1},
     lambda i, d, v: np.array([[[1, 0, 0], [0, 0, 1]], [[0, 0, 1],
                                                          [0, 0, 0]]],
                              np.float32)),
    ("OneHot", [np.array([1, 0]), np.array([3]), np.array([2, 7])],
     {"axis": 0}, lambda i, d, v: np.array([[2, 7], [7, 2], [2, 2]])),
    ("Flatten", [np.arange(24.).reshape(2, 3, 4)], {"axis": 2},
     lambda x: x.reshape(6, 4)),
    ("Pow", [np.array([1.5, 2.0], np.float32), np.array(2.0, np.float32)],
     {}, lambda a, b: np.array([2.25, 4.0], np.float32)),
])
def test_ops_added_to_the_onnx_runtime(op, inputs, attrs, want):
    """The ops the port's graphs need beyond the JAX runtime's, with ONNX
    semantics (Split's sizes as an input or, before opset 13, an
    attribute; OneHot's negative and out-of-range indices)."""
    got, expected = rt._OPS[op](inputs, attrs), want(*inputs)
    if isinstance(expected, tuple):
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            np.testing.assert_array_equal(g, e)
    else:
        np.testing.assert_array_equal(got, expected)
        assert got.dtype == expected.dtype


# --------------------------------------------------------------------- npz

@pytest.mark.parametrize("name", FAMILIES)
def test_npz_equals_the_jax_export(name, tmp_path):
    """JAX variables bridged into a port model of another seed, exported
    by the port, give `tools/export_npz.py`'s file of those variables: the
    same keys, every array bit for bit, the same meta."""
    from tools.export_npz import export_npz as jax_export_npz

    c = case(name)
    port = build_model(dict(CONFIGS[name]), NUM_CLASSES, device="cpu",
                       seed=1)
    load_variables(port.module, c["variables"])
    meta = export.export_npz(CONFIGS[name], port, tmp_path / "port.npz")
    jmeta = jax_export_npz(CONFIGS[name], c["variables"],
                           str(tmp_path / "jax.npz"), NUM_CLASSES)
    assert meta == jmeta
    got, want = (np.load(tmp_path / f) for f in ("port.npz", "jax.npz"))
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_npz_refuses_another_family(tmp_path):
    cfg = _variant(TINY, head={"name": "implicit_head"})
    with pytest.raises(SystemExit, match="npz deploy covers"):
        export.npz_meta(cfg, NUM_CLASSES)


@pytest.mark.parametrize("name", FAMILIES)
def test_port_forward_matches_the_jax_torch_rebuild(name, tmp_path):
    """The port's eval forward against the JAX package's torch.nn rebuild
    (`deploy/torch_infer.py::build_torch_model`) of the port's own npz."""
    from pl_yolo_tpu.deploy.torch_infer import build_torch_model

    c = case(name)
    export.export_npz(CONFIGS[name], c["model"], tmp_path / "m.npz")
    rebuild = build_torch_model(*jni.load_npz(str(tmp_path / "m.npz"))).eval()
    with torch.no_grad():
        want = rebuild(torch.from_numpy(c["nchw"])).numpy()
        got = c["model"].loss.eval_decode(
            c["model"].module(torch.from_numpy(c["img"]))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ TorchScript, ONNX

@pytest.mark.parametrize("name", ["yolox", "yolov7_repconv"])
def test_fold_bn_keeps_the_eval_forward(name):
    """`fold_bn_` (after `fuse_repconvs_`) leaves no BatchNorm and the eval
    forward, the Focus stem's 6x6 route with its new bias included."""
    c = case(name)
    folded = export.eval_copy(c["model"])
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    x = torch.from_numpy(c["img"])
    with torch.no_grad():
        want = c["model"].module(x)
        got = folded(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="eval-mode"):
        fold_bn_(folded.train())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_torchscript_file_matches_jax(name, tmp_path):
    c = case(name)
    path = tmp_path / "m.pt"
    export.export_torchscript(c["model"], path, size=SIZE, batch=BATCH)
    with torch.no_grad():
        got = torch.jit.load(str(path))(torch.from_numpy(c["nchw"])).numpy()
    assert got.shape == c["jax_out"].shape
    np.testing.assert_allclose(got, c["jax_out"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_onnx_file_matches_jax(name, tmp_path):
    """torch's graph of the folded module, written by the copied writer,
    read back from the file and run by the numpy runtime."""
    c = case(name)
    path = tmp_path / "m.onnx"
    path.write_bytes(c["onnx"])
    m = rt.OnnxModel(path.read_bytes())
    assert m.input_names == ["images"] and m.output_names == ["predictions"]
    got = m.run({"images": c["nchw"]})["predictions"]
    assert got.shape == c["jax_out"].shape
    np.testing.assert_allclose(got, c["jax_out"], rtol=RTOL, atol=ATOL)


def test_onnx_structural_contract():
    """IR / opset headers and static shapes, as `test_onnx_export.py`
    holds the JAX package's graph; BN folded; opset 13's forms; every
    node input defined before its use."""
    blob = case("yolox")["onnx"]
    mp = ow.parse_message(blob)
    assert mp[1][0] == 8                       # ir_version
    assert ow.parse_message(mp[8][0])[2][0] == 13
    gp = ow.parse_message(mp[7][0])
    vi = ow.parse_message(gp[11][0])
    tt = ow.parse_message(ow.parse_message(vi[2][0])[1][0])
    assert tt[1][0] == ow.FLOAT
    dims = [ow.parse_message(d)[1][0] for d in ow.parse_message(tt[2][0])[1]]
    assert dims == [BATCH, 3, SIZE, SIZE]
    m = rt.OnnxModel(blob)
    ops = {n[0] for n in m.nodes}
    assert {"Conv", "Sigmoid", "Concat", "MaxPool", "Resize"} <= ops
    assert "BatchNormalization" not in ops
    assert all(len(n[1]) == 2 and "split" not in n[3]
               for n in m.nodes if n[0] == "Split")
    known = set(m.initializers) | {"images"}
    for op, inputs, outputs, _ in m.nodes:
        for i in inputs:
            assert i in known, f"{op} consumes undefined {i}"
        known.update(outputs)
    assert "predictions" in known


@pytest.fixture(scope="module")
def onnx_pb2(tmp_path_factory):
    """The copied onnx.proto compiled with protoc; skips without protoc."""
    if shutil.which("protoc") is None:
        pytest.skip("protoc not available")
    out = tmp_path_factory.mktemp("onnxpb")
    deploy = ROOT / "pl_yolo_tpu_torch" / "deploy"
    subprocess.run(["protoc", f"--proto_path={deploy}", f"--python_out={out}",
                    "onnx.proto"], check=True)
    sys.path.insert(0, str(out))
    try:
        import onnx_pb2 as pb
    finally:
        sys.path.pop(0)
    return pb


def test_onnx_official_reserialization_runs_identically(onnx_pb2):
    """The official protobuf runtime reads the port's file (IR 8, opset
    13, every node), and its canonical re-serialization runs bit for bit
    as the file does."""
    c = case("yolov7")
    mp = onnx_pb2.ModelProto()
    mp.ParseFromString(c["onnx"])
    assert mp.ir_version == 8
    assert [(o.domain, o.version) for o in mp.opset_import] == [("", 13)]
    assert len(mp.graph.node) == len(rt.OnnxModel(c["onnx"]).nodes)
    a = rt.OnnxModel(c["onnx"]).run({"images": c["nchw"]})["predictions"]
    b = rt.OnnxModel(mp.SerializeToString()).run(
        {"images": c["nchw"]})["predictions"]
    np.testing.assert_array_equal(a, b)


# ------------------------------------------- the served program, the NMS op

def test_nms_operator_opcheck_and_plain_version():
    """`torch.library.opcheck` on the operator (schema, fake version,
    autograd registration, AOT dispatch); its CPU result equals
    `suppress_plain` and never aliases `valid`."""
    gen = torch.Generator().manual_seed(0)
    for b, k in ((1, 1), (2, 17), (3, 64)):
        xy = torch.rand(b, k, 2, generator=gen) * 50
        boxes = torch.cat([xy, xy + 5 + torch.rand(b, k, 2, generator=gen)
                           * 20], -1)
        valid = torch.rand(b, k, generator=gen) > 0.2
        if k == 17:
            torch.library.opcheck(suppress_op, (boxes, valid, 0.5))
        got = torch.ops.pl_yolo_tpu_torch.nms_suppress(boxes, valid, 0.5)
        assert torch.equal(got, suppress_plain(boxes, valid, 0.5))
        assert got.data_ptr() != valid.data_ptr()
    with pytest.raises(ValueError, match="boxes must be"):
        suppress_op(torch.zeros(2, 4), torch.zeros(2, dtype=torch.bool), 0.5)


def test_suppression_of_non_finite_boxes_matches_jax():
    """A trained model's decode may overflow into boxes of infinite width
    or height (served as they are): the plain suppression, which the
    kernel follows operation for operation, keeps what JAX's keeps, an
    inf - inf union (NaN) suppressing nothing."""
    from pl_yolo_tpu.ops.nms import _iou_matrix, greedy_suppress

    gen = torch.Generator().manual_seed(7)
    xy = torch.rand(2, 64, 2, generator=gen) * 64
    boxes = torch.cat([xy, xy + 20 + torch.rand(2, 64, 2, generator=gen)
                       * 40], -1)
    boxes[:, ::4, 0], boxes[:, ::4, 2] = -np.inf, np.inf
    boxes[:, 1::8, 3] = np.inf
    boxes[:, 2::16, 1] = np.nan
    valid = torch.rand(2, 64, generator=gen) < 0.9
    got = suppress_plain(boxes, valid, 0.5)
    for b in range(2):
        want = greedy_suppress(_iou_matrix(jnp.asarray(boxes[b].numpy())),
                               jnp.asarray(valid[b].numpy()), 0.5)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert int(got.sum()) < int(valid.sum())  # the finite boxes suppress


def test_artifact_comparisons_hold_non_finite_entries():
    """The same infinity (or NaN) on both sides counts 0; a value finite on
    one side only counts inf; else |a - b| / max(1, |b|)."""
    want = np.array([np.inf, -np.inf, np.nan, 2.0, 0.5], np.float32)
    got = want.copy()
    got[3], got[4] = 2.5, 0.25
    assert export.max_abs_err(got, want, relative=True) == pytest.approx(0.25)
    assert export.max_abs_err(got, want) == pytest.approx(0.5)
    got[0] = 1e30
    assert export.max_abs_err(got, want, relative=True) == np.inf
    boxes = torch.tensor([[[0.0, 0.0, np.inf, 4.0], [1, 1, 2, 2]]])
    det = (boxes, torch.tensor([[0.5, 0.25]]), torch.tensor([[1, 2]]),
           torch.tensor([[True, True]]))
    assert export.detections_err(det, det) == {
        "same_valid": True, "n_valid": 2, "max_rel": 0.0}
    other = (boxes.nan_to_num(posinf=1e9), *det[1:])
    assert export.detections_err(other, det)["max_rel"] == np.inf
    flipped = (*det[:3], torch.tensor([[True, False]]))
    assert not export.detections_err(flipped, det)["same_valid"]


# ------------------------------------------------------------ the tools

@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """A port checkpoint of the tiny YOLOX as the trainer writes one: the
    module, an EMA module whose weights and BN statistics moved, the
    optimizer state; and its model YAML."""
    root = tmp_path_factory.mktemp("deploy_ckpt")
    config = root / "tiny.yaml"
    config.write_text(yaml.safe_dump(CONFIGS["yolox"]))
    model = build_model(dict(CONFIGS["yolox"]), NUM_CLASSES, device="cpu")
    ema = build_model(dict(CONFIGS["yolox"]), NUM_CLASSES, device="cpu",
                      seed=5).module
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in ema.state_dict().items():
            if name.endswith("running_mean"):
                t.normal_(0.0, 0.5, generator=gen)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 2.0, generator=gen)
        for k in range(3):  # boxes ~7 strides wide: neighbours overlap
            getattr(ema.head, f"reg_pred{k}").bias[2:4] = 2.0
    CheckpointManager(root / "checkpoints").save(
        7, {"step": 7, "module": model.module.state_dict(),
            "ema_module": ema.state_dict(), "optimizer": {}}, {"mAP": 0.1})
    return config, root / "checkpoints", ema


def test_checkpoint_restores_its_ema_weights(port_checkpoint):
    config, ckpt, ema = port_checkpoint
    model, step = export.load_model(config, NUM_CLASSES, "cpu", ckpt)
    assert step == 7
    for key, t in ema.state_dict().items():
        assert torch.equal(model.module.state_dict()[key], t), key


def _deploy_from_ckpt(port_checkpoint, out_dir, tol):
    """Run the tool in process; returns (exit code, its JSON line)."""
    import contextlib
    import io

    from pl_yolo_tpu_torch.tools import deploy_from_ckpt
    config, ckpt, _ = port_checkpoint
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = deploy_from_ckpt.main([
            "-c", str(config), "--checkpoint", str(ckpt), "--num-classes",
            str(NUM_CLASSES), "--size", str(SIZE), "--out-dir", str(out_dir),
            "--device", "cpu", "--tol", str(tol)])
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    return code, json.loads(lines[0])


def test_deploy_from_ckpt_passes_with_every_artifact(port_checkpoint,
                                                     tmp_path):
    code, res = _deploy_from_ckpt(port_checkpoint, tmp_path, 5e-3)
    assert code == 0 and res["pass"] and res["ckpt_step"] == 7
    for key in ("npz_numpy_max_abs", "onnx_numpy_max_abs",
                "torchscript_max_abs"):
        assert res[key] <= 1e-3, key
    assert {p.name for p in tmp_path.iterdir()} == {
        "model.npz", "model.onnx", "model.pt"}


def test_deploy_from_ckpt_fails_below_its_measured_error(port_checkpoint,
                                                         tmp_path):
    code, res = _deploy_from_ckpt(port_checkpoint, tmp_path, 1e-9)
    assert max(v for k, v in res.items() if k.endswith("_max_abs")) > 1e-9
    assert code == 1 and not res["pass"]


def test_exported_program_matches_jax_postprocess(port_checkpoint,
                                                  tmp_path):
    """The checkpoint's `.pt2` (forward + decode + postprocess), saved and
    loaded on the CPU: its detections against JAX `postprocess` on the JAX
    decode of the same EMA weights (boxes to 1e-4, `valid` and the valid
    classes equal) and bit-equal to the port's eager served function; the
    suppression is one node of the registered operator; moved to another
    device, every tensor follows (the `meta` device stands in for the
    card)."""
    config, ckpt, ema = port_checkpoint
    conf, nms = 1e-5, 0.65  # the random weights score ~1e-4
    model, _ = export.load_model(config, NUM_CLASSES, "cpu", ckpt,
                                 fp32=False)
    path = tmp_path / "m.pt2"
    program = export.export_program(model, path, batch=BATCH, size=SIZE,
                                    conf=conf, nms=nms)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("pl_yolo_tpu_torch.nms_suppress.default") == 1
    c = case("yolox")
    x = torch.from_numpy(c["img"])
    with torch.no_grad():
        got = export.load_program(path, "cpu")(x)
        eager = export.ServeModule(model.module, model.loss.eval_decode,
                                   conf, nms)(x)
    for g, e in zip(got, eager):
        assert torch.equal(g, e)
    variables = state_dict_to_variables(ema.state_dict(), ema)
    det = jax.jit(lambda p: jax_postprocess(p, conf_threshold=conf,
                                            iou_threshold=nms))(
        c["jax_forward"](variables, jnp.asarray(c["img"])))
    valid = np.asarray(det.valid)
    np.testing.assert_array_equal(got[3].numpy(), valid)
    n_anchors = sum((SIZE // s) ** 2 for s in (8, 16, 32))
    assert 10 < valid.sum(1).max() < n_anchors  # the NMS suppressed some
    np.testing.assert_allclose(got[0].numpy(), np.asarray(det.boxes),
                               atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy()[valid],
                                  np.asarray(det.classes)[valid])
    moved = export.on_device(program, "meta").module()(x.to("meta"))
    assert all(t.device.type == "meta" for t in moved)
    assert [t.shape for t in moved] == [t.shape for t in got]


@pytest.mark.parametrize("tool,args", [
    ("export_npz", ["-c", "{config}"]),
    ("export_torchscript", ["-c", "{config}"]),
    ("export_onnx", ["-c", "{config}"]),
    ("export", ["-c", "{config}"]),
    ("deploy_from_ckpt", ["-c", "{config}", "--checkpoint", "{ckpt}",
                          "--num-classes", "3"]),
    ("inference_demo", ["--image", "{image}", "-c", "{config}"]),
])
def test_tools_refuse_to_start_without_a_card(tool, args, port_checkpoint,
                                              tmp_path):
    """No card and no `--device cpu`: the tool exits before it builds
    anything, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    import importlib
    config, ckpt, _ = port_checkpoint
    main = importlib.import_module(f"pl_yolo_tpu_torch.tools.{tool}").main
    args = [a.format(config=config, ckpt=ckpt, image=tmp_path / "x.jpg")
            for a in args]
    with pytest.raises(SystemExit, match="--device cpu"):
        main(args + (["--out", str(tmp_path / "out")]
                     if tool.startswith("export_") else []))
    assert not any(tmp_path.iterdir())


def test_tools_on_the_cpu(port_checkpoint, tmp_path, capsys):
    """`--device cpu`: the npz and TorchScript exporters with --verify from
    the checkpoint, the ONNX demo on a JPEG (the tiny YOLOX's graph), and
    the inference demo with the live model."""
    from PIL import Image

    from pl_yolo_tpu_torch.tools import (export_npz, export_torchscript,
                                         inference_demo, onnx_demo)
    config, ckpt, _ = port_checkpoint
    common = ["-c", str(config), "--checkpoint", str(ckpt),
              "--num-classes", "3", "--device", "cpu", "--verify"]
    assert export_npz.main(common + ["--out", str(tmp_path / "m.npz"),
                                     "--size", "64"]) == 0
    assert export_torchscript.main(common + ["--out", str(tmp_path / "m.pt"),
                                             "--size", "64"]) == 0
    (tmp_path / "m.onnx").write_bytes(case("yolox")["onnx"])
    image = tmp_path / "x.jpg"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (48, 80, 3), np.uint8)).save(image)
    assert onnx_demo.main([str(tmp_path / "m.onnx"), str(image), "--conf",
                           "0", "--out", str(tmp_path / "d.json")]) == 0
    assert json.loads((tmp_path / "d.json").read_text())
    assert inference_demo.main([
        "--image", str(image), "-c", str(config), "--ckpt", str(ckpt),
        "--num-classes", "3", "--size", "64", "--conf", "0.0",
        "-o", str(tmp_path / "d.jpg"), "--device", "cpu"]) == 0
    assert Image.open(tmp_path / "d.jpg").size == (80, 48)
    out = capsys.readouterr().out
    assert "parity OK" in out and "eager-vs-torchscript-file" in out
