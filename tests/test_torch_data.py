"""Port parity: the host data side of `pl_yolo_tpu_torch` (copied modules,
datasets, loaders, the data module, the CLI's config handling) against the
JAX package on the CPU, on a synthetic COCO set of 64 px.

The copied modules must equal their originals line for line, except for the
edits listed in `COPIES`; the loaders must yield the same batches, exactly.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pl_yolo_tpu.data import datasets as jds
from pl_yolo_tpu.data import loader as jloader
from pl_yolo_tpu_torch.data import datasets as tds
from pl_yolo_tpu_torch.data import loader as tloader
from pl_yolo_tpu_torch.data.datamodule import build_data
from pl_yolo_tpu_torch.utils.config import (CONFIG_DIR, load_config,
                                            train_argument_parser,
                                            validate_data_config)
from pl_yolo_tpu_torch.utils.flops import model_summary
from synthetic_coco import make_coco

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# copy -> (original, top-level names the port rewrote, line replacements
# applied to the original). Import lines may differ on both sides.
COPIES = {
    "utils/image_io.py": ("utils/image_io.py", (), ()),
    "data/datasets.py": ("data/datasets.py", (), ()),
    "data/disk_cache.py": ("data/disk_cache.py", (), ()),
    "data/aug_extra.py": ("data/aug_extra.py", (), ()),
    # pinned host memory and a non_blocking copy to a torch device
    "data/loader.py": ("data/loader.py", ("device_prefetch",), ()),
    # the copy of native/rle.cpp inside the package, built into its build/
    "evaluators/mask_ops.py": ("evaluators/mask_ops.py",
                               ("_SRC", "_LIB_PATH", "_build"), ()),
    "evaluators/coco_api.py": ("evaluators/coco_api.py", (), ()),
    "evaluators/coco_eval.py": ("evaluators/coco_eval.py", (), ()),
    "evaluators/voc_eval.py": ("evaluators/voc_eval.py", (), ()),
    # the port's Detections hold torch tensors, on any device
    "evaluators/format.py": ("evaluators/format.py", (), tuple(
        (f"np.asarray(det.{f})", f"det.{f}.cpu().numpy()")
        for f in ("boxes", "scores", "classes", "valid"))),
    "utils/visualize.py": ("utils/visualize.py", (), ()),
    "utils/logger.py": ("utils/logger.py", (), ()),
    "utils/autoanchor.py": ("utils/autoanchor.py", (), ()),
}


def _comparable_lines(text: str, rewritten) -> list[str]:
    """The source's lines without its import statements and without the
    top-level functions and assignments named in `rewritten`."""
    tree = ast.parse(text)
    drop = set()
    for node in tree.body:
        names = set()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = {None}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = {node.name}
        elif isinstance(node, ast.Assign):
            names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        if names & ({None} | set(rewritten)):
            first = min([node.lineno]
                        + [d.lineno for d in getattr(node, "decorator_list",
                                                     [])])
            drop.update(range(first, node.end_lineno + 1))
    return [line for i, line in enumerate(text.splitlines(), 1)
            if i not in drop]


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copied_module_equals_its_original(copy):
    original, rewritten, replacements = COPIES[copy]
    want = (ROOT / "pl_yolo_tpu" / original).read_text()
    for old, new in replacements:
        assert old in want
        want = want.replace(old, new)
    got = (ROOT / "pl_yolo_tpu_torch" / copy).read_text()
    for name in rewritten:  # a listed rewrite is still there
        assert any(getattr(n, "name", None) == name
                   or name in {getattr(t, "id", None)
                               for t in getattr(n, "targets", [])}
                   for n in ast.parse(got).body), name
    assert _comparable_lines(got, rewritten) == _comparable_lines(
        want, rewritten)


def test_native_rle_source_is_a_byte_copy():
    assert ((ROOT / "pl_yolo_tpu_torch/native/rle.cpp").read_bytes()
            == (ROOT / "native/rle.cpp").read_bytes())


def test_package_imports_where_jax_is_blocked():
    """Every module of the port imports in a process where JAX, flax,
    optax, orbax and the JAX package cannot (test_torch_nms greps the
    sources for such imports)."""
    modules = [".".join(path.relative_to(ROOT).with_suffix("").parts)
               .removesuffix(".__init__")
               for path in sorted((ROOT / "pl_yolo_tpu_torch").rglob("*.py"))]
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in {'jax', 'flax', 'optax', "
            "'orbax', 'pl_yolo_tpu'}:\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------------ data and loaders

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return make_coco(tmp_path_factory.mktemp("coco"), num_images=6)


def _datasets(root, **kw):
    args = (str(root), "annotations/instances.json", "images")
    kw = dict(img_size=(64, 64), max_labels=10, **kw)
    return jds.COCODataset(*args, **kw), tds.COCODataset(*args, **kw)


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k


def test_datasets_match_jax(coco_root):
    jset, tset = _datasets(coco_root)
    assert len(jset) == len(tset) and jset.class_ids == tset.class_ids
    for i in range(len(jset)):
        for a, b in zip(jset[i], tset[i]):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    for a, b in zip(jset.gt_per_class(3), tset.gt_per_class(3)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("workers", [0, 2])
def test_train_loader_yields_the_jax_batches(coco_root, workers):
    jset, tset = _datasets(coco_root)
    want = jloader.TrainLoader(jset, batch_size=4, seed=7)
    got = tloader.TrainLoader(tset, batch_size=4, seed=7,
                              num_workers=workers)
    try:
        assert got.steps_per_epoch == want.steps_per_epoch
        for _ in range(4):  # spans epoch boundaries (6 images, bs 4)
            _assert_batches_equal(next(want), next(got))
    finally:
        want.close()
        got.close()


def test_eval_batches_match_jax(coco_root):
    jset, tset = _datasets(coco_root)
    want = list(jloader.eval_batches(jset, 4))
    got = list(tloader.eval_batches(tset, 4))
    assert [b["count"] for b in got] == [4, 2]
    assert len(want) == len(got)
    for a, b in zip(want, got):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("threaded", [False, True])
def test_device_prefetch_keeps_order_and_dtypes(threaded):
    rng = np.random.default_rng(0)
    src = [{"images": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
            "labels": rng.normal(size=(2, 5, 5)).astype(np.float32),
            "img_id": np.arange(2)} for _ in range(6)]
    it = tloader.device_prefetch(iter(src * 2), "cpu", depth=2,
                                 threaded=threaded)
    try:
        for want in src:
            got = next(it)
            assert sorted(got) == ["images", "labels"]
            assert got["images"].dtype == torch.uint8
            assert got["labels"].dtype == torch.float32
            np.testing.assert_array_equal(got["images"].numpy(),
                                          want["images"])
            np.testing.assert_array_equal(got["labels"].numpy(),
                                          want["labels"])
    finally:
        it.close()


# ----------------------------------------------------------- data module, cli

DATA_YAMLS = ("coco2017", "pascal2012", "shapes_demo", "shapes_hard", "gc10",
              "neu", "al", "coco2017_multiscale")


def test_data_configs_are_copied():
    names = {p.stem for p in (CONFIG_DIR / "data").glob("*.yaml")}
    assert names == set(DATA_YAMLS)
    for name in DATA_YAMLS:
        validate_data_config(load_config(CONFIG_DIR / "data" / f"{name}.yaml"))


def _data_cfg(root, **transform):
    cfg = load_config(CONFIG_DIR / "data" / "coco2017.yaml")
    cfg["dataset"].update(dir=str(root), train="images", val="images",
                          train_json="annotations/instances.json",
                          val_json="annotations/instances.json",
                          train_size=[64, 64], val_size=[64, 64],
                          train_batch_size=4, val_batch_size=4)
    cfg["transform"].update(transform)
    cfg["num_classes"], cfg["classes"] = 3, ["class0", "class1", "class2"]
    return validate_data_config(cfg)


def test_datamodule_builds_the_jax_loaders_and_a_torch_augment(coco_root):
    from pl_yolo_tpu.data.datamodule import build_data as jax_build_data
    cfg = _data_cfg(coco_root)
    jdm, tdm = jax_build_data(cfg, seed=3), build_data(cfg, seed=3)
    for dm in (jdm, tdm):
        dm.setup("fit")
    assert tdm.augment_cfg._asdict().keys() <= jdm.augment_cfg._asdict().keys()
    for k, v in tdm.augment_cfg._asdict().items():
        assert v == getattr(jdm.augment_cfg, k), k
    want, got = jdm.train_loader(), tdm.train_loader()
    try:
        _assert_batches_equal(next(want), next(got))
    finally:
        want.close()
        got.close()
    for a, b in zip(jdm.val_batches(), tdm.val_batches()):
        _assert_batches_equal(a, b)
    batch = next(iter(tdm.val_batches()))
    images = torch.from_numpy(batch["images"])
    labels = torch.zeros((4, 50, 5))  # as the train loader pads them
    gen = torch.Generator().manual_seed(0)
    out, out_labels = tdm.make_augment_fn(out_s2d=True)(gen, images, labels,
                                                       enable=False)
    assert out.shape == (4, 32, 32, 12) and out_labels.shape == (4, 100, 5)
    with pytest.raises(KeyError, match="Unknown datamodule"):
        build_data({**cfg, "datamodule": "nope"})


def test_cli_parser_takes_the_jax_flags_and_a_device():
    from pl_yolo_tpu.utils.config import train_argument_parser as jax_parser
    port = {a.dest: a.default for a in train_argument_parser()._actions}
    jax = {a.dest: a.default for a in jax_parser()._actions}
    assert port.pop("device") is None
    assert port == jax
    args = train_argument_parser().parse_args(
        ["-c", "m.yaml", "-d", "d.yaml", "--device", "cpu", "--resume"])
    assert args.device == "cpu" and args.resume and args.ckpt is None
    with pytest.raises(ValueError, match="num_classes"):
        validate_data_config({"datamodule": "coco", "dataset": {},
                              "transform": {}, "num_classes": 2,
                              "classes": ["a"]})


def test_model_summary_counts_params_and_conv_flops(monkeypatch):
    from pl_yolo_tpu_torch.models.detector import build_model
    cfg = load_config(CONFIG_DIR / "model" / "yolox_nano.yaml")
    module = build_model(cfg, 3, device="cpu").module
    convs, conv2d = [], torch.nn.functional.conv2d

    def counted(x, w, *args, **kw):  # 2 FLOPs a multiply-add
        out = conv2d(x, w, *args, **kw)
        convs.append(2 * out.numel() * w[0].numel())
        return out

    monkeypatch.setattr(torch.nn.functional, "conv2d", counted)
    with torch.no_grad():
        module(torch.zeros(1, 64, 64, 3))
    monkeypatch.undo()
    module.train()
    n_params, flops, text = model_summary(module, input_size=(64, 64))
    assert module.training
    assert n_params == sum(p.numel() for p in module.parameters())
    assert len(convs) > 50 and flops == sum(convs)
    assert text == (f"Params: {n_params / 1e6:.2f}M, FLOPs: "
                    f"{flops / 1e9:.2f}G @ 64x64")
