"""The port's trainer and CLI on the CPU: `Trainer.fit` on a synthetic COCO
set at tiny widths and 64 px (finite losses, checkpoints, mAP, the epoch
schedule and LR against the JAX trainer's rule), checkpoint retention
against the JAX package's Orbax manager, restore, and
`python -m pl_yolo_tpu_torch` through preemption (SIGTERM -> exit 75),
`--resume` and `--test`.
"""

import csv
import json
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pl_yolo_tpu.train.checkpoint import CheckpointManager as JaxManager
from pl_yolo_tpu.train.optim import build_optimizer as jax_build_optimizer
from pl_yolo_tpu_torch.__main__ import main
from pl_yolo_tpu_torch.train.checkpoint import CheckpointManager
from pl_yolo_tpu_torch.train.trainer import Trainer, check_ported
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config
from synthetic_coco import make_coco

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BATCH, IMAGES = 2, 8  # 4 steps an epoch
SPE = IMAGES // BATCH


def _model_cfg():
    cfg = load_config(CONFIG_DIR / "model" / "yolox_s.yaml")
    cfg["backbone"]["channels"] = [8, 16, 32, 64, 128]
    cfg["backbone"]["depths"] = [1, 1, 1, 1]
    cfg["neck"]["channels"] = [32, 64, 128]
    cfg["head"]["channels"] = [32, 64, 128]
    cfg["dtype"] = None
    cfg["name"] = "tiny"
    cfg["schedule"] = {"no_aug_epochs": 1}  # epoch 0 augmented, 1 not
    return cfg


def _data_cfg(root):
    cfg = load_config(CONFIG_DIR / "data" / "coco2017.yaml")
    cfg["dataset"].update(
        dir=str(root), train="images", val="images", test="images",
        train_json="annotations/instances.json",
        val_json="annotations/instances.json",
        test_json="annotations/instances.json",
        train_size=[64, 64], val_size=[64, 64],
        train_batch_size=BATCH, val_batch_size=4)
    cfg["num_classes"], cfg["classes"] = 3, ["class0", "class1", "class2"]
    return cfg


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return make_coco(tmp_path_factory.mktemp("coco"), num_images=IMAGES)


def _jax_rule(cfg, max_epochs, epoch):
    """The JAX trainer's epoch flags (pl_yolo_tpu/train/trainer.py,
    fit: no_aug_epochs, l1_in_no_aug, static_l1), restated."""
    sched = cfg.get("schedule", {}) or {}
    no_aug_epochs = int(sched.get("no_aug_epochs", 0))
    l1_in_no_aug = bool(sched.get("use_l1", True))
    static_l1 = bool(cfg.get("loss", {}).get("use_l1", False))
    if no_aug_epochs <= 0:
        return {}
    no_aug = epoch >= max_epochs - no_aug_epochs
    return {"aug_enable": not no_aug,
            "use_l1": static_l1 or (no_aug and l1_in_no_aug)}


@pytest.mark.parametrize("schedule,use_l1", [
    (None, False), ({"no_aug_epochs": 2}, False),
    ({"no_aug_epochs": 2, "use_l1": False}, False),
    ({"no_aug_epochs": 5}, True), ({"no_aug_epochs": 0}, True)])
def test_epoch_flags_follow_the_jax_rule(schedule, use_l1):
    cfg = {"loss": {"use_l1": use_l1}}
    if schedule is not None:
        cfg["schedule"] = schedule
    fake = types.SimpleNamespace(model_cfg=cfg, max_epochs=4)
    for epoch in range(4):
        assert (Trainer.epoch_flags(fake, epoch)
                == _jax_rule(cfg, 4, epoch)), epoch


@pytest.fixture(scope="module")
def fitted(coco_root, tmp_path_factory):
    """Two epochs of fit, with each step's flags and learning rate."""
    out = tmp_path_factory.mktemp("runs")
    trainer = Trainer(_model_cfg(), _data_cfg(coco_root), max_epochs=2,
                      check_val_every_n_epoch=2, output_dir=str(out),
                      logger="csv", log_every_n_steps=1, device="cpu")
    steps = []
    make_step = trainer.make_step

    def recording_make_step():
        step_fn = make_step()

        def step(state, images, labels, **kw):
            losses = step_fn(state, images, labels, **kw)
            steps.append({"aug_enable": kw.get("aug_enable"),
                          "use_l1": kw.get("use_l1"),
                          "lr": state.optimizer.param_groups[0]["lr"],
                          "images": tuple(images.shape),
                          "dtype": images.dtype})
            return losses
        return step

    trainer.make_step = recording_make_step
    trainer.fit()
    return trainer, steps, out


def test_fit_trains_validates_and_checkpoints(fitted):
    trainer, steps, out = fitted
    rows = list(csv.DictReader(open(out / "tiny/logs/metrics.csv")))
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    assert len(losses) == 2 * SPE and np.all(np.isfinite(losses))
    epochs = [r for r in rows if r.get("loss_epoch")]
    assert len(epochs) == 2
    for r in epochs:
        assert float(r["epoch_img_s"]) > 0 and float(r["step_img_s"]) > 0
    assert trainer.state.step == 2 * SPE
    assert trainer.ckpt.latest_step == 2 * SPE
    assert 0.0 <= trainer.best_map <= 1.0
    assert trainer.ckpt.metrics(2 * SPE)["mAP"] == trainer.best_map
    # the uint8 feed reaches the step, which augments on the device
    assert all(s["images"] == (BATCH, 64, 64, 3) and s["dtype"] == torch.uint8
               for s in steps)


def test_fit_steps_take_the_jax_flags_and_learning_rates(fitted):
    trainer, steps, out = fitted
    cfg = trainer.model_cfg
    want_flags = [_jax_rule(cfg, 2, i // SPE) for i in range(2 * SPE)]
    assert [{"aug_enable": s["aug_enable"], "use_l1": s["use_l1"]}
            for s in steps] == want_flags
    _, schedule = jax_build_optimizer(cfg["optimizer"], 2 * SPE)
    # update n runs at schedule(n); the log at step s shows schedule(s).
    # The JAX schedule computes in fp32 (test_torch_train's bounds)
    tol = dict(rtol=1e-5, atol=1e-6 * cfg["optimizer"]["learning_rate"])
    np.testing.assert_allclose([s["lr"] for s in steps],
                               [float(schedule(n)) for n in range(2 * SPE)],
                               **tol)
    rows = [r for r in csv.DictReader(open(out / "tiny/logs/metrics.csv"))
            if r.get("lr")]
    np.testing.assert_allclose([float(r["lr"]) for r in rows],
                               [float(schedule(int(r["step"]))) for r in rows],
                               **tol)


def test_test_writes_visualizations_and_voc_metrics(coco_root, tmp_path,
                                                    capsys):
    # the random init: its boxes are finite (the drawing raises on an
    # infinite box, in the JAX package's visualize.py too)
    trainer = Trainer(_model_cfg(), _data_cfg(coco_root), output_dir=str(
        tmp_path), logger="csv", device="cpu")
    trainer.state = trainer._build_state(10)
    ap, ap50 = trainer.test(conf=1e-6, visualize=True,
                            show_dir=str(tmp_path / "show"), use_voc=True)
    out = capsys.readouterr().out
    assert np.isfinite(ap) and np.isfinite(ap50) and "mAP = " in out
    assert trainer.eval_times["detections"] > 0
    assert len(list((tmp_path / "show").glob("*"))) > 0


def _assert_state_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_restore_brings_back_step_optimizer_ema_and_bn_stats(fitted,
                                                             coco_root):
    trainer, _, out = fitted
    again = Trainer(_model_cfg(), _data_cfg(coco_root), max_epochs=2,
                    output_dir=str(out), logger="csv", device="cpu")
    again.state = again._build_state(2 * SPE)
    again._steps_per_epoch = SPE
    assert again._restore(None, resume=True) == 2  # the epoch to go on from
    got, want = again.state, trainer.state
    assert got.step == want.step == got.optimizer.updates == 2 * SPE
    _assert_state_dicts_equal(got.module.state_dict(), want.module.state_dict())
    _assert_state_dicts_equal(got.ema_module.state_dict(),
                              want.ema_module.state_dict())
    assert any("running_var" in k for k in got.module.state_dict())
    a, b = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys() and len(a["state"]) > 0
    for i in a["state"]:
        assert torch.equal(a["state"][i]["momentum_buffer"],
                           b["state"][i]["momentum_buffer"])
    # weights only: the step and the optimizer start afresh
    fresh = Trainer(_model_cfg(), _data_cfg(coco_root), max_epochs=2,
                    output_dir=str(out), logger="csv", device="cpu")
    fresh.load_weights(str(out / "tiny/checkpoints"))
    assert fresh.state.step == 0 and not fresh.state.optimizer.state
    _assert_state_dicts_equal(fresh.state.ema_module.state_dict(),
                              want.ema_module.state_dict())


def test_checkpoint_retention_matches_orbax(tmp_path):
    saves = [(1, {"mAP": 0.1}), (2, {}), (3, {"mAP": 0.3}),
             (4, {"mAP": 0.2}), (4, {"mAP": 0.9}), (3, {"mAP": 0.9}),
             (5, {"mAP": 0.2}), (6, {"mAP": 0.3, "preempted": 1.0}),
             (7, {"mAP": 0.05}), (8, {"mAP": 0.3, "mAP50": 0.5})]
    jax_mgr = JaxManager(tmp_path / "jax")
    port = CheckpointManager(tmp_path / "port")
    for step, metrics in saves:
        jax_mgr.save(step, {"step": jnp.asarray(step), "w": jnp.ones(2)},
                     metrics)
        jax_mgr.wait()
        port.save(step, {"step": step, "w": torch.ones(2)}, metrics)
        kept = sorted(int(p.name) for p in (tmp_path / "port").iterdir())
        assert kept == sorted(int(p.name) for p in (tmp_path / "jax").iterdir()
                              if p.name.isdigit()), step
        assert (port.best_step, port.latest_step) == (jax_mgr.best_step,
                                                      jax_mgr.latest_step)
    reopened = CheckpointManager(tmp_path / "port")
    assert (reopened.best_step, reopened.latest_step) == (8, 8)
    assert reopened.restore()["step"] == 8
    assert reopened.metrics(8) == {"mAP": 0.3, "mAP50": 0.5}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


def test_unported_config_keys_raise_naming_their_item():
    """Tensor, spatial and expert parallelism (ROADMAP item 12b) are ported
    and pass, as do ZeRO, GPipe, multi-scale buckets and the general-gather
    augmentation, and the first three parts of item 12c: ZeRO with the
    model, spatial and expert axes, remat under tensor and spatial
    parallelism and DropBlock under spatial, depthwise convs under tensor
    parallelism, and tensor and spatial parallelism on the YOLOv7, YOLOv5
    and e-YOLOX families (part 1 of item 12c.4) and on MobileNetV3,
    ShuffleNetV2, CSPMobileNext and the extras (part 2). What is left of
    item 12c raises naming it: a pipe width with a model, spatial or
    expert width (12c.5), and tensor or spatial parallelism on the
    transformer backbones and `neck: none` (12c.4 part 3)."""
    yolox = {k: _model_cfg()[k] for k in ("backbone", "neck", "head")}
    for key in ("model", "spatial", "expert"):
        check_ported({**yolox, "parallel": {key: 2}}, {})
    check_ported(load_config(CONFIG_DIR / "model" / "yolox_s_tp2sp2.yaml"),
                 {})
    check_ported({"parallel": {"zero": True}}, {})
    check_ported({"parallel": {"zero": 3}}, {})
    check_ported({"parallel": {"pipeline": 2}}, {})
    check_ported({}, {"transform": {"multiscale_sizes": [[32, 32]]}})
    check_ported({}, {"transform": {"shear": 2.0, "degrees": 5.0,
                                    "perspective": 1e-4}})
    check_ported({"parallel": {"model": 1}}, {"transform": {}})
    vit = load_config(CONFIG_DIR / "model" / "vit_tiny_moe.yaml")
    depthwise = {**yolox, **{part: {**yolox[part], "depthwise": True}
                             for part in ("backbone", "neck", "head")}}
    dropblock = {**yolox, "backbone": {**yolox["backbone"], "drop_block": {
        "rate": 0.1, "size": 7}}}
    for cfg in ({**yolox, "parallel": {"model": 2, "zero": True}},
                {**yolox, "parallel": {"spatial": 2, "zero": 3}},
                {**vit, "parallel": {"expert": 2, "zero": True}},
                {**depthwise, "parallel": {"model": 2}},
                {**depthwise, "parallel": {"spatial": 2}},
                {**yolox, "remat": True, "parallel": {"model": 2}},
                {**yolox, "remat": True, "parallel": {"spatial": 2}},
                {**dropblock, "remat": True,
                 "parallel": {"model": 2, "spatial": 2}},
                {**dropblock, "parallel": {"spatial": 2, "zero": 3}}):
        check_ported(cfg, {})
    for cfg in ({**vit, "parallel": {"expert": 2, "pipeline": 2}},
                {**yolox, "parallel": {"model": 2, "pipeline": 2}},
                {**vit, "parallel": {"model": 2}},
                {**vit, "parallel": {"spatial": 2}},
                {**vit, "parallel": {"model": 2, "zero": True}}):
        with pytest.raises(NotImplementedError, match="item 12c"):
            check_ported(cfg, {})
    check_ported({**vit, "parallel": {"expert": 2}}, {})
    for name in ("yolov7", "yolov7_tiny", "yolov5_s", "e-yolox_s",
                 "al_yolov7_tiny"):
        cfg = load_config(CONFIG_DIR / "model" / f"{name}.yaml")
        for parallel in ({"model": 2, "spatial": 2}, {"model": 2, "zero": 3},
                         {"spatial": 2, "zero": True}):
            check_ported({**cfg, "parallel": parallel, "remat": True}, {})
        with pytest.raises(NotImplementedError, match="`pipeline`.*12c"):
            check_ported({**cfg, "parallel": {"spatial": 2,
                                               "pipeline": 2}}, {})
    for name in ("swin_tiny", "restv2_tiny", "mctformer_small"):
        cfg = load_config(CONFIG_DIR / "model" / f"{name}.yaml")
        with pytest.raises(NotImplementedError, match="item 12c.4 part 3"):
            check_ported({**cfg, "parallel": {"spatial": 2}}, {})
    for backbone in ("mobilenetv3s", "mobilenetv3l", "shufflenetv2",
                     "cspmobilenext", "efficientrep", "resnet", "convnext",
                     "ghostnet", "vgg", "mobilenext"):
        cfg = {**yolox, "backbone": {"name": backbone}}
        for parallel in ({"model": 2}, {"spatial": 2},
                         {"model": 2, "spatial": 2, "zero": 3}):
            check_ported({**cfg, "parallel": parallel}, {})
        with pytest.raises(NotImplementedError, match="`pipeline`.*12c.5"):
            check_ported({**cfg, "parallel": {"model": 2,
                                               "pipeline": 2}}, {})


def _cli_files(root, tmp_path):
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(_model_cfg()))
    (tmp_path / "data.yaml").write_text(yaml.safe_dump(_data_cfg(root)))
    return ["-c", str(tmp_path / "model.yaml"), "-d",
            str(tmp_path / "data.yaml"), "--max_epochs", "2", "--logger",
            "csv", "--output_dir", str(tmp_path / "runs")]


def test_cli_preempts_with_75_then_resumes_and_tests(coco_root, tmp_path,
                                                     capsys):
    args = _cli_files(coco_root, tmp_path)
    child = subprocess.Popen(
        [sys.executable, "-m", "pl_yolo_tpu_torch", *args, "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        lines = []
        for line in child.stdout:
            lines.append(line)
            if line.startswith("epoch 0:"):  # now in the second epoch
                child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=120) == 75, "".join(lines)
    finally:
        child.kill()
        child.stdout.close()
    ckpts = tmp_path / "runs/tiny/checkpoints"
    (preempted,) = [int(p.name) for p in ckpts.iterdir()]
    assert SPE < preempted < 2 * SPE
    assert json.loads((ckpts / str(preempted) / "metrics.json").read_text()
                      )["preempted"] == 1.0

    main([*args, "--device", "cpu", "--resume"])  # the epoch's other steps
    mgr = CheckpointManager(ckpts)
    assert mgr.latest_step == 2 * SPE
    assert torch.load(ckpts / str(2 * SPE) / "state.pt",
                      weights_only=True)["step"] == 2 * SPE
    capsys.readouterr()
    main([*args, "--device", "cpu", "--test", "--ckpt", str(ckpts)])
    assert "mAP = " in capsys.readouterr().out


def test_cli_refuses_to_run_without_a_card_unless_asked(coco_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(SystemExit, match="--device cpu"):
        main(_cli_files(coco_root, tmp_path))
    assert not (tmp_path / "runs").exists()
