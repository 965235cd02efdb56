"""Several processes training one model (`pl_yolo_tpu_torch/parallel/`):
data parallelism with global BatchNorm, losses and augmentation, ZeRO-1 and
ZeRO-3, GPipe over the ViT / MCTformer towers, and the trainer under
torchrun's layout, on the CPU over gloo, at the tiny widths of
`__graft_entry__.py:49-54`, 64 px.

Each world layout is spawned once for the module, as child processes of
this file (`python tests/test_torch_parallel.py <layout> <rank> <world>
<port> <out> <coco>`): two data ranks, two pipe ranks, and 2 data x 2
pipe ranks (a pipelined train step only). A child writes what
it computed to a file; rank 0 also computes the one-process references on
the global batch, outside any layout. The parametrised tests below assert
on those files, so each check counts on its own. While the ranks run,
this process trains the JAX package's ZeRO-1 step on two of the
conftest's virtual devices and the port's one-process trainer, and one
more child (`jax`) runs the JAX package's ZeRO-3 step and its GPipe of
the two towers.

Tolerances:
  * the float64 steps (YOLOX, augmented, plain DP, ZeRO-1 and ZeRO-3 with
    `accumulate_steps: 2` and `clip_grad_norm`): 1e-9 of each tensor's
    scale. Two ranks and one process compute the same function; only the
    order of the sums differs (the BatchNorm statistics and the loss's
    counts all-reduced, the gradients summed);
  * the YOLOv7, YOLOv5 and YOLOv3 losses: 2e-6 of the loss and of the
    largest gradient, in float64 maps. Their decodes compute in fp32
    whatever the maps' dtype, so the partial sums round as fp32 does;
    against the JAX package's losses of the global batch (fp32 maps
    there): 1e-5 of the loss and of the largest gradient, the bound of
    `tests/test_torch_anchor.py` (the worst seen is 1.8e-7);
  * the pipelined towers, in fp32: 1e-5 of each output's and gradient's
    scale (each microbatch's matmuls round on their own);
  * the pipelined towers against the JAX package's `pipeline_apply`, in
    fp32: 1e-4 of each output's and gradient's scale (two libraries'
    matmuls and reductions round apart; the worst seen is 9.4e-6, ViT's
    tower gradients);
  * against the JAX package's sharded steps (fp32, ZeRO-1 and ZeRO-3,
    accumulate 2): the bounds of the state tests, 5e-3 of each tensor's
    change at a base LR of 5e-4 (`tests/test_torch_train.py`, SLICE_TOL);
  * the trainer: the 2-rank fit's checkpoint against the one-process
    fit's, in fp32, to 5e-3 of each tensor's change; the mAP of one
    checkpoint validated by two ranks and by one process, exactly.

A tensor whose change is below 1e-3 of the largest change of its tree
(a bias with no gradient but rounding) is held to that floor instead.
"""

from __future__ import annotations

import copy
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# (the child processes run this file as a script: the repo root and the
# tests directory, which pytest's conftest puts on the path, by hand)
from pl_yolo_tpu_torch.data.augment import (  # noqa: E402
    AugmentConfig, make_augment_fn)
from pl_yolo_tpu_torch.models.detector import build_model  # noqa: E402
from pl_yolo_tpu_torch.models.losses import yolov3 as tv3  # noqa: E402
from pl_yolo_tpu_torch.models.losses import yolov5 as tv5  # noqa: E402
from pl_yolo_tpu_torch.models.losses import yolov7 as tv7  # noqa: E402
from pl_yolo_tpu_torch.parallel import (  # noqa: E402
    collectives, distributed, mesh)
from pl_yolo_tpu_torch.parallel.zero import DataParallel  # noqa: E402
from pl_yolo_tpu_torch.train.optim import build_optimizer  # noqa: E402
from pl_yolo_tpu_torch.train.state import (  # noqa: E402
    TrainState, make_train_step)
from pl_yolo_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, check_ported)
from pl_yolo_tpu_torch.utils.config import (  # noqa: E402
    CONFIG_DIR, load_config)

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

NUM_CLASSES, SIZE, BATCH = 3, 64, 4
F64_TOL, LOSS_TOL, PIPE_TOL, SLICE_TOL = 1e-9, 2e-6, 1e-5, 5e-3
JAX_PIPE_TOL, JAX_LOSS_TOL = 1e-4, 1e-5
STEPS, BASE_LR = 2, 5e-4     # two micro-steps: one update at accumulate 2
# the float64 runs: (ZeRO level, DropBlock in the backbone)
F64_RUNS = {"dp": (0, False), "zero1": (1, False), "zero3": (3, False),
            "dp_dropblock": (0, True)}


# ------------------------------------------------------------------ inputs

def _yolox_cfg(**optimizer):
    cfg = load_config(CONFIG_DIR / "model" / "yolox_s_zero.yaml")
    cfg["backbone"].update(channels=[8, 16, 32, 64, 128], depths=[1, 1, 1, 1])
    cfg["neck"]["channels"] = cfg["head"]["channels"] = [32, 64, 128]
    cfg["dtype"] = None
    cfg["optimizer"].update(learning_rate=BASE_LR, **optimizer)
    return cfg


def _vit_cfg(name="vision_transformer"):
    backbone = {"name": name, "embed_dim": 32, "depth": 4, "num_heads": 2,
                "patch_size": 16}
    if name == "mctformer":
        backbone["num_cls_tokens"] = NUM_CLASSES
    return {"backbone": backbone,
            "neck": {"name": "csppafpn", "depths": [1, 1, 1, 1],
                     "channels": [16, 16, 32]},
            "head": {"name": "decoupled_head", "channels": [16, 16, 32]},
            "loss": {"name": "yolox", "stride": [8, 16, 32]},
            "optimizer": {"name": "SGD", "learning_rate": 0.02,
                          "momentum": 0.9, "weight_decay": 0.0005,
                          "warmup": 0.05}}


def _batch(seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3)).astype(dtype)
    labels = np.zeros((BATCH, 6, 5), np.float32)
    labels[:, :3, 0] = rng.integers(0, NUM_CLASSES, (BATCH, 3))
    labels[:, :3, 1:3] = rng.uniform(12, 52, (BATCH, 3, 2))
    labels[:, :3, 3:] = rng.uniform(8, 40, (BATCH, 3, 2))
    return torch.from_numpy(images), torch.from_numpy(labels)


def _anchor_maps(seed, strides):
    rng = np.random.default_rng(seed)
    maps = [rng.normal(0.0, 1.0, (BATCH, SIZE // s, SIZE // s,
                                  3 * (5 + NUM_CLASSES)))
            for s in strides]
    labels = np.zeros((BATCH, 5, 5), np.float32)
    for b in range(BATCH - 1):  # the last image has no label
        labels[b, :3, 0] = rng.integers(0, NUM_CLASSES, 3)
        labels[b, :3, 1:3] = rng.uniform(8, 56, (3, 2))
        labels[b, :3, 3:] = rng.uniform(6, 40, (3, 2))
    return maps, torch.from_numpy(labels)


ANCHOR_LOSSES = {
    "yolov7": ((8, 16, 32), lambda o, lab: tv7.yolov7_loss(o, lab,
                                                           NUM_CLASSES)),
    "yolov5": ((8, 16, 32), lambda o, lab: tv5.yolov5_loss(o, lab,
                                                           NUM_CLASSES)),
    "yolov3": ((32, 16, 8), lambda o, lab: tv3.yolov3_loss(
        o, lab, NUM_CLASSES, img_size=(SIZE, SIZE))),
}


# -------------------------------------------------------------- the runs

def _yolox_run(level, layout, rows, dtype=torch.float64, augment=True,
               steps=STEPS, seed=0, drop_block=False):
    """`steps` micro-steps of the tiny YOLOX (accumulate 2, clip 35; with
    `drop_block`, yolox_s_dropblock.yaml's DropBlock) on rows `rows` of the
    global batch; the state gathered as one process keeps it."""
    cfg = _yolox_cfg(accumulate_steps=2, clip_grad_norm=35.0)
    if drop_block:
        cfg["backbone"]["drop_block"] = load_config(
            CONFIG_DIR / "model" / "yolox_s_dropblock.yaml")["backbone"][
                "drop_block"]
    model = build_model(cfg, NUM_CLASSES, device="cpu",
                        input_size=(SIZE, SIZE))
    model.module.to(dtype)
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    engine = (DataParallel(model.module, layout, zero=level)
              if layout is not None else None)
    optimizer, _ = build_optimizer(
        model.module, cfg["optimizer"], 10,
        **(engine.optimizer_views() if engine is not None else {}))
    state = TrainState.create(model.module, optimizer, parallel=engine)
    step = make_train_step(
        model.loss.train_loss,
        augment_fn=(make_augment_fn(AugmentConfig(
            max_labels=20, pixel_dtype="float32")) if augment else None),
        apply_fn=lambda m, x: m(x.to(dtype)))
    generator = torch.Generator().manual_seed(1)
    images, labels = _batch(seed)
    if not augment:
        images = images.float()
    losses = [{k: float(v) for k, v in step(
        state, images[rows], labels[rows], generator=generator).items()}
        for _ in range(steps)]
    if engine is not None and level:
        out = {"params": engine.module_state_dict(),
               "ema": engine.ema_state_dict(),
               "optimizer": engine.optimizer_state_dict(),
               "bytes": engine.state_bytes()}
    else:
        out = {"params": state.module.state_dict(),
               "ema": state.eval_module.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    out["opt_state"] = {f"{i}/{k}": v for i, st in out.pop(
        "optimizer")["state"].items() for k, v in st.items()
        if isinstance(v, torch.Tensor) and v.ndim}
    out.update(losses=losses, init=init)
    return _detach(out)


def _anchor_run(name, rows):
    strides, loss_fn = ANCHOR_LOSSES[name]
    maps, labels = _anchor_maps(7, strides)
    outs = [torch.from_numpy(m[rows]).requires_grad_() for m in maps]
    losses = loss_fn(outs, labels[rows])
    losses["loss"].backward()
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": [o.grad for o in outs]}


def _tower_run(name, rows):
    """The tiny backbone's train-mode maps and the gradients of a fixed
    function of them, w.r.t. the images and the tower's parameters."""
    model = build_model(_vit_cfg(name), NUM_CLASSES, device="cpu",
                        input_size=(SIZE, SIZE))
    backbone = model.module.backbone.train()
    images = _batch(2, np.float32)[0].permute(0, 3, 1, 2)[rows]
    images = (images / 255.0).requires_grad_()
    maps = backbone(images)
    sum(((m - 0.1) ** 2).mean() * (i + 1)
        for i, m in enumerate(maps)).backward()
    grads = {k: p.grad for k, p in backbone.named_parameters()
             if k.startswith("blocks_") and p.grad is not None}
    return _detach({"maps": [m.detach() for m in maps],
                    "input_grad": images.grad, "tower_grads": grads})


def _pipe_step_run(layout, rows):
    """Two train steps of the tiny ViT detector (GPipe under `layout`)."""
    model = build_model(_vit_cfg(), NUM_CLASSES, device="cpu",
                        input_size=(SIZE, SIZE))
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    engine = (DataParallel(model.module, layout)
              if layout is not None else None)
    optimizer, _ = build_optimizer(model.module, _vit_cfg()["optimizer"], 10)
    state = TrainState.create(model.module, optimizer, parallel=engine)
    step = make_train_step(model.loss.train_loss)
    images, labels = _batch(3, np.float32)
    losses = [{k: float(v) for k, v in step(state, images[rows],
                                            labels[rows]).items()}
              for _ in range(STEPS)]
    return _detach({"losses": losses, "params": state.module.state_dict(),
                    "init": init})


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detach(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


# ----------------------------------------------------------- the trainer

def _trainer_cfgs(root, out_dir, zero=True):
    model_cfg = _yolox_cfg()
    model_cfg["optimizer"]["learning_rate"] = BASE_LR
    model_cfg.update(name="tiny", schedule={"no_aug_epochs": 1})
    if not zero:
        model_cfg.pop("parallel")
    data_cfg = load_config(CONFIG_DIR / "data" / "coco2017.yaml")
    data_cfg["dataset"].update(
        dir=str(root), train="images", val="images", test="images",
        train_json="annotations/instances.json",
        val_json="annotations/instances.json",
        test_json="annotations/instances.json", train_size=[SIZE, SIZE],
        val_size=[SIZE, SIZE], train_batch_size=BATCH, val_batch_size=2)
    data_cfg["num_classes"] = NUM_CLASSES
    data_cfg["classes"] = [f"class{i}" for i in range(NUM_CLASSES)]
    return model_cfg, data_cfg, dict(max_epochs=2, logger="csv",
                                     output_dir=str(out_dir), device="cpu",
                                     log_every_n_steps=1)


def _fit(root, out_dir, zero=True):
    """Trainer.fit for 2 epochs of 2 steps (the 2nd without mosaic), its
    validation, then the checkpoint validated again at conf 0 (so that the
    random-ish model's detections count) on every rank."""
    model_cfg, data_cfg, kw = _trainer_cfgs(root, out_dir, zero)
    trainer = Trainer(model_cfg, data_cfg, **kw)
    trainer.fit()
    ap = trainer.validate(conf=0.0)
    return {"fit_mAP": trainer.best_map, "mAP": ap,
            "detections": trainer.detections,
            "ckpt": str(Path(out_dir) / "tiny" / "checkpoints")}


def _validate_checkpoint(root, out_dir, ckpt):
    model_cfg, data_cfg, kw = _trainer_cfgs(root, out_dir)
    trainer = Trainer(model_cfg, data_cfg, **kw)
    trainer.load_weights(ckpt)
    return {"mAP": trainer.validate(conf=0.0),
            "detections": trainer.detections}


# ------------------------------------------------------------ the children

def _child(layout_name: str, rank: int, world: int, port: int, out: str,
           coco: str) -> None:
    torch.set_num_threads(1)
    if layout_name == "jax":
        # the JAX references of the ZeRO-3 step and the pipelined towers,
        # beside the ranks (the conftest's JAX settings, 8 virtual devices)
        import conftest  # noqa: F401
        init = _yolox_run(0, None, slice(0, BATCH), dtype=torch.float32,
                          augment=False, steps=0)["init"]
        torch.save({"zero3": _jax_zero_accumulate(init, 3),
                    "towers": {name: _jax_pipelined_tower(name) for name in
                               ("vision_transformer", "mctformer")},
                    "anchor": _jax_anchor_losses()}, out)
        return
    distributed.initialize(device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                           rank=rank, world_size=world, local_world_size=world)
    res = {}
    if layout_name == "data":
        layout = mesh.Layout(world, 1)
        per = BATCH // world
        rows = slice(rank * per, (rank + 1) * per)
        for name, (level, drop_block) in F64_RUNS.items():
            res[f"f64/{name}"] = _yolox_run(level, layout, rows,
                                            drop_block=drop_block)
        for level in (1, 3):
            res[f"f32_zero{level}"] = _yolox_run(
                level, layout, rows, dtype=torch.float32, augment=False)
        flag = distributed.StopFlag()
        res["stop_votes"] = [flag.vote(rank == 1 and i == 2)
                             for i in range(5)]
        flag.settle()
        with mesh.use_layout(layout):
            for name in ANCHOR_LOSSES:
                res[f"anchor/{name}"] = _anchor_run(name, rows)
        res["fit"] = _fit(coco, Path(out).parent / "runs2")
        res["staged"] = dict(collectives.STAGED)
        if rank == 0:
            for drop_block in (False, True):
                res[f"ref/f64/{drop_block}"] = _yolox_run(
                    0, None, slice(0, BATCH), drop_block=drop_block)
            for name in ANCHOR_LOSSES:
                res[f"ref/anchor/{name}"] = _anchor_run(name,
                                                        slice(0, BATCH))
    elif layout_name == "data_pipe":
        # 2 data x 2 pipe: each pipe group GPipes its data rows
        layout = mesh.Layout(2, 2)
        per = BATCH // layout.data
        res["pipe_step"] = _pipe_step_run(layout, slice(
            layout.data_index * per, (layout.data_index + 1) * per))
    else:
        layout = mesh.Layout(1, world)
        with mesh.use_layout(layout):
            for name in ("vision_transformer", "mctformer"):
                res[f"tower/{name}"] = _tower_run(name, slice(0, BATCH))
        res["pipe_step"] = _pipe_step_run(layout, slice(0, BATCH))
        if rank == 0:
            for name in ("vision_transformer", "mctformer"):
                res[f"ref/tower/{name}"] = _tower_run(name, slice(0, BATCH))
            res["ref/pipe_step"] = _pipe_step_run(None, slice(0, BATCH))
    torch.save(res, out)
    distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(layout_name: str, world: int, tmp: Path, coco: Path) -> list:
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        out = tmp / f"{layout_name}_{rank}.pt"
        procs.append((subprocess.Popen(
            [sys.executable, __file__, layout_name, str(rank), str(world),
             str(port), str(out), str(coco)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out))
    return procs


def _collect(procs, timeout=240) -> list[dict]:
    results = []
    for proc, out in procs:
        log, _ = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, log[-4000:]
        results.append(torch.load(out, weights_only=False))
    return results


# ------------------------------------------------------- the JAX reference

def _jax_zero_accumulate(init_sd, level):
    """The JAX package's sharded step on 2 of the conftest's virtual
    devices: `make_mesh(data=2)`, ZeRO at `level` (`shard_tp(zero=level)`
    and `zero_constraint`), `accumulate_steps: 2`, 2 micro-steps on the
    un-augmented batch (as `tests/test_parallel_zero.py:123-200`), from the
    port's initial state."""
    import jax
    import jax.numpy as jnp
    from pl_yolo_tpu.layers import blocks as jb
    from pl_yolo_tpu.models.detector import build_model as jax_build_model
    from pl_yolo_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                           shard_tp, zero_constraint)
    from pl_yolo_tpu.train.optim import build_optimizer as jax_optimizer
    from pl_yolo_tpu.train.state import TrainState as JState
    from pl_yolo_tpu.train.state import make_train_step as jax_step
    from pl_yolo_tpu_torch import bridge

    prev = jb.get_compute_dtype()
    jb.set_compute_dtype(None)
    try:
        cfg = _yolox_cfg(accumulate_steps=2, clip_grad_norm=35.0)
        model = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
        variables = bridge.state_dict_to_variables(
            {k: v.float() for k, v in init_sd.items()})
        mesh_ = make_mesh(data=2, devices=jax.devices()[:2])
        tx, _ = jax_optimizer(cfg["optimizer"], total_steps=10)
        state = shard_tp(JState.create(variables, tx), mesh_, zero=level)
        step = jax_step(model.module.apply, model.loss.train_loss,
                        donate=False,
                        constrain_state=zero_constraint(state, mesh_,
                                                        zero=level))
        images, labels = _batch(0)
        imgs = jax.device_put(jnp.asarray(images.numpy(), jnp.float32),
                              batch_sharding(mesh_))
        labs = jax.device_put(jnp.asarray(labels.numpy()),
                              batch_sharding(mesh_))
        losses = []
        with mesh_:
            for i in range(STEPS):
                state, out = step(state, imgs, labs, jax.random.key(i))
                losses.append({k: float(v) for k, v in out.items()})
        return {"losses": losses,
                "params": dict(bridge._flatten(jax.device_get(
                    {"params": state.params,
                     "batch_stats": state.batch_stats}))),
                "ema": dict(bridge._flatten(jax.device_get(
                    {"params": state.ema_params,
                     "batch_stats": state.ema_batch_stats})))}
    finally:
        jb.set_compute_dtype(prev)


def _jax_pipelined_tower(name):
    """The JAX package's GPipe (`pipeline_apply`, under `use_pipeline_mesh`
    of `make_mesh(pipe=2)` on 2 of the conftest's virtual devices, as
    `tests/test_pipeline_vit.py` runs it) on the tiny backbone from the
    port's initial weights: its train-mode maps and the gradients of
    `_tower_run`'s function of them w.r.t. the images and the tower, in
    the port's layout."""
    import jax
    import jax.numpy as jnp
    from pl_yolo_tpu.models.detector import build_model as jax_build_model
    from pl_yolo_tpu.parallel.mesh import make_mesh, use_pipeline_mesh
    from pl_yolo_tpu_torch import bridge

    port = build_model(_vit_cfg(name), NUM_CLASSES, device="cpu",
                       input_size=(SIZE, SIZE)).module.backbone
    variables = bridge.state_dict_to_variables(port.state_dict(), port)
    jmod = jax_build_model(_vit_cfg(name), NUM_CLASSES).module.backbone
    images = jnp.asarray(_batch(2, np.float32)[0].numpy() / 255.0)

    def loss(params, x):
        maps = jmod.apply({**variables, "params": params}, x, True)
        return sum(((m - 0.1) ** 2).mean() * (i + 1)
                   for i, m in enumerate(maps)), maps
    with use_pipeline_mesh(make_mesh(pipe=2, devices=jax.devices()[:2])):
        (_, maps), (grads, input_grad) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(variables["params"], images)
    convt = bridge._conv_transposes(port)
    tower = {}
    for path, g in bridge._flatten({"params": grads}).items():
        key, g = bridge._to_torch_key(path, g, convt)
        if key.startswith("blocks_"):
            tower[key] = torch.from_numpy(np.array(g))

    def nchw(a):
        return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)
    return {"maps": [nchw(m) for m in maps], "input_grad": nchw(input_grad),
            "tower_grads": tower}


def _jax_anchor_losses():
    """The JAX package's YOLOv7, YOLOv5 and YOLOv3 losses (each computed on
    the global batch, as the JAX step does under GSPMD) and their map
    gradients, on `_anchor_maps`' maps in fp32."""
    import jax
    import jax.numpy as jnp
    from pl_yolo_tpu.models.losses import yolov3 as jv3
    from pl_yolo_tpu.models.losses import yolov5 as jv5
    from pl_yolo_tpu.models.losses import yolov7 as jv7
    fns = {"yolov7": lambda o, lab: jv7.yolov7_loss(o, lab, NUM_CLASSES),
           "yolov5": lambda o, lab: jv5.yolov5_loss(o, lab, NUM_CLASSES),
           "yolov3": lambda o, lab: jv3.yolov3_loss(
               o, lab, NUM_CLASSES, img_size=(SIZE, SIZE))}
    out = {}
    for name, (strides, _) in ANCHOR_LOSSES.items():
        maps, labels = _anchor_maps(7, strides)

        def loss(outs, lab, fn=fns[name]):
            losses = fn(outs, lab)
            return losses["loss"], losses
        (_, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            [jnp.asarray(m, jnp.float32) for m in maps],
            jnp.asarray(labels.numpy()))
        out[name] = {"losses": {k: float(v) for k, v in losses.items()},
                     "grads": [torch.from_numpy(np.array(g)) for g in grads]}
    return out


# ----------------------------------------------------------------- fixture

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from synthetic_coco import make_coco
    tmp = tmp_path_factory.mktemp("parallel")
    coco = make_coco(tmp / "coco", num_images=8, num_classes=NUM_CLASSES)
    t0 = time.perf_counter()
    data = _spawn("data", 2, tmp, coco)
    pipe = _spawn("pipe", 2, tmp, coco)
    data_pipe = _spawn("data_pipe", 4, tmp, coco)
    jax_child = _spawn("jax", 1, tmp, coco)
    one = _fit(coco, tmp / "runs1", zero=False)
    f32_ref = _yolox_run(0, None, slice(0, BATCH), dtype=torch.float32,
                         augment=False)
    jax_ref = {1: _jax_zero_accumulate(f32_ref["init"], 1)}
    jax_res = _collect(jax_child)[0]
    jax_ref[3] = jax_res["zero3"]
    data_res, pipe_res = _collect(data), _collect(pipe)
    data_pipe_res = _collect(data_pipe)
    # the 2-rank fit's checkpoint, validated by one process
    one["val1_of_2"] = _validate_checkpoint(coco, tmp / "runs1v",
                                            data_res[0]["fit"]["ckpt"])
    return {"one": one, "f32_ref": f32_ref, "jax": jax_ref,
            "jax_towers": jax_res["towers"],
            "jax_anchor": jax_res["anchor"],
            "data": data_res, "pipe": pipe_res, "data_pipe": data_pipe_res,
            "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------- helpers

def _scale(t):
    return float(t.double().abs().max()) if t.numel() else 0.0


def _assert_changes_close(got: dict, want: dict, init: dict, tol: float,
                          what: str):
    """Each tensor's |got - want| <= tol x its change since `init` (at
    least 1e-3 of the tree's largest change), plus 2 ulps of its value."""
    changes = {k: _scale(want[k].double() - init[k].double()) for k in want
               if want[k].is_floating_point()}
    floor = 1e-3 * max(changes.values())
    for k, change in changes.items():
        err = _scale(got[k].double() - want[k].double())
        ulps = 2 * torch.finfo(want[k].dtype).eps * _scale(want[k])
        assert err <= tol * max(change, floor) + ulps, (
            f"{what}: {k} differs by {err:.3e}, change {change:.3e}")


def _assert_close(got: dict, want: dict, tol: float, what: str):
    """Each tensor's |got - want| <= tol x its scale (at least 1e-3 of the
    tree's largest scale)."""
    scales = {k: _scale(v) for k, v in want.items() if v.is_floating_point()}
    floor = 1e-3 * max(scales.values())
    for k, scale in scales.items():
        err = _scale(got[k].double() - want[k].double())
        assert err <= tol * max(scale, floor), (
            f"{what}: {k} differs by {err:.3e}, scale {scale:.3e}")


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("run", sorted(F64_RUNS))
@pytest.mark.parametrize("part", ["params", "ema", "opt_state", "losses"])
def test_two_rank_float64_step_equals_one_process(runs, run, part):
    """The augmented YOLOX step, 2 micro-steps (one update) with
    `accumulate_steps: 2` and `clip_grad_norm: 35`, plain DP, ZeRO-1,
    ZeRO-3, and plain DP with DropBlock (its masks drawn for the global
    batch): every rank's gathered state and the global losses equal one
    process's on the global batch."""
    level, drop_block = F64_RUNS[run]
    ref = runs["data"][0][f"ref/f64/{drop_block}"]
    for rank in (0, 1):
        got = runs["data"][rank][f"f64/{run}"]
        if part == "losses":
            for g, w in zip(got["losses"], ref["losses"]):
                assert set(g) == set(w)
                for k in w:
                    assert abs(g[k] - w[k]) <= F64_TOL * max(abs(w[k]), 1.0), k
        else:
            _assert_close(got[part], ref[part], F64_TOL,
                          f"rank {rank} {run} {part}")
    assert ref["losses"][0]["proportion"] > 0


@pytest.mark.parametrize("level", [1, 3], ids=["zero1", "zero3"])
def test_zero_shards_hold_half_the_state(runs, level):
    """Each rank's moments and EMA (and params at level 3) are at most half
    one process's, plus the tensors no data width divides."""
    for rank in (0, 1):
        b = runs["data"][rank][f"f64/zero{level}"]["bytes"]
        parts = ("opt_state", "ema") + (("params",) if level == 3 else ())
        for part in parts:
            assert b[part] < 0.55 * b[f"{part}_one_process"], (part, b)
        if level == 1:
            assert b["params"] == b["params_one_process"]


@pytest.mark.parametrize("name", sorted(ANCHOR_LOSSES))
def test_two_rank_anchor_losses_equal_one_process(runs, name):
    """YOLOv7's level means and counts, YOLOv5's `* B` and YOLOv3's batch
    means: the ranks' losses sum to the global batch's, and each rank's
    map gradients are its rows of the global batch's."""
    ref = runs["data"][0][f"ref/anchor/{name}"]
    got = [runs["data"][r][f"anchor/{name}"] for r in (0, 1)]
    for k, want in ref["losses"].items():
        total = sum(g["losses"][k] for g in got)
        assert abs(total - want) <= LOSS_TOL * max(abs(want), 1.0), k
    assert ref["losses"]["loss"] > 0
    per = BATCH // 2
    for level, want in enumerate(ref["grads"]):
        scale = max(_scale(g) for g in ref["grads"])
        for r in (0, 1):
            err = _scale(got[r]["grads"][level]
                         - want[r * per:(r + 1) * per])
            assert err <= LOSS_TOL * scale, (name, level, r, err)


def _assert_matches_jax(got: dict, jax_ref: dict, part: str):
    """A 2-rank fp32 run's losses, or its params, BN statistics or EMA,
    against the JAX package's sharded step (`_jax_zero_accumulate`)."""
    from pl_yolo_tpu_torch import bridge
    if part == "losses":
        for g, w in zip(got["losses"], jax_ref["losses"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-3, atol=1e-5,
                                           err_msg=k)
        return
    init = dict(bridge._flatten(bridge.state_dict_to_variables(
        {k: v.float() for k, v in got["init"].items()})))
    tree = got["ema"] if part == "ema" else got["params"]
    flat = dict(bridge._flatten(bridge.state_dict_to_variables(
        {k: v.float() for k, v in tree.items()})))
    want = jax_ref["ema"] if part == "ema" else jax_ref["params"]
    collection = "batch_stats" if part == "batch_stats" else None
    keys = [k for k in want if collection is None or k[0] == collection]
    _assert_changes_close({k: torch.from_numpy(np.asarray(flat[k]))
                           for k in keys},
                          {k: torch.from_numpy(np.asarray(want[k]))
                           for k in keys},
                          {k: torch.from_numpy(np.asarray(init[k]))
                           for k in keys}, SLICE_TOL, part)


@pytest.mark.parametrize("name", sorted(ANCHOR_LOSSES))
def test_two_rank_anchor_losses_match_jax(runs, name):
    """The ranks' losses sum to the JAX package's loss of the global batch,
    and each rank's map gradients are its rows of JAX's, in fp32."""
    want = runs["jax_anchor"][name]
    got = [runs["data"][r][f"anchor/{name}"] for r in (0, 1)]
    assert set(got[0]["losses"]) == set(want["losses"])
    for k, w in want["losses"].items():
        total = sum(g["losses"][k] for g in got)
        assert abs(total - w) <= JAX_LOSS_TOL * max(abs(w), 1.0), (k, total,
                                                                   w)
    per = BATCH // 2
    scale = max(_scale(g) for g in want["grads"])
    for level, w in enumerate(want["grads"]):
        for r in (0, 1):
            err = _scale(got[r]["grads"][level].double()
                         - w[r * per:(r + 1) * per].double())
            assert err <= JAX_LOSS_TOL * scale, (name, level, r, err)


@pytest.mark.parametrize("part", ["params", "batch_stats", "ema", "losses"])
def test_two_rank_zero_accumulate_step_matches_the_jax_sharded_step(runs,
                                                                      part):
    """fp32, ZeRO-1 and `accumulate_steps: 2`, un-augmented: the port's two
    ranks against the JAX package's step sharded over two devices."""
    _assert_matches_jax(runs["data"][0]["f32_zero1"], runs["jax"][1], part)


@pytest.mark.parametrize("part", ["params", "batch_stats", "ema", "losses"])
def test_two_rank_zero3_accumulate_step_matches_the_jax_sharded_step(runs,
                                                                       part):
    """fp32, ZeRO-3 (params sharded at rest) and `accumulate_steps: 2`,
    un-augmented: the port's two ranks against the JAX package's step with
    `shard_tp(zero=3)` over two devices."""
    _assert_matches_jax(runs["data"][0]["f32_zero3"], runs["jax"][3], part)


def test_two_rank_fp32_zero_step_matches_one_process(runs):
    """The fp32 ZeRO-1 run the JAX check uses, against one process."""
    got, ref = runs["data"][0]["f32_zero1"], runs["f32_ref"]
    _assert_changes_close(got["params"], ref["params"], ref["init"],
                          SLICE_TOL, "params")


@pytest.mark.parametrize("name", ["vision_transformer", "mctformer"])
@pytest.mark.parametrize("part", ["maps", "input_grad", "tower_grads"])
def test_pipelined_tower_equals_the_sequential_one(runs, name, part):
    """GPipe over 2 pipe ranks (2 microbatches): the maps on both ranks,
    the images' gradient, and the tower's gradients summed over the pipe
    group, against the sequential tower. Both ranks back-propagate the
    same function of the maps, and the broadcast's backward sums their
    gradients (as `psum`'s transpose does): the pipelined gradients are S
    = 2 times the sequential ones, which the train step divides out
    (`parallel.zero.DataParallel.reduce_grads`)."""
    ref = runs["pipe"][0][f"ref/tower/{name}"][part]
    got = [runs["pipe"][r][f"tower/{name}"][part] for r in (0, 1)]
    if part == "maps":
        for g in got:
            for a, b in zip(g, ref):
                assert _scale(a - b) <= PIPE_TOL * _scale(b)
    elif part == "input_grad":
        # stage 0 takes the images; the other stage's copy takes no gradient
        assert _scale(got[0] / 2 - ref) <= PIPE_TOL * _scale(ref)
        assert _scale(got[1]) == 0.0
    else:
        summed = {k: (got[0][k] + got[1][k]) / 2 for k in ref}
        _assert_close(summed, ref, PIPE_TOL, f"{name} tower grads")
        # each stage's blocks take gradients on its own rank only
        half = next(iter(ref.values())).shape[0] // 2
        for k in ref:
            assert _scale(got[0][k][half:]) == 0.0
            assert _scale(got[1][k][:half]) == 0.0


@pytest.mark.parametrize("name", ["vision_transformer", "mctformer"])
@pytest.mark.parametrize("part", ["maps", "input_grad", "tower_grads"])
def test_pipelined_tower_matches_the_jax_pipeline(runs, name, part):
    """The port's GPipe over 2 pipe ranks against the JAX package's
    `pipeline_apply` over 2 devices, from the same weights: the maps on
    both ranks, and the images' and the tower's gradients (the port's
    summed over the pipe group and divided by S = 2, as the train step
    does; the JAX ones are the sequential tower's)."""
    want = runs["jax_towers"][name][part]
    got = [runs["pipe"][r][f"tower/{name}"][part] for r in (0, 1)]
    if part == "maps":
        for g in got:
            for a, b in zip(g, want):
                assert _scale(a - b) <= JAX_PIPE_TOL * _scale(b)
    elif part == "input_grad":
        assert _scale(got[0] / 2 - want) <= JAX_PIPE_TOL * _scale(want)
    else:
        assert set(got[0]) == set(want)
        _assert_close({k: (got[0][k] + got[1][k]) / 2 for k in want}, want,
                      JAX_PIPE_TOL, f"{name} tower grads against JAX")


@pytest.mark.parametrize("layout", ["pipe", "data_pipe"],
                         ids=["2pipe", "2data_x_2pipe"])
def test_pipelined_train_step_equals_one_process(runs, layout):
    """Two train steps of the tiny ViT detector with its tower pipelined
    over 2 ranks, alone or in each of 2 data groups (the neck and head
    redundant on a pipe group's ranks, BatchNorm global over the data
    group, the gradients summed over the world and divided by the pipe
    width)."""
    ref = runs["pipe"][0]["ref/pipe_step"]
    for r, res in enumerate(runs[layout]):
        got = res["pipe_step"]
        for g, w in zip(got["losses"], ref["losses"]):
            for k in w:
                assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), k
        _assert_changes_close(got["params"], ref["params"], ref["init"],
                              SLICE_TOL, f"rank {r} params")


def test_two_rank_trainer_checkpoint_matches_one_process(runs):
    """`Trainer.fit` under a 2-rank layout (ZeRO-1, accumulate 2, clip)
    writes, from rank 0, the checkpoint a one-process fit writes."""
    two = torch.load(Path(runs["data"][0]["fit"]["ckpt"]) / "4" / "state.pt",
                     weights_only=True)
    one = torch.load(Path(runs["one"]["ckpt"]) / "4" / "state.pt",
                     weights_only=True)
    assert two["step"] == one["step"] == 4
    init = _yolox_run(0, None, slice(0, 1), dtype=torch.float32,
                      augment=False, steps=0)["init"]
    for part in ("module", "ema_module"):
        _assert_changes_close(two[part], one[part], init, SLICE_TOL, part)
    assert set(two["optimizer"]["state"]) == set(one["optimizer"]["state"])


def test_two_rank_validation_gives_the_one_process_map(runs):
    """The 2-rank fit's state, validated by its two ranks (each its share
    of the images, the detections gathered in the one-process order, rank
    0's mAP broadcast), and its checkpoint, validated by one process: the
    same detections in the same order and the same mAP, on both ranks.
    (At conf 0: the tiny model's hundreds of detections an image.)"""
    def same(got, want):
        assert got["mAP"] == want["mAP"]
        assert len(got["detections"]) == len(want["detections"]) > 100
        for g, w in zip(got["detections"], want["detections"]):
            assert (g["image_id"], g["category_id"]) == (w["image_id"],
                                                         w["category_id"])
            np.testing.assert_allclose(g["bbox"] + [g["score"]],
                                       w["bbox"] + [w["score"]],
                                       rtol=1e-5, atol=1e-5)
    for r in (0, 1):
        same(runs["data"][r]["fit"], runs["data"][0]["fit"])
    same(runs["one"]["val1_of_2"], runs["data"][0]["fit"])


def test_stop_flag_stops_every_rank_at_one_step(runs):
    """`StopFlag`: rank 1 raises its flag at step 2 only; both ranks stop
    at step 3, the step after, and at no other."""
    want = [False, False, False, True, False]
    assert [runs["data"][r]["stop_votes"] for r in (0, 1)] == [want, want]


@pytest.mark.parametrize("host_augment", [False, True],
                         ids=["decode", "copypaste"])
def test_row_loaders_take_the_one_process_batches(tmp_path, host_augment):
    """Two data ranks' `RowLoader`s, each with the host augmentation it
    builds from the seed, take the rows of the batches one process takes:
    without host augmentation each decodes its rows only; with copy-paste
    and cutout, whose draws are one sequential stream over the host batch,
    as in one process."""
    from synthetic_coco import make_coco

    from pl_yolo_tpu_torch.data.aug_extra import make_host_augment
    from pl_yolo_tpu_torch.data.datamodule import RowLoader
    from pl_yolo_tpu_torch.data.datasets import COCODataset
    from pl_yolo_tpu_torch.data.loader import TrainLoader
    root = make_coco(tmp_path / "coco", num_images=6, num_classes=NUM_CLASSES)
    dataset = COCODataset(str(root), "annotations/instances.json", "images",
                          img_size=(SIZE, SIZE), max_labels=10)
    transform = ({"copypaste_prob": 1.0, "cutoutR_prob": 0.5}
                 if host_augment else {})

    def loader(rows=None, transform=transform):
        kw = dict(seed=7, host_augment=make_host_augment(
            transform, dataset, NUM_CLASSES, seed=7))
        return (TrainLoader(dataset, BATCH, **kw) if rows is None
                else RowLoader(dataset, BATCH, rows, **kw))
    half = BATCH // 2
    one, plain = loader(), loader(transform={})
    ranks = [loader(slice(0, half)), loader(slice(half, BATCH))]
    try:
        for _ in range(3):  # spans an epoch boundary (6 images, bs 4)
            want, got = next(one), [next(r) for r in ranks]
            for k in want:
                np.testing.assert_array_equal(
                    np.concatenate([g[k] for g in got]), want[k], err_msg=k)
            assert len(got[0]["images"]) == half
            changed = not np.array_equal(want["images"],
                                         next(plain)["images"])
            assert changed == host_augment
    finally:
        for it in (one, plain, *ranks):
            it.close()


def test_gloo_stages_no_cpu_tensor(runs):
    """On the CPU nothing goes through the staging path (it is for CUDA
    tensors on gloo); reduce-scatter is gloo's all-reduce and a slice."""
    staged = runs["data"][0]["staged"]
    assert set(staged) <= {"reduce_scatter (all_reduce)"}
    assert staged.get("reduce_scatter (all_reduce)", 0) > 0


@pytest.mark.parametrize("name", ["yolox_s_zero", "vit_tiny_pp2"])
def test_parallel_configs_are_taken_and_build_narrow(name):
    """The two YAMLs pass `check_ported` and build at narrow widths; their
    `parallel:` keys are the JAX package's (vit_tiny_pp2 runs M = S = 2
    microbatches, whatever its comment says)."""
    cfg = load_config(CONFIG_DIR / "model" / f"{name}.yaml")
    check_ported(cfg, {})
    assert cfg["parallel"] == ({"zero": True} if name == "yolox_s_zero"
                               else {"pipeline": 2})
    if name == "vit_tiny_pp2":
        cfg["backbone"].update(embed_dim=32, depth=4, num_heads=2)
    else:
        cfg["backbone"].update(channels=[8, 16, 32, 64, 128],
                               depths=[1, 1, 1, 1])
    cfg["neck"]["channels"] = cfg["head"]["channels"] = [16, 32, 64]
    cfg["neck"]["depths"] = [1, 1, 1, 1]
    model = build_model(cfg, NUM_CLASSES, device="cpu",
                        input_size=(SIZE, SIZE))
    with torch.no_grad():
        outs = model.module(torch.zeros(1, SIZE, SIZE, 3))
    assert [o.shape[1] for o in outs] == [8, 4, 2]


def test_trainer_refuses_what_the_layout_cannot_take(tmp_path):
    """The JAX trainer's messages: a pipeline over a backbone without a
    uniform tower, and a ViT depth the stages do not divide."""
    from synthetic_coco import make_coco
    model_cfg, data_cfg, kw = _trainer_cfgs(
        make_coco(tmp_path / "coco", num_images=2), tmp_path / "runs")
    model_cfg["parallel"] = {"pipeline": 1}
    Trainer(model_cfg, data_cfg, **kw)   # a pipeline of 1: no layout
    layout = mesh.Layout(1, 1)
    assert layout.data == layout.pipe == 1
    cfg = _vit_cfg()
    cfg["backbone"]["depth"] = 3
    model = build_model(cfg, NUM_CLASSES, device="cpu",
                        input_size=(SIZE, SIZE))

    class _Two:
        pipe, data, world, pipe_index = 2, 1, 2, 0
    with mesh.use_layout(_Two()), pytest.raises(
            ValueError, match="parallel.pipeline=2 must divide ViT depth 3"):
        model.module.backbone(torch.zeros(2, 3, SIZE, SIZE))


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
           sys.argv[5], sys.argv[6])
