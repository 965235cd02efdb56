"""Trainer: the train / val / test orchestration (port of
`pl_yolo_tpu/train/trainer.py`).

  * fit(): epochs x steps of the eager train step (augmentation on the
    device, forward/backward, optimizer, EMA), loss/LR logging, validation
    every `check_val_every_n_epoch` epochs and at the last, top-2
    checkpoints monitored on mAP, resume, and a preemption checkpoint on
    SIGTERM; multi-scale buckets (`transform: {multiscale_sizes}`).
  * validate(): eval-mode forward with the EMA weights, decode and NMS on
    the device, COCO evaluation on the host, and the average inference and
    NMS times.
  * test(): configurable conf/NMS thresholds, optional visualizations and
    VOC metrics.

Everything runs on one `torch.device` (the CUDA card unless `device="cpu"`)
in each process. Under torchrun (`parallel.distributed.initialize` first)
the processes train one model, as the JAX package's devices do: data
parallelism by default, with global BatchNorm, losses and augmentation
(`parallel.mesh`); ZeRO-1 / ZeRO-3 with the model yaml's `parallel: {zero:
true|3}`; a GPipe over the ViT / MCTformer towers with `parallel:
{pipeline: S}`; cout-sharded convs (`parallel: {model: M}`), bands of rows
with halo exchanges (`{spatial: S}`) and sharded MoE experts (`{expert:
X}`), the ranks laid out as the JAX package's mesh lays out its devices.
The data yaml's batch size is a host's, split over the host's data ranks;
each rank loads its data rank's rows and validates its share of the
images, whose detections rank 0 evaluates. Rank 0 alone logs and writes
checkpoints, in the single-process format (sharded state gathered first).
Config keys whose machinery is not ported raise `NotImplementedError`
naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import signal
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..parallel import distributed
from ..parallel.mesh import Layout
from ..parallel.zero import DataParallel
from ..data.augment import AugmentConfig, check_config, multiscale_resize
from ..data.datamodule import DataModule, build_data
from ..data.loader import device_prefetch
from ..evaluators.coco_eval import coco_evaluator
from ..evaluators.format import format_outputs
from ..evaluators.voc_eval import voc_evaluator
from ..layers.blocks import stem_input_s2d
from ..models.detector import DetectionModel, build_model
from ..ops.nms import postprocess
from ..utils.flops import model_summary
from ..utils.logger import build_logger
from ..utils.visualize import coco_visualization
from .checkpoint import CheckpointManager
from .optim import build_optimizer
from .state import TrainState, make_eval_step, make_train_step


# the families whose convs, pools, resizes and squeeze-excites the tensor
# and spatial paths cover: YOLOX's, YOLOv7's (E-ELAN, the YOLOv7 neck, the
# implicit head), YOLOv5's simple head, e-YOLOX's (ECMNet, AL-PAFPN), and
# the registry's other conv backbones (MobileNetV3, ShuffleNetV2,
# CSPMobileNext and the extras)
TP_SP_FAMILIES = {"backbone": ("cspdarknet", "eelan", "ecmnet",
                               "mobilenetv3s", "mobilenetv3l", "shufflenetv2",
                               "cspmobilenext", "efficientrep", "resnet",
                               "convnext", "ghostnet", "vgg", "mobilenext"),
                  "neck": ("csppafpn", "yolov7neck", "al_pafpn"),
                  "head": ("decoupled_head", "implicit_head", "simple_head")}


def check_ported(model_cfg: dict, data_cfg: dict) -> None:
    """Raise on config keys whose machinery the port does not have yet:
    combinations of the parallel axes that the JAX package takes through
    GSPMD (ROADMAP queue A, item 12c): tensor and spatial parallelism
    outside the families of `TP_SP_FAMILIES` (the transformer backbones
    and `neck: none`, item 12c.4 part 3), and a pipe width with a model,
    spatial or expert width (item 12c.5)."""
    par = model_cfg.get("parallel", {}) or {}
    if par.get("zero") not in (None, False, True, 0, 1, 3):
        raise ValueError(f"parallel.zero={par['zero']!r}: take true or 3")
    wide = {k: int(par[k]) for k in ("model", "spatial", "expert")
            if int(par.get(k, 1)) > 1}

    def refuse(what: str, item: str):
        raise NotImplementedError(
            f"parallel: {par}: {what} is not ported yet (ROADMAP queue A, "
            f"item {item})")
    if wide and int(par.get("pipeline", 1)) > 1:
        refuse(f"`pipeline` with {wide}", "12c.5")
    tp_sp = {k: v for k, v in wide.items() if k in ("model", "spatial")}
    if tp_sp:
        for part, names in TP_SP_FAMILIES.items():
            got = (model_cfg.get(part) or {}).get("name")
            if got not in names:
                refuse(f"{tp_sp} on {part} {got!r} (tensor and spatial "
                       f"parallelism cover the {part}s {names})",
                       "12c.4 part 3")
    t_cfg = data_cfg.get("transform", {}) or {}
    check_config(AugmentConfig.from_dict(t_cfg))  # use_pallas


def finite_detections(json_list: list, before: str) -> list:
    """The COCO result dicts whose score and box are finite; warns with the
    count of those dropped, as the COCO evaluation does. (A model a few
    steps from its init can decode an infinite box, on which the drawing
    would raise.)"""
    finite = [d for d in json_list
              if np.isfinite(d["score"]) and np.all(np.isfinite(d["bbox"]))]
    if len(finite) != len(json_list):
        warnings.warn(f"dropped {len(json_list) - len(finite)} non-finite "
                      f"detections before {before}", RuntimeWarning,
                      stacklevel=2)
    return finite


class _Quiet:
    """The logger of a rank other than 0: it writes nothing."""

    def log_hyperparams(self, params: dict):
        pass

    def log_metrics(self, metrics: dict, step: int):
        pass

    def finalize(self):
        pass


def _gather_in_order(*lists: tuple[list, list]) -> list[list]:
    """Every rank's (positions, items) lists gathered, and each merged in
    the order of the positions (the one-process order of the images)."""
    gathered = distributed.all_gather_host(lists)
    out = []
    for i in range(len(lists)):
        pairs = [(p, k, item) for rank in gathered
                 for k, (p, item) in enumerate(zip(*rank[i]))]
        out.append([item for _, _, item in sorted(
            pairs, key=lambda t: (t[0], t[1]))])
    return out


class Trainer:
    def __init__(
        self,
        model_cfg: dict,
        data_cfg: dict,
        max_epochs: int = 300,
        check_val_every_n_epoch: int = 5,
        output_dir: str = "./runs",
        experiment_name: str | None = None,
        logger: str = "tb",
        seed: int = 96,
        log_every_n_steps: int = 50,
        save_top_k: int = 2,
        cache_images: bool = False,
        sanitize: bool = False,
        device=None,
    ):
        check_ported(model_cfg, data_cfg)
        self.rank, self.world = distributed.world()
        self.device = (distributed.rank_device(device) if self.world > 1
                       else resolve_device(device))
        self.main = distributed.is_main_process()
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.max_epochs = max_epochs
        self.check_val_every = check_val_every_n_epoch
        self.seed = seed
        self.log_every = log_every_n_steps
        self.sanitize = sanitize
        name = experiment_name or model_cfg.get("name", "exp")
        self.out_dir = Path(output_dir) / name
        if self.main:
            self.out_dir.mkdir(parents=True, exist_ok=True)
        self.logger = (build_logger(logger, self.out_dir, "logs")
                       if self.main else _Quiet())

        self.datamodule: DataModule = build_data(data_cfg, seed=seed,
                                                 cache=cache_images)
        self.num_classes = self.datamodule.num_classes
        self.model: DetectionModel = build_model(
            model_cfg, self.num_classes, device=self.device, seed=seed,
            input_size=tuple(self.datamodule.train_size))
        self.layout = self._check_parallel()
        self.ckpt = (CheckpointManager(self.out_dir / "checkpoints",
                                       max_to_keep=save_top_k, monitor="mAP")
                     if self.main else None)

        self.state: TrainState | None = None
        self.best_map = 0.0
        self.best_map50 = 0.0
        self._steps_per_epoch = None
        self.use_ema = bool(model_cfg.get("optimizer", {}).get("ema", True))
        # the last evaluation's counts and host-clock times: {"batches",
        # "detections", "infer_s", "nms_s" (means a batch after the first),
        # "format_s", "coco_eval_s" (totals)}
        self.eval_times: dict = {}
        self.detections: list = []   # the last validation's, COCO dicts
        self._preempted = False

    def _check_parallel(self) -> Layout | None:
        """The `parallel:` checks of the JAX trainer (its messages), and the
        layout of the world: data x model x spatial x pipe x expert, None in
        one process."""
        par = self.model_cfg.get("parallel", {}) or {}
        self.pipe_par = int(par.get("pipeline", 1))
        self.model_par = int(par.get("model", 1))
        self.spatial_par = int(par.get("spatial", 1))
        self.expert_par = int(par.get("expert", 1))
        self.zero_par = 3 if par.get("zero") == 3 else int(bool(
            par.get("zero")))
        non_data = (self.model_par * self.spatial_par * self.pipe_par
                    * self.expert_par)
        if self.world % non_data:
            raise ValueError(
                f"parallel.model={self.model_par} x parallel.spatial="
                f"{self.spatial_par} x parallel.pipeline={self.pipe_par} x "
                f"parallel.expert={self.expert_par} must divide the device "
                f"count {self.world}")
        if self.expert_par > 1:
            moe = int(getattr(self.model.module.backbone, "moe_experts", 0)
                      or 0)
            if moe % self.expert_par:
                raise ValueError(
                    f"parallel.expert={self.expert_par} needs a MoE backbone "
                    f"with moe_experts divisible by it (got {moe}) — set "
                    "backbone.moe_experts (vision_transformer) or drop the "
                    "key")
        if self.spatial_par > 1:
            t_cfg = self.data_cfg.get("transform", {}) or {}
            for h, _ in [tuple(self.datamodule.train_size)] + [
                    tuple(s) for s in t_cfg.get("multiscale_sizes") or []]:
                if int(h) % (32 * self.spatial_par) != 0:
                    raise ValueError(
                        f"parallel.spatial={self.spatial_par} needs train "
                        f"H={h} divisible by 32*{self.spatial_par}")
        self.non_data = non_data
        # the data-parallel width of a host: the batch size is a host's
        local = distributed.host_info()[3]
        data_par = max(local // non_data, 1)
        bs = self.datamodule.train_batch_size
        if self.pipe_par > 1:
            backbone = type(self.model.module.backbone)
            if not getattr(backbone, "PIPELINE_TOWER", False):
                raise ValueError(
                    f"parallel.pipeline={self.pipe_par} but backbone "
                    f"{backbone.__name__} has no uniform block tower "
                    "(PIPELINE_TOWER) — use a ViT-family backbone or drop "
                    "the key")
            if bs % self.pipe_par or (bs // self.pipe_par) % data_par:
                raise ValueError(
                    f"batch_size={bs} must split into "
                    f"parallel.pipeline={self.pipe_par} microbatches whose "
                    f"rows divide the data-parallel width {data_par}")
        if bs % data_par != 0:
            raise ValueError(
                f"train batch_size={bs} must be divisible by the data-"
                f"parallel width {data_par}; raise the batch or shrink the "
                f"slice (e.g. batch "
                f"{bs * data_par if bs < data_par else bs - bs % data_par})")
        self.data_par = data_par
        if self.world == 1:
            return None
        return Layout(self.world // non_data, self.pipe_par,
                      model=self.model_par, spatial=self.spatial_par,
                      expert=self.expert_par)

    def _rows(self) -> slice | None:
        """This rank's rows of its host's batch (its data rank's), None in
        one process."""
        if self.layout is None:
            return None
        local_rank = distributed.host_info()[2]
        n = self.datamodule.train_batch_size // self.data_par
        start = (local_rank // self.non_data) * n
        return slice(start, start + n)

    @property
    def preempted(self) -> bool:
        """True once fit() took a preemption checkpoint on SIGTERM: the CLI
        then exits 75 (EX_TEMPFAIL), so that a restart wrapper relaunches
        with --resume instead of treating the run as complete."""
        return self._preempted

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ fit

    def _build_state(self, total_steps: int) -> TrainState:
        engine = None
        if self.layout is not None:
            engine = DataParallel(self.model.module, self.layout,
                                  zero=self.zero_par, use_ema=self.use_ema)
        optimizer, self._schedule = build_optimizer(
            self.model.module, self.model_cfg["optimizer"], total_steps,
            **(engine.optimizer_views() if engine is not None else {}))
        return TrainState.create(self.model.module, optimizer,
                                 use_ema=self.use_ema, parallel=engine)

    def make_step(self, out_hw: tuple[int, int] | None = None):
        """The train step `fit` runs, `step(state, images, labels,
        generator=, aug_enable=, use_l1=)`. At the base size (`out_hw`
        None) a Focus-stem backbone takes the augmentation's space-to-depth
        output directly (opt out with the model yaml's `stem_s2d: false`),
        others the NHWC images; a multi-scale bucket `out_hw` takes the
        NHWC images resized on the device (`multiscale_resize`)."""
        stem_s2d = (out_hw is None
                    and getattr(type(self.model.module.backbone), "STEM_S2D",
                                False)
                    and bool(self.model_cfg.get("stem_s2d", True)))

        def s2d_apply(module, images):
            with stem_input_s2d():
                return module(images)
        augment = self.datamodule.make_augment_fn(out_s2d=stem_s2d)
        if out_hw is not None:
            base_augment = augment

            def augment(generator, images, labels, enable=True):
                return multiscale_resize(
                    *base_augment(generator, images, labels, enable=enable),
                    out_hw)
        return make_train_step(
            self.model.loss.train_loss, use_ema=self.use_ema,
            augment_fn=augment, sanitize=self.sanitize,
            apply_fn=s2d_apply if stem_s2d else None)

    def make_steps(self) -> tuple[list, int]:
        """(the step of each multi-scale bucket, the switch interval):
        bucket 0 is the base size, then each `transform: {multiscale_sizes}`
        entry that differs from it, switched every `multiscale_interval`
        steps (default 10). Without buckets: ([the base step], 0)."""
        t_cfg = self.data_cfg.get("transform", {}) or {}
        base_hw = tuple(self.datamodule.train_size)
        sizes = [tuple(s) for s in (t_cfg.get("multiscale_sizes") or [])]
        steps = [self.make_step()]
        if not sizes:
            return steps, 0
        steps += [self.make_step(s) for s in sizes if s != base_hw]
        interval = int(t_cfg.get("multiscale_interval", 10))
        print(f"[trainer] multi-scale buckets {[base_hw] + sizes}, switch "
              f"every {interval} steps")
        return steps, interval

    def epoch_flags(self, epoch: int) -> dict:
        """The epoch-gated YOLOX recipe (upstream exp: no_aug_epochs=15):
        the last `schedule: {no_aug_epochs}` epochs run with mosaic/mixup
        off and, unless `schedule: {use_l1: false}`, the L1 term on. No
        flags without the schedule: the step then takes its defaults."""
        sched = self.model_cfg.get("schedule", {}) or {}
        no_aug_epochs = int(sched.get("no_aug_epochs", 0))
        if no_aug_epochs <= 0:
            return {}
        no_aug = epoch >= self.max_epochs - no_aug_epochs
        static_l1 = bool(self.model_cfg.get("loss", {}).get("use_l1", False))
        return {"aug_enable": not no_aug,
                "use_l1": static_l1 or (no_aug
                                        and bool(sched.get("use_l1", True)))}

    def fit(self, resume_from: str | None = None, resume: bool = False):
        """Train for `max_epochs`. A SIGTERM while it runs makes the loop
        save a checkpoint at the next step boundary and return, with
        `preempted` true; the handler it replaces is back when fit returns.
        A resumed run continues the interrupted epoch at its next step."""
        previous = signal.getsignal(signal.SIGTERM)

        def on_sigterm(signum, frame):
            print(f"[trainer] received signal {signum}; will checkpoint "
                  "and stop at the next step boundary", flush=True)
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            previous = None  # not the main thread (e.g. tests)
        try:
            self._fit(resume_from, resume)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _fit(self, resume_from: str | None, resume: bool):
        self.datamodule.setup("fit")
        host, hosts = distributed.host_info()[:2]
        loader = (self.datamodule.train_loader() if self.layout is None
                  else self.datamodule.train_loader(host, hosts,
                                                    self._rows()))
        # the host->device copies run two batches ahead on their own thread
        batches = device_prefetch(loader, self.device, threaded=True)
        try:
            self._train(batches, loader.steps_per_epoch, resume_from, resume)
        finally:
            batches.close()  # stops and joins the copy thread
            loader.close()

    def _train(self, batches, steps_per_epoch: int,
               resume_from: str | None, resume: bool):
        self._steps_per_epoch = steps_per_epoch
        total_steps = steps_per_epoch * self.max_epochs
        # (the whole module: the engine shards it)
        n_params, flops, summary = model_summary(
            self.model.module, input_size=self.datamodule.train_size)
        self.state = self._build_state(total_steps)

        start_epoch = 0
        if resume_from or resume:
            start_epoch = self._restore(resume_from, resume)

        if self.main:
            print(summary)
        self.logger.log_hyperparams(
            {"model": self.model_cfg, "data": self.data_cfg,
             "params": n_params, "flops": flops})

        # multi-scale buckets: drawn every `interval` steps from a seeded
        # host generator (the JAX trainer's sequence); the no-aug epochs
        # train at the base size
        step_fns, interval = self.make_steps()
        bucket_rng = np.random.default_rng(self.seed + 7)
        step_fn = step_fns[0]
        accum = int(self.model_cfg.get("optimizer", {})
                    .get("accumulate_steps", 1))
        # one generator on the device for every augmentation draw, seeded
        # alike on every rank: each draws the global batch's numbers
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed + 1)
        batch_size = self.datamodule.train_batch_size

        # host-side step counter, from the restored step: the logged LR
        # continues the schedule, and reading it never syncs
        step = int(self.state.step)
        # several ranks stop at one step, whichever the signal reached
        stop = distributed.StopFlag() if self.layout is not None else None
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.perf_counter()
            waited = 0.0
            losses = None
            flags = self.epoch_flags(epoch)
            if self.main and flags and (epoch == start_epoch
                                        or flags != self.epoch_flags(
                                            epoch - 1)):
                print(f"[trainer] epoch {epoch}: mosaic/mixup "
                      f"{'on' if flags['aug_enable'] else 'OFF'}, "
                      f"L1 {'on' if flags['use_l1'] else 'off'}")
            no_aug = bool(flags) and not flags["aug_enable"]
            n_steps = steps_per_epoch * (epoch + 1) - step
            for _ in range(n_steps):
                tw = time.perf_counter()
                batch = next(batches)
                waited += time.perf_counter() - tw
                if interval and no_aug:
                    step_fn = step_fns[0]
                elif interval and step % interval == 0:
                    step_fn = step_fns[int(bucket_rng.integers(
                        len(step_fns)))]
                losses = step_fn(self.state, batch["images"],
                                 batch["labels"], generator=generator,
                                 **flags)
                step += 1
                if step % self.log_every == 0:
                    metrics = {k: float(v) for k, v in losses.items()}
                    # the schedule counts updates, which lag micro-steps
                    # under accumulate_steps
                    metrics["lr"] = float(self._schedule(step // accum))
                    self.logger.log_metrics(metrics, step)
                    if not np.isfinite(metrics["loss"]):
                        # fail loudly with a debug checkpoint instead of
                        # training on NaNs
                        self._save({"mAP": self.best_map, "nan": 1.0})
                        raise FloatingPointError(
                            f"non-finite loss at step {step}: {metrics}"
                            " — debug checkpoint saved; rerun with"
                            " --debug_nans to locate the op")
                if (stop.vote(self._preempted) if stop is not None
                        else self._preempted):
                    if stop is not None:
                        stop.settle()
                    self._preempted = True
                    self._save({"mAP": self.best_map, "preempted": 1.0})
                    print(f"[trainer] preemption checkpoint at step "
                          f"{step}; resume with --resume", flush=True)
                    return
            # epoch end: one sync to report the last step's losses
            last_loss = (float(losses["loss"]) if losses is not None
                         else float("nan"))
            if self.sanitize and losses is not None:
                bad = float(losses.get("nonfinite_grads", 0.0))
                gn = float(losses.get("grad_norm", float("nan")))
                self.logger.log_metrics(
                    {"grad_norm": gn, "nonfinite_grads": bad}, step)
                if bad > 0 or not np.isfinite(last_loss):
                    print(f"[sanitize] WARNING epoch {epoch}: "
                          f"{int(bad)} non-finite grad elements, "
                          f"loss={last_loss}, grad_norm={gn}")
            dt = time.perf_counter() - t0
            ips = n_steps * batch_size / dt
            # the loop's time without its waits for the loader's next batch
            step_ips = n_steps * batch_size / max(dt - waited, 1e-9)
            if self.main:
                print(f"epoch {epoch}: {dt:.1f}s ({ips:.1f} img/s) "
                      f"loss={last_loss:.3f}; {step_ips:.1f} img/s without "
                      f"the {waited:.2f}s spent waiting for the loader",
                      flush=True)
            self.logger.log_metrics(
                {"loss_epoch": last_loss, "epoch_img_s": ips,
                 "step_img_s": step_ips, "loader_wait_s": waited}, step)

            if ((epoch + 1) % self.check_val_every == 0
                    or epoch == self.max_epochs - 1):
                ap, ap50 = self.validate()
                self.logger.log_metrics({"mAP": ap, "mAP50": ap50}, step)
                if ap > self.best_map:
                    self.best_map, self.best_map50 = ap, ap50
                self._save({"mAP": ap, "mAP50": ap50})
        if stop is not None:
            # a signal after the last step's vote: every rank ends with
            # the same `preempted`
            stop.vote(self._preempted)
            self._preempted = stop.settle()
        if self.main:
            self.ckpt.wait()
            print(f"Best mAP = {self.best_map:.3f}, "
                  f"best mAP50 = {self.best_map50:.3f}")
        self.logger.finalize()

    # ------------------------------------------------------------ val/test

    def _run_eval(self, batches, module, conf: float, nms: float,
                  visualize: bool = False, show_dir: str = "./show",
                  show_score_thr: float = 0.3, dataset=None):
        eval_fn = make_eval_step(self.model.loss.eval_decode)
        json_list, det_list = [], []
        infer_t, nms_t, format_s = [], [], 0.0
        # each image's place in the one-process order: this rank walks the
        # images rank, rank + world, ... (`eval_batches`)
        json_pos, det_pos, seen = [], [], 0
        for batch in batches:
            t0 = time.perf_counter()
            preds = eval_fn(module, torch.from_numpy(batch["images"]))
            self._sync()
            t1 = time.perf_counter()
            det = postprocess(preds, conf_threshold=conf, iou_threshold=nms,
                              device=self.device)
            self._sync()
            t2 = time.perf_counter()
            infer_t.append(t1 - t0)
            nms_t.append(t2 - t1)
            jl, dl = format_outputs(
                det, batch["img_id"], batch["img_h"], batch["img_w"],
                self.datamodule.val_size, dataset.class_ids,
                self.num_classes, count=batch.get("count"))
            format_s += time.perf_counter() - t2
            count = batch.get("count", len(batch["img_id"]))
            pos = {int(i): self.rank + (seen + k) * self.world
                   for k, i in enumerate(batch["img_id"][:count])}
            json_pos += [pos[d["image_id"]] for d in jl]
            det_pos += [self.rank + (seen + k) * self.world
                        for k in range(len(dl))]
            seen += count
            json_list += jl
            det_list += dl
        if self.world > 1:
            json_list, det_list = _gather_in_order(
                (json_pos, json_list), (det_pos, det_list))
        n = len(infer_t)
        if n > 1:  # the first batch's warm-up stays out of the average
            infer_t, nms_t = infer_t[1:], nms_t[1:]
        if self.main:
            print("The average inference time is %.4fs, nms time is %.4fs"
                  % (float(np.mean(infer_t)), float(np.mean(nms_t))))
        self.eval_times = {"batches": n, "detections": len(json_list),
                           "infer_s": float(np.mean(infer_t)),
                           "nms_s": float(np.mean(nms_t)),
                           "format_s": format_s}
        if visualize and dataset is not None and self.main:
            n = coco_visualization(finite_detections(json_list, "drawing"),
                                   dataset, out_dir=show_dir,
                                   score_thr=show_score_thr,
                                   class_names=self.datamodule.class_names)
            print(f"wrote {n} visualizations to {show_dir}")
        return json_list, det_list

    def _evaluate(self, json_list, dataset):
        """COCO evaluation of every rank's detections, on rank 0; every
        rank returns its (mAP, mAP50)."""
        if self.main:
            t0 = time.perf_counter()
            ap, ap50, summary = coco_evaluator(json_list, dataset)
            self.eval_times["coco_eval_s"] = time.perf_counter() - t0
            print(summary)
            print(f"mAP = {ap:.4f}, mAP50 = {ap50:.4f}")
        else:
            ap = ap50 = None
        if self.world > 1:
            ap, ap50 = distributed.all_gather_host((ap, ap50))[0]
        return ap, ap50

    def validate(self, conf: float = 0.01, nms: float = 0.65):
        if self.datamodule.dataset_val is None:
            self.datamodule.setup("val")
        dataset = self.datamodule.dataset_val
        assert self.state is not None, "fit() or load a checkpoint first"
        json_list, _ = self._run_eval(
            self.datamodule.val_batches(*distributed.shard_info()),
            self.state.eval_module, conf, nms, dataset=dataset)
        # every rank's detections, in the one-process order
        self.detections = json_list
        return self._evaluate(json_list, dataset)

    def test(self, conf: float = 0.01, nms: float = 0.65,
             visualize: bool = False, show_dir: str = "./show",
             show_score_thr: float = 0.3, use_voc: bool = False):
        self.datamodule.setup("test")
        dataset = self.datamodule.dataset_test
        json_list, det_list = self._run_eval(
            self.datamodule.test_batches(*distributed.shard_info()),
            self.state.eval_module, conf, nms,
            visualize=visualize, show_dir=show_dir,
            show_score_thr=show_score_thr, dataset=dataset)
        ap, ap50 = self._evaluate(json_list, dataset)
        if use_voc and self.main:
            gt_list = dataset.gt_per_class(self.num_classes)
            voc_map, report = voc_evaluator(
                det_list, gt_list, class_names=self.datamodule.class_names)
            print(report)
        return ap, ap50

    # --------------------------------------------------------- checkpoints

    def _ckpt_tree(self) -> dict:
        """The state in the single-process format (under ZeRO, tensor or
        expert parallelism gathered from the ranks' slices: a collective
        call)."""
        s = self.state
        par = s.parallel
        if par is not None and par.sliced:
            return {"step": s.step, "module": par.module_state_dict(),
                    "ema_module": (par.ema_state_dict() if s.sharded_ema
                                   else None),
                    "optimizer": par.optimizer_state_dict()}
        return {
            "step": s.step, "module": s.module.state_dict(),
            "ema_module": (None if s.ema_module is None
                           else s.ema_module.state_dict()),
            "optimizer": s.optimizer.state_dict(),
        }

    def _save(self, metrics: dict):
        """Every rank gathers; rank 0 writes."""
        tree = self._ckpt_tree()
        if self.main:
            self.ckpt.save(self.state.step, tree, metrics)

    def _restore(self, path: str | None, resume: bool) -> int:
        """Load the module and EMA weights (BN statistics included) and,
        with `resume`, the step and the optimizer state, with the schedule's
        update count. Returns the epoch to continue from."""
        mgr = (CheckpointManager(self.out_dir / "checkpoints")
               if path is None and self.ckpt is None
               else self.ckpt if path is None else CheckpointManager(path))
        restored = mgr.restore(map_location=self.device)
        s = self.state
        par = s.parallel if s.parallel is not None and s.parallel.sliced \
            else None
        if par is not None:
            par.load_module_state_dict(restored["module"])
        else:
            s.module.load_state_dict(restored["module"])
        if s.sharded_ema:
            par.load_ema_state_dict(restored["ema_module"]
                                    or restored["module"])
        elif s.ema_module is not None:
            s.ema_module.load_state_dict(restored["ema_module"]
                                         or restored["module"])
        if resume:
            s.step = int(restored["step"])
            if par is not None:
                par.load_optimizer_state_dict(restored["optimizer"])
            else:
                s.optimizer.load_state_dict(restored["optimizer"])
            # the LR schedule's position, in updates, and the micro-steps
            # since the last one (`accumulate_steps`)
            every = getattr(s.optimizer, "accumulate_steps", 1)
            s.optimizer.updates = s.step // every
            if every > 1:
                s.optimizer.mini_step = s.step % every
        if resume and self._steps_per_epoch:
            return s.step // self._steps_per_epoch
        return 0

    def load_weights(self, path: str):
        """Load the module and EMA weights from a checkpoint directory
        (weights only)."""
        if self.state is None:
            self.datamodule.setup("val")
            self.state = self._build_state(total_steps=1000)
        self._restore(path, resume=False)
