"""Trainer: the train / val / test orchestration (port of
`pl_yolo_tpu/train/trainer.py`).

  * fit(): epochs x steps of the eager train step (augmentation on the
    device, forward/backward, optimizer, EMA), loss/LR logging, validation
    every `check_val_every_n_epoch` epochs and at the last, top-2
    checkpoints monitored on mAP, resume, and a preemption checkpoint on
    SIGTERM.
  * validate(): eval-mode forward with the EMA weights, decode and NMS on
    the device, COCO evaluation on the host, and the average inference and
    NMS times.
  * test(): configurable conf/NMS thresholds, optional visualizations and
    VOC metrics.

Everything runs on one `torch.device` (the CUDA card unless `device="cpu"`)
in one process. Config keys whose machinery is not ported raise
`NotImplementedError` naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import signal
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.augment import AugmentConfig, check_config
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


def check_ported(model_cfg: dict, data_cfg: dict) -> None:
    """Raise on config keys whose machinery the port does not have yet."""
    par = model_cfg.get("parallel", {}) or {}
    wide = {k: int(par[k]) for k in ("model", "spatial", "pipeline", "expert")
            if int(par.get(k, 1)) > 1}
    if wide or par.get("zero"):
        raise NotImplementedError(
            f"parallel: {par} needs model, spatial, pipeline or expert "
            "parallelism or ZeRO, which are not ported yet (ROADMAP queue "
            "A, item 12); the port trains on one device")
    t_cfg = data_cfg.get("transform", {}) or {}
    if t_cfg.get("multiscale_sizes"):
        raise NotImplementedError(
            "transform: {multiscale_sizes} (multi-scale training) is not "
            "ported yet (ROADMAP queue A, item 11)")
    check_config(AugmentConfig.from_dict(t_cfg))  # degrees, shear, ...


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
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.max_epochs = max_epochs
        self.check_val_every = check_val_every_n_epoch
        self.seed = seed
        self.log_every = log_every_n_steps
        self.sanitize = sanitize
        name = experiment_name or model_cfg.get("name", "exp")
        self.out_dir = Path(output_dir) / name
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.logger = build_logger(logger, self.out_dir, "logs")

        self.datamodule: DataModule = build_data(data_cfg, seed=seed,
                                                 cache=cache_images)
        self.num_classes = self.datamodule.num_classes
        self.model: DetectionModel = build_model(
            model_cfg, self.num_classes, device=self.device, seed=seed)
        self.ckpt = CheckpointManager(self.out_dir / "checkpoints",
                                      max_to_keep=save_top_k, monitor="mAP")

        self.state: TrainState | None = None
        self.best_map = 0.0
        self.best_map50 = 0.0
        self._steps_per_epoch = None
        self.use_ema = bool(model_cfg.get("optimizer", {}).get("ema", True))
        # the last evaluation's counts and host-clock times: {"batches",
        # "detections", "infer_s", "nms_s" (means a batch after the first),
        # "format_s", "coco_eval_s" (totals)}
        self.eval_times: dict = {}
        self._preempted = False

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
        optimizer, self._schedule = build_optimizer(
            self.model.module, self.model_cfg["optimizer"], total_steps)
        return TrainState.create(self.model.module, optimizer,
                                 use_ema=self.use_ema)

    def make_step(self):
        """The train step `fit` runs, `step(state, images, labels,
        generator=, aug_enable=, use_l1=)`: a Focus-stem backbone takes the
        augmentation's space-to-depth output directly (opt out with the
        model yaml's `stem_s2d: false`), others the NHWC images."""
        stem_s2d = (getattr(type(self.model.module.backbone), "STEM_S2D",
                            False)
                    and bool(self.model_cfg.get("stem_s2d", True)))

        def s2d_apply(module, images):
            with stem_input_s2d():
                return module(images)
        return make_train_step(
            self.model.loss.train_loss, use_ema=self.use_ema,
            augment_fn=self.datamodule.make_augment_fn(out_s2d=stem_s2d),
            sanitize=self.sanitize, apply_fn=s2d_apply if stem_s2d else None)

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
        loader = self.datamodule.train_loader()
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
        self.state = self._build_state(total_steps)

        start_epoch = 0
        if resume_from or resume:
            start_epoch = self._restore(resume_from, resume)

        n_params, flops, summary = model_summary(
            self.model.module, input_size=self.datamodule.train_size)
        print(summary)
        self.logger.log_hyperparams(
            {"model": self.model_cfg, "data": self.data_cfg,
             "params": n_params, "flops": flops})

        step_fn = self.make_step()
        # one generator on the device for every augmentation draw
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed + 1)
        batch_size = self.datamodule.train_batch_size

        # host-side step counter, from the restored step: the logged LR
        # continues the schedule, and reading it never syncs
        step = int(self.state.step)
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.perf_counter()
            waited = 0.0
            losses = None
            flags = self.epoch_flags(epoch)
            if flags and (epoch == start_epoch
                          or flags != self.epoch_flags(epoch - 1)):
                print(f"[trainer] epoch {epoch}: mosaic/mixup "
                      f"{'on' if flags['aug_enable'] else 'OFF'}, "
                      f"L1 {'on' if flags['use_l1'] else 'off'}")
            n_steps = steps_per_epoch * (epoch + 1) - step
            for _ in range(n_steps):
                tw = time.perf_counter()
                batch = next(batches)
                waited += time.perf_counter() - tw
                losses = step_fn(self.state, batch["images"],
                                 batch["labels"], generator=generator,
                                 **flags)
                step += 1
                if step % self.log_every == 0:
                    metrics = {k: float(v) for k, v in losses.items()}
                    metrics["lr"] = float(self._schedule(step))
                    self.logger.log_metrics(metrics, step)
                    if not np.isfinite(metrics["loss"]):
                        # fail loudly with a debug checkpoint instead of
                        # training on NaNs
                        self._save({"mAP": self.best_map, "nan": 1.0})
                        raise FloatingPointError(
                            f"non-finite loss at step {step}: {metrics}"
                            " — debug checkpoint saved; rerun with"
                            " --debug_nans to locate the op")
                if self._preempted:
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
            print(f"epoch {epoch}: {dt:.1f}s ({ips:.1f} img/s) "
                  f"loss={last_loss:.3f}; {step_ips:.1f} img/s without the "
                  f"{waited:.2f}s spent waiting for the loader", flush=True)
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
            json_list += jl
            det_list += dl
        n = len(infer_t)
        if n > 1:  # the first batch's warm-up stays out of the average
            infer_t, nms_t = infer_t[1:], nms_t[1:]
        print("The average inference time is %.4fs, nms time is %.4fs"
              % (float(np.mean(infer_t)), float(np.mean(nms_t))))
        self.eval_times = {"batches": n, "detections": len(json_list),
                           "infer_s": float(np.mean(infer_t)),
                           "nms_s": float(np.mean(nms_t)),
                           "format_s": format_s}
        if visualize and dataset is not None:
            n = coco_visualization(json_list, dataset, out_dir=show_dir,
                                   score_thr=show_score_thr,
                                   class_names=self.datamodule.class_names)
            print(f"wrote {n} visualizations to {show_dir}")
        return json_list, det_list

    def _evaluate(self, json_list, dataset):
        t0 = time.perf_counter()
        ap, ap50, summary = coco_evaluator(json_list, dataset)
        self.eval_times["coco_eval_s"] = time.perf_counter() - t0
        print(summary)
        print(f"mAP = {ap:.4f}, mAP50 = {ap50:.4f}")
        return ap, ap50

    def validate(self, conf: float = 0.01, nms: float = 0.65):
        if self.datamodule.dataset_val is None:
            self.datamodule.setup("val")
        dataset = self.datamodule.dataset_val
        assert self.state is not None, "fit() or load a checkpoint first"
        json_list, _ = self._run_eval(
            self.datamodule.val_batches(), self.state.eval_module, conf, nms,
            dataset=dataset)
        return self._evaluate(json_list, dataset)

    def test(self, conf: float = 0.01, nms: float = 0.65,
             visualize: bool = False, show_dir: str = "./show",
             show_score_thr: float = 0.3, use_voc: bool = False):
        self.datamodule.setup("test")
        dataset = self.datamodule.dataset_test
        json_list, det_list = self._run_eval(
            self.datamodule.test_batches(), self.state.eval_module, conf, nms,
            visualize=visualize, show_dir=show_dir,
            show_score_thr=show_score_thr, dataset=dataset)
        ap, ap50 = self._evaluate(json_list, dataset)
        if use_voc:
            gt_list = dataset.gt_per_class(self.num_classes)
            voc_map, report = voc_evaluator(
                det_list, gt_list, class_names=self.datamodule.class_names)
            print(report)
        return ap, ap50

    # --------------------------------------------------------- checkpoints

    def _ckpt_tree(self) -> dict:
        s = self.state
        return {
            "step": s.step, "module": s.module.state_dict(),
            "ema_module": (None if s.ema_module is None
                           else s.ema_module.state_dict()),
            "optimizer": s.optimizer.state_dict(),
        }

    def _save(self, metrics: dict):
        self.ckpt.save(self.state.step, self._ckpt_tree(), metrics)

    def _restore(self, path: str | None, resume: bool) -> int:
        """Load the module and EMA weights (BN statistics included) and,
        with `resume`, the step and the optimizer state, with the schedule's
        update count. Returns the epoch to continue from."""
        mgr = self.ckpt if path is None else CheckpointManager(path)
        restored = mgr.restore(map_location=self.device)
        s = self.state
        s.module.load_state_dict(restored["module"])
        if s.ema_module is not None:
            s.ema_module.load_state_dict(restored["ema_module"]
                                         or restored["module"])
        if resume:
            s.step = int(restored["step"])
            s.optimizer.load_state_dict(restored["optimizer"])
            s.optimizer.updates = s.step  # the LR schedule's position
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
