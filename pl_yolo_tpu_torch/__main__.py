"""CLI entry point (port of the JAX package's `train.py`):

    python -m pl_yolo_tpu_torch -c <model.yaml> -d <data.yaml> [flags]

trains, validates, checkpoints and resumes (`--resume`), or tests a
checkpoint (`--test --ckpt <dir>`). It runs on the CUDA card and refuses to
start where there is none, unless `--device cpu` asks for the CPU. After a
preemption checkpoint (SIGTERM) it exits 75 (EX_TEMPFAIL), so that a restart
wrapper relaunches it with `--resume`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .utils.config import (load_config, train_argument_parser,
                           validate_data_config, validate_model_config)


def main(argv=None):
    args = train_argument_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e} (--device cpu)")
    model_cfg = validate_model_config(load_config(args.model_config),
                                      args.model_config)
    data_cfg = validate_data_config(load_config(args.dataset_config),
                                    args.dataset_config)
    if args.data_path:
        data_cfg["dataset"]["dir"] = args.data_path

    np.random.seed(args.seed)  # host-side seed; the device draws are seeded
    # by the trainer's own generator

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    from .train.trainer import Trainer
    trainer = Trainer(
        model_cfg, data_cfg,
        max_epochs=args.max_epochs or 300,
        output_dir=args.output_dir,
        experiment_name=args.experiment_name,
        logger=args.logger,
        seed=args.seed,
        sanitize=args.sanitize,
        device=device,
    )

    if args.test:
        if args.ckpt is None:
            raise SystemExit("--test requires --ckpt <checkpoint dir>")
        trainer.load_weights(args.ckpt)
        trainer.test(conf=args.conf, nms=args.nms, visualize=args.visualize,
                     show_dir=args.show_dir,
                     show_score_thr=args.show_score_thr)
    else:
        trainer.fit(resume_from=args.ckpt, resume=args.resume)
        if trainer.preempted:
            raise SystemExit(75)


if __name__ == "__main__":
    main()
