"""Several processes training one model (port of `pl_yolo_tpu/parallel/`):
data parallelism with global BatchNorm, losses and augmentation, ZeRO-1 and
ZeRO-3, and GPipe over the ViT / MCTformer towers, on `torch.distributed`.

  * `distributed`: process set-up under torchrun (the backend by rule),
    per-host data sharding and the evaluation's gather;
  * `collectives`: the collectives the rest uses, differentiable where the
    step needs it, staged through host memory where gloo refuses a CUDA
    tensor;
  * `mesh`: the world as data x pipe process groups, the ZeRO rules, and
    the ambient layout that BatchNorm, the losses, the augmentation and
    the towers read inside a train step;
  * `pipeline`: GPipe over the pipe group;
  * `zero`: the data-parallel engine the train step drives (gradient
    reduction, the sharded optimizer and EMA of ZeRO-1 / ZeRO-3, and the
    gathers a checkpoint needs).

With one process, or outside a train step, nothing here runs and every
path is the single-process one.
"""
