"""Several processes training one model (port of `pl_yolo_tpu/parallel/`):
data parallelism with global BatchNorm, losses and augmentation, ZeRO-1 and
ZeRO-3, GPipe over the ViT / MCTformer towers, and tensor, spatial and
expert parallelism, on `torch.distributed`.

  * `distributed`: process set-up under torchrun (the backend by rule),
    per-host data sharding and the evaluation's gather;
  * `collectives`: the collectives the rest uses, differentiable where the
    step needs it, staged through host memory where gloo refuses a CUDA
    tensor;
  * `mesh`: the world in the five axes of `make_mesh` (data, model,
    spatial, pipe, expert) and their process groups, the ZeRO rules, and
    the ambient layout that BatchNorm, the losses, the augmentation, the
    convs, the pools, the MoE FFN and the towers read inside a train step;
  * `tensor`: which weights the model and expert widths shard, the
    cout-sharded conv, and the moves between the one-process module and
    a rank's slices;
  * `spatial`: each rank's band of rows, the halo exchanges of the convs
    and pools, and the gather of the head maps before the loss;
  * `pipeline`: GPipe over the pipe group;
  * `zero`: the data-parallel engine the train step drives (gradient
    reduction over the norm group, the sharded optimizer and EMA of ZeRO-1
    / ZeRO-3, the model and expert slices, and the gathers a checkpoint
    and validation need).

With one process, or outside a train step, nothing here runs and every
path is the single-process one.
"""
