"""Do the eval maps of EfficientRep, ResNet and GhostNet overflow the
decode's `exp` from the JAX package's own init, as they do from the
port's seeded init? (`chip_smoke.py` phase 18 (b) calibrates their BN
statistics first for that reason.)

    JAX_PLATFORMS=cpu python tests/extras_init_overflow.py [SIZE]

For each backbone, at the JAX defaults in `yolox_s.yaml`'s place of
CSPDarknet with a CSP-PAFPN neck (depths 1,1,1,1) and a decoupled head as
wide as its stage2-4 maps (as phase 18 (b) builds them), in fp32, at SIZE
px (640 by default): the JAX package's `model.init` at keys 0 and 1 and
the port's `build_model` at seeds 0 and 1, each in eval mode on the same
two images drawn as `bench.py` draws them (uniform 0-255). Prints, for
each init, the largest |value| of the head's regression maps, the
largest w/h logit that the decode exponentiates, the count of non-finite
decoded values, and the per-layer standard deviation of the conv kernels
(the first, the median and the last, over the kernels in the module's
order). Runs on the host's CPU; reads and writes nothing.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pl_yolo_tpu.layers import blocks as jax_blocks  # noqa: E402
from pl_yolo_tpu.models.detector import build_model as jax_build  # noqa: E402
from pl_yolo_tpu_torch import bridge  # noqa: E402
from pl_yolo_tpu_torch.models.detector import build_model  # noqa: E402
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config  # noqa

BACKBONES = (("efficientrep", (64, 128, 256)), ("resnet", (128, 256, 512)),
             ("ghostnet", (40, 112, 160)))
EXP_LIMIT = float(np.log(np.finfo(np.float32).max))   # 88.72


def config(name: str, widths: tuple) -> dict:
    cfg = load_config(CONFIG_DIR / "model" / "yolox_s.yaml")
    cfg["dtype"] = None
    cfg["backbone"] = {"name": name, "outputs": ["stage2", "stage3",
                                                 "stage4"]}
    cfg["neck"].update(channels=list(widths), depths=[1, 1, 1, 1])
    cfg["head"]["channels"] = list(widths)
    return cfg


def summary(maps: list, decoded: np.ndarray, kernel_std: list) -> str:
    """The regression maps' largest |value| and w/h logit, the decode's
    non-finite count, and the kernels' std (first, median, last)."""
    reg = [m[..., :4] for m in maps]
    wh = max(float(np.max(r[..., 2:4])) for r in reg)
    big = max(float(np.max(np.abs(r))) for r in reg)
    std = np.asarray(kernel_std)
    return (f"reg max |.| {big:.4g}, w/h logit max {wh:.4g} (exp overflows "
            f"past {EXP_LIMIT:.2f}), non-finite decoded "
            f"{int((~np.isfinite(decoded)).sum())}; conv kernel std first "
            f"{std[0]:.4g}, median {np.median(std):.4g}, last {std[-1]:.4g}"
            f" over {len(std)} kernels")


def main() -> int:
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 640
    torch.set_num_threads(max(os.cpu_count() // 2, 1))
    rng = np.random.default_rng(16)
    images = rng.uniform(0, 255, (2, size, size, 3)).astype(np.uint8)
    x = images.astype(np.float32)
    for name, widths in BACKBONES:
        cfg = config(name, widths)
        for key in (0, 1):
            model = jax_build(dict(cfg), 80)
            variables = model.init(jax.random.key(key), (size, size))
            maps = jax.jit(lambda v, im: model.module.apply(v, im, False))(
                variables, jnp.asarray(x))
            maps = [np.asarray(m) for m in maps]
            decoded = np.asarray(model.loss.eval_decode(
                [jnp.asarray(m) for m in maps]))
            std = [float(np.std(np.asarray(v))) for k, v in
                   bridge._flatten({"p": variables["params"]}).items()
                   if k[-1] == "kernel" and np.ndim(v) == 4]
            print(f"{name} at {size}px, JAX init key {key}: "
                  + summary(maps, decoded, std), flush=True)
        for seed in (0, 1):
            m = build_model(config(name, widths), 80, device="cpu",
                            seed=seed, input_size=(size, size))
            module = m.module.eval()
            with torch.no_grad():
                out = module(torch.from_numpy(x))
                decoded = m.loss.eval_decode(out).numpy()
            maps = [o.numpy() for o in out]    # NHWC, as the JAX maps
            std = [float(p.detach().std(unbiased=False)) for n, p in
                   module.named_parameters()
                   if p.ndim == 4 and n.endswith("weight")]
            print(f"{name} at {size}px, port init seed {seed}: "
                  + summary(maps, decoded, std), flush=True)
    jax_blocks.set_compute_dtype(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
