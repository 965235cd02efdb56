#!/usr/bin/env python3
"""The attention registry's bound, card against CPU (`chip_smoke.py` phase
18 (c)): which tensors of the `ATTENTION` entries pass 1e-4 of their
scale, and what EPSA's 5x5 `conv1` weight gradient is on each device and
algorithm.

    python3 chip_attn_bound.py

On the CUDA card (TF32 off, cuDNN autotuning off, as phase 18 runs), it
prints every tensor whose error against the CPU's fp32 passes 1e-4 of its
scale (`attention_card_vs_cpu`), then EPSA's `conv1.weight` gradient
against the CPU's fp32 and float64 values, computed on the CPU in fp32 and
float64 and on the card in fp32, in fp32 with the deterministic
algorithms, and in float64 (`epsa_conv1_readings`). Exits non-zero without
a result where no CUDA card is available.
"""

from __future__ import annotations

import subprocess
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: nothing to measure", file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    attn = cs.attention_card_vs_cpu(torch, dev)
    print(f"[attn] {len(attn)} entries on {list(cs.ATTN_SHAPE)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (worst, tensor, _, _, errors) in sorted(
            attn.items(), key=lambda kv: -kv[1][0]):
        big = {k: v for k, v in errors.items() if v > 1e-4}
        print(f"[attn] {name}: worst {worst:.3e} ({tensor})"
              + "".join(f"; {k} {v:.3e}" for k, v in sorted(
                  big.items(), key=lambda kv: -kv[1])), flush=True)
    for way, (e32, e64) in cs.epsa_conv1_readings(torch, dev).items():
        print(f"[epsa] conv1.weight gradient, {way}: {e32:.3e} of its scale "
              f"from the CPU's fp32, {e64:.3e} from the CPU's float64",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
