#!/usr/bin/env python3
"""Time the multi-rank runs of `chip_smoke.py` (phases 16 and 17: their
ranks and one-process references, `RANK_RUNS`) from several checkouts, in
turns, on one CUDA card.

    python3 chip_ranks_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (this one, or another unpacked beside
it, say with one collective changed); give them in the order to run, for
instance A B B A. For each, a fresh process imports that tree's
`chip_smoke`, builds its kernels, runs `run_ranks` and `hold_ranks` for
the two phases (the ranks held to one process as the smoke holds them)
and prints each run's images/s of rank 0's timed steps, its seconds and
rank 0's staged collectives. Only the same call's turns compare: the
host's share of a step differs between calls. Exits non-zero without a
result where no CUDA card is available.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def one(root: Path) -> None:
    """The two phases' ranks from the checkout at `root`."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from pl_yolo_tpu_torch.ops.cuda import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    build.build(["nms_suppress", "topk_rows", "mosaic_warp", "simota_assign"])
    dev = torch.device("cuda", 0)
    for tag in ("parallel", "tpsp"):
        tmp = Path(tempfile.mkdtemp(prefix="chip_ranks_ab_"))
        try:
            t0 = time.perf_counter()
            ranks, refs, _ = cs.run_ranks(torch, tag, dev, tmp)
            cs.hold_ranks(torch, tag, ranks, refs)
            _, _, batch, runs = cs.RANK_RUNS[tag]
            for name, _, _, bf16_steps in runs:
                for what in ("", " bf16") if bf16_steps else ("",):
                    s = ranks[0][name + what]["seconds"][1:]
                    print(f"[ab] {root.name} {tag} {name}"
                          f"{what or ' fp32'}: "
                          f"{batch / (sum(s) / len(s)):.2f} images/s, "
                          f"seconds {[round(x, 4) for x in s]}", flush=True)
            print(f"[ab] {root.name} {tag}: staged {ranks[0]['staged']}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: nothing to time", file=sys.stderr)
        return 1
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    if not trees or not all((t / "chip_smoke.py").exists() for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for t in trees:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", str(t)], check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(Path(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
