"""The port's accuracy gate and profiler on the CPU: `pl_yolo_tpu_torch/
tools/make_shapes_dataset.py` writes the JAX package's data set byte for
byte; `tools/accuracy_gate.py` of the port assembles the configs and trainer
arguments the JAX gate (`tools/accuracy_gate.py`) builds, and refuses to
start without a card unless asked for the CPU; `utils/profiler.py` traces a
CPU step and times steps without their warm-up.

The JAX gate is run as its own program, in a child process whose `Trainer`
records its arguments and stops: its `main` writes to `GATE_RESULTS.jsonl`
and sets a compilation cache only after training, which never starts.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.tools import accuracy_gate as gate
from pl_yolo_tpu_torch.train.optim import build_optimizer
from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
from pl_yolo_tpu_torch.utils import profiler
from tests.test_torch_train import NUM_CLASSES, _batch, _tiny_cfg

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_port_shapes_dataset_is_byte_identical_to_the_jax_tools(tmp_path):
    """Both generators, each imported by its path: 4 + 3 hard images at
    64 px, the same JPEG bytes and the same annotations."""
    jax_tool = _load(ROOT / "tools" / "make_shapes_dataset.py",
                     "jax_make_shapes")
    port_tool = _load(ROOT / "pl_yolo_tpu_torch" / "tools"
                      / "make_shapes_dataset.py", "port_make_shapes")
    for split, n, seed in (("train", 4, 10), ("val", 3, 11)):
        jax_tool.make_split(tmp_path / "jax", split, n, 64, seed, hard=True)
        port_tool.make_split(tmp_path / "port", split, n, 64, seed,
                             hard=True)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 4 + 3 + 2
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    doc = json.loads((tmp_path / "port/annotations/instances_train.json")
                     .read_text())
    assert len(doc["categories"]) == 6 and doc["annotations"]


@pytest.fixture(scope="module")
def gate_root(tmp_path_factory):
    """A small hard-shapes set where the gate expects its own (the gates
    then skip their generation): 8 train and 4 val images at 64 px."""
    from pl_yolo_tpu_torch.tools.make_shapes_dataset import make_split
    root = tmp_path_factory.mktemp("shapes")
    make_split(root, "train", 8, 64, gate.GATE_SEED, hard=True)
    make_split(root, "val", 4, 64, gate.GATE_SEED + 1, hard=True)
    return root


# model, extra flags: the default recipe, and each flag that edits a config
GATE_CASES = [("yolox_tiny", []),
              ("yolov7_tiny", ["--autoanchor", "--balance", "reference"]),
              ("yolov5_s", ["--autoanchor", "--scale-gains", "--epochs",
                            "30"])]

_JAX_GATE_RUNNER = """
import json, runpy, sys
import pl_yolo_tpu.train.trainer as trainer_mod

class Stop(Exception):
    pass

class Recording:
    def __init__(self, model_cfg, data_cfg, **kw):
        print("GATE " + json.dumps([model_cfg, data_cfg, kw]), flush=True)
        raise Stop

trainer_mod.Trainer = Recording
for argv in json.loads(sys.argv[1]):
    sys.argv = ["tools/accuracy_gate.py"] + argv
    try:
        runpy.run_path("tools/accuracy_gate.py", run_name="__main__")
    except Stop:
        pass
"""


@pytest.fixture(scope="module")
def jax_gate_calls(gate_root, tmp_path_factory):
    """The Trainer arguments of the JAX gate for each case (one child
    process, JAX on the CPU, HOME in a temporary directory)."""
    home = tmp_path_factory.mktemp("home")
    argvs = [["--model", m, "--root", str(gate_root), *flags]
             for m, flags in GATE_CASES]
    env = dict(os.environ, HOME=str(home), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _JAX_GATE_RUNNER,
                          json.dumps(argvs)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    calls = [json.loads(line[len("GATE "):])
             for line in out.stdout.splitlines() if line.startswith("GATE ")]
    assert len(calls) == len(GATE_CASES)
    return calls


@pytest.mark.parametrize("case", range(len(GATE_CASES)),
                         ids=[m for m, _ in GATE_CASES])
def test_gate_builds_the_jax_gates_configs(case, gate_root, jax_gate_calls,
                                           monkeypatch, tmp_path):
    """The port's gate on the same flags hands `Trainer` the JAX gate's
    model and data configs (schedule, sizes, anchors, balance, gains) and
    arguments (epochs, validation cadence, logger, seed, name), plus the
    device; the floors and recipe lengths are the JAX gate's."""
    model, flags = GATE_CASES[case]
    seen = []

    class Recording:
        def __init__(self, model_cfg, data_cfg, **kw):
            seen.append([model_cfg, data_cfg, dict(kw, device=str(
                kw["device"]))])
            raise KeyboardInterrupt   # stop before training

    import pl_yolo_tpu_torch.train.trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, "Trainer", Recording)
    args = gate.argument_parser().parse_args(
        ["--model", model, "--root", str(gate_root), "--device", "cpu",
         "--results", str(tmp_path / "results.jsonl"), *flags])
    device, model_cfg, data_cfg = gate.prepare(args)
    with pytest.raises(KeyboardInterrupt):
        gate.run(args, device, model_cfg, data_cfg)
    got_model, got_data, got_kw = json.loads(json.dumps(seen[0]))
    want_model, want_data, want_kw = jax_gate_calls[case]
    assert got_model == want_model
    assert got_data == want_data
    assert got_kw.pop("device") == "cpu"
    for kw in (got_kw, want_kw):
        kw.pop("output_dir")
    assert got_kw == want_kw
    assert not (tmp_path / "results.jsonl").exists()
    jax_gate = _load(ROOT / "tools" / "accuracy_gate.py", "jax_gate")
    assert gate.DEFAULT_FLOORS == jax_gate.DEFAULT_FLOORS
    assert (gate.GATE_SIZE, gate.GATE_SEED) == (jax_gate.GATE_SIZE,
                                                 jax_gate.GATE_SEED)
    if "--autoanchor" in flags:
        assert got_model["loss"]["anchors"] != _config_anchors(model)


def _config_anchors(model):
    from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config
    return load_config(CONFIG_DIR / "model" / f"{model}.yaml")["loss"].get(
        "anchors")


def test_gate_refuses_to_start_without_a_card_unless_asked(gate_root,
                                                           tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    results = tmp_path / "results.jsonl"
    with pytest.raises(SystemExit, match="--device cpu"):
        gate.main(["--root", str(gate_root), "--results", str(results)])
    with pytest.raises(SystemExit) as exc:   # a flag the model cannot take
        gate.main(["--autoanchor", "--device", "cpu", "--root",
                   str(gate_root), "--results", str(results)])
    assert exc.value.code == 2
    assert not results.exists()


@pytest.mark.parametrize("keep", [False, True], ids=["temporary", "out"])
def test_gate_removes_only_its_temporary_run_directory(keep, gate_root,
                                                       monkeypatch,
                                                       tmp_path):
    """Without `--out` the run directory the fit writes its checkpoints
    and logs to is removed when the run ends; with it, it is kept. The
    result line is appended either way."""
    seen = []

    class Fitting:
        best_map, best_map50 = 0.3, 0.5

        def __init__(self, model_cfg, data_cfg, output_dir, **kw):
            self.output_dir = Path(output_dir)

        def fit(self):
            (self.output_dir / "checkpoints").mkdir(parents=True)
            (self.output_dir / "checkpoints" / "last.pt").write_bytes(b"0")
            seen.append(self.output_dir)

    import pl_yolo_tpu_torch.train.trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, "Trainer", Fitting)
    out = ["--out", str(tmp_path / "run")] if keep else []
    args = gate.argument_parser().parse_args(
        ["--root", str(gate_root), "--device", "cpu", "--results",
         str(tmp_path / "results.jsonl"), *out])
    result, _ = gate.run(args, *gate.prepare(args))
    assert result["pass"] and len(seen) == 1
    assert (seen[0] / "checkpoints" / "last.pt").exists() == keep
    assert (seen[0] == tmp_path / "run") == keep
    assert json.loads((tmp_path / "results.jsonl").read_text())["mAP"] == 0.3


def test_profiler_traces_a_cpu_step_and_the_timer_drops_the_first(tmp_path):
    """`trace` writes a Chrome trace holding the step's ops and the
    annotated region; `StepTimer` fences on a result and its mean leaves
    out the first (warm-up) time."""
    model = build_model(_tiny_cfg(), NUM_CLASSES, device="cpu")
    optimizer, _ = build_optimizer(model.module, model.cfg["optimizer"], 10)
    state = TrainState.create(model.module, optimizer)
    step = make_train_step(model.loss.train_loss)
    images, labels = (torch.from_numpy(a) for a in _batch())
    timer = profiler.StepTimer()
    for n in range(2):
        timer.start()
        losses = step(state, images, labels)
        timer.stop(losses["loss"])
    with profiler.trace(str(tmp_path / "prof")) as prof:
        with profiler.annotate("train_step"):
            losses = step(state, images, labels)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train_step" in names
    assert any("conv" in str(n) for n in names)
    assert any(e.key == "train_step" for e in prof.key_averages())
    assert len(timer.times) == 2 and all(t > 0 for t in timer.times)
    timer.times = [10.0, 1.0, 3.0]
    assert timer.mean == pytest.approx(2.0)
    timer.times = [4.0]
    assert timer.mean == pytest.approx(4.0)
    np.testing.assert_array_equal(np.isfinite(float(losses["loss"])), True)
