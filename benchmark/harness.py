"""The benchmark's driver: one run of one cell, found by name.

Everything that belongs to one configuration, traffic mix, entry or
per-layer metric is a file of its own under the benchmark's folder,
found by the name that ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the published sizes (the source's keys);
- ``traffic/<mix>.json``: the mix's parameters, and the ``entry`` that
  drives it;
- ``drivers/<entry>.py``: a ``Driver(shape, traffic, seed, device)``
  whose construction is the set-up, with ``unit()`` (one step or call
  of the window), ``end_to_end(win)``, ``attempted(win)``,
  ``release()``, ``numbers(win)`` (the numbers that decide ``correct``)
  and ``control(win)`` (the program's numbers beside the control's);
- ``metrics/<metric>.py``: ``read(run)``, the metric's value or None;
- ``limits/<cell>.json``: the limit of each number the cell compares.

A run: set-up (``setup_s`` runs from the process's start to the end of
the driver's construction), the measured window (:func:`run_window`,
the one timing of every end-to-end rate), with ``trace`` the
traced segment after it, the peak memory, the program's state freed,
then the check against the plain reference, and the look for JAX.
"""

from __future__ import annotations

import ast
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
# Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "rocnrdma_tpu")
# ...and what the reference may not import besides: the program.
PROGRAM = "rocnrdma_tpu_torch"


@dataclasses.dataclass(frozen=True)
class Shape:
    """A configuration file's sizes under the names the yardstick uses."""

    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq_len: int
    rope_theta: float
    norm_eps: float
    dtype: str

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self):
        import torch

        return getattr(torch, self.dtype)


def shape_of(cfg: dict) -> Shape:
    shape = Shape(
        name=cfg["name"], vocab_size=cfg["vocab_size"],
        d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"],
        max_seq_len=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]), dtype=cfg["torch_dtype"])
    if shape.head_dim * shape.n_heads != shape.d_model:
        raise ValueError(f"{shape.name}: hidden_size is not a multiple of "
                         "num_attention_heads")
    return shape


class Bench:
    """The files of one benchmark folder and its ``BENCHMARK.json``
    (beside the folder)."""

    def __init__(self, folder: Path = BENCH) -> None:
        self.folder = Path(folder)
        self.root = self.folder.parent
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.folder / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.folder / "limits" / f"{cell}.json")
                          .read_text())

    def _module(self, kind: str, name: str):
        path = self.folder / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def driver(self, entry: str):
        return self._module("drivers", entry).Driver

    def reader(self, metric: str):
        return self._module("metrics", metric).read

    def metrics(self, kind: str, cell: str):
        """The ``end_to_end`` or ``per_layer`` entries this cell
        reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads."""

    shape: Shape
    traffic: dict
    window: dict
    trace: Optional[dict]


def run_window(unit, seconds: float) -> dict:
    """The measured window: ``unit()`` back to back until ``seconds``
    have passed since the window's start, each unit stamped with the
    time ``t`` at which it ended; ``elapsed`` runs to the end of the
    last unit."""
    units = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        units.append(unit())
        units[-1]["t"] = time.perf_counter() - t0
    return {"elapsed": time.perf_counter() - t0, "units": units}


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float,
             trace: bool, t0: float, device: str = "cuda",
             chips: int = 1, control: bool = False) -> dict:
    """One run of a cell, to its result (see the module's docstring).
    With ``control`` the check also reads the control and the planted
    faults (``Driver.control``), under the result's ``control``: the
    readings from which the cell's limits are set."""
    import torch

    from benchmark import trace as tracing

    cell = bench.cell(cell_name)
    shape = shape_of(bench.config(cell["config"]))
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(cell_name)
    bad = reference_imports(bench.folder)
    if bad:
        raise RuntimeError(f"the reference imports {bad}")
    cuda = torch.device(device).type == "cuda"
    t_drv = time.perf_counter()
    drv = bench.driver(traffic["entry"])(shape, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print("setup " + json.dumps({"before_driver": t_drv - t0,
                                 "driver": t0 + setup_s - t_drv}),
          file=sys.stderr)
    win = run_window(drv.unit, seconds)
    print("window " + json.dumps({
        "elapsed": win["elapsed"],
        "units": [[u["t"]] + [u[k] for k in ("b", "s", "p", "new") if k in u]
                  for u in win["units"]]}), file=sys.stderr)
    seg = None
    if trace:
        from rocnrdma_tpu_torch.ops import _native

        seg = tracing.run_segment(traffic["trace_units"], drv.unit,
                                  _native.launches, cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from benchmark.reference import compare

    readings = drv.control(win) if control else None
    numbers = readings["program"] if control else drv.numbers(win)
    correct, checks = compare.judge(numbers, limits)
    attempted, failed = drv.attempted(win)
    if trace:
        run = Run(shape, traffic, win, seg)
        metrics = {}
        for m in bench.metrics("per_layer", cell_name):
            value = bench.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(drv.end_to_end(win), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.metrics("end_to_end", cell_name)}
    result = {"correct": bool(correct and failed == 0),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name()
                                  if cuda else "cpu"),
                         "count": chips, "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=seg["busy_s"],
                                window_s=seg["window_s"])
        result["breakdown"] = tracing.breakdown(seg)
    if control:
        result["control"] = readings
    # Numbers read but held to no limit (PERF.md says why), then the
    # compared numbers beside their limits, last.
    result["readings"] = {k: finite(v) for k, v in numbers.items()
                          if k not in limits}
    result["checks"] = {k: {"value": finite(v), "limit": lim}
                        for k, v, lim in checks}
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def reference_imports(folder: Path = BENCH) -> list:
    """Imports of the reference (and of the benchmark modules it
    imports), read from their sources, whose top-level name is JAX's,
    the JAX package's or the program's."""
    seen, bad = set(), []
    todo = sorted((folder / "reference").glob("*.py"))
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            else:
                continue
            for name in names:
                parts = name.split(".")
                if parts[0] in FORBIDDEN + (PROGRAM,):
                    bad.append(f"{path.name}: {name}")
                elif parts[0] == "benchmark" and len(parts) > 1:
                    sub = folder.joinpath(*parts[1:])
                    for cand in (sub.with_suffix(".py"), sub / "__init__.py"):
                        if cand.exists():
                            todo.append(cand)
    return sorted(set(bad))


def emit(result: dict) -> int:
    """Print the checks as the last lines of standard error and the
    result as the last line of standard output; refuse (code 3, no
    result) where JAX or the JAX package was loaded."""
    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 3
    for k, v in result["readings"].items():
        print(f"reading {k} {v!r} (no limit)", file=sys.stderr)
    for k, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False))
    sys.stdout.flush()
    return 0


def finite(x: float) -> Optional[float]:
    """x, or None (JSON's null) where it is not a finite number."""
    return x if math.isfinite(x) else None
