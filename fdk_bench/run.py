"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 -m fdk_bench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``),
and the mix names its driver (``drivers/<driver>.py``).  The driver
builds the program's inputs from ``--seed``, warms up every shape the
cell uses (set-up, ``setup_s``), measures for ``--seconds``, closes the
window, frees the program's state and holds what the timed path
produced to the plain reference (``reference/``).  With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, each read by ``metrics/<metric>.py`` from the run's
record; a metric whose reader finds nothing is left out.  The last line
of standard output is the result as JSON; the numbers compared close it
and standard error.  A run that finds no card, or fewer cards than the
cell asks for, exits 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()      # the process's start, as near as Python sees

import argparse               # noqa: E402
import contextlib             # noqa: E402
import gc                     # noqa: E402
import importlib.util         # noqa: E402
import json                   # noqa: E402
import logging                # noqa: E402
import os                     # noqa: E402
import shutil                 # noqa: E402
import subprocess             # noqa: E402
import sys                    # noqa: E402
import tempfile               # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch                  # noqa: E402

from .lib import trace as tr  # noqa: E402
from .reference.compare import judge  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "paris_tpu")


class NoCard(RuntimeError):
    """The run found no card, or fewer than the cell asks for."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str) -> str:
    """The file of configuration, mix or metric ``name``."""
    sub, ext = {"config": ("configs", ".json"), "traffic": ("traffic", ".json"),
                "metric": ("metrics", ".py"),
                "driver": ("drivers", ".py")}[kind]
    path = os.path.join(HERE, sub, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} {name!r} ({path})")
    return path


def load_module(kind: str, name: str):
    """A driver or metric reader, loaded from its file by name."""
    path = find(kind, name)
    sub = os.path.basename(os.path.dirname(path))
    spec = importlib.util.spec_from_file_location(
        f"fdk_bench.{sub}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules`` (whole names)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def process_written_bytes() -> Optional[int]:
    """``wchar`` of ``/proc/self/io``: bytes this process passed to
    write calls."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


class LogTap(logging.Handler):
    """Keeps the program's log records (message template and arguments,
    unformatted) for the drivers to read its stage timers from."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records: List[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


class Context:
    """What a driver gets: the cell's configuration and mix, the seed,
    the window's length, where the program runs, a work directory under
    ``TMPDIR``, and the run's record, into which the driver writes what
    the metric readers read."""

    def __init__(self, *, config: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, backend: str, device: torch.device,
                 workdir: str, control: Optional[str] = None):
        self.config, self.mix = config, mix
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.backend, self.device = backend, device
        self.workdir = workdir
        self.control = control
        self.record: Dict = {"trace": {}}
        self.written: Dict[str, int] = {}
        self.memory_peak: Optional[int] = None
        self.found_forbidden: List[str] = []
        self.numbers: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self._profilers: List = []
        self.log = LogTap()
        logger = logging.getLogger("paris_tpu_torch")
        logger.setLevel(logging.INFO)
        logger.addHandler(self.log)

    def close(self) -> None:
        logging.getLogger("paris_tpu_torch").removeHandler(self.log)

    def note(self, what: str) -> None:
        """A progress line on standard error, with the process's age."""
        print(f"fdk_bench: {time.perf_counter() - T0:8.2f} s  {what}",
              file=sys.stderr, flush=True)

    def path(self, name: str) -> str:
        """A directory ``name`` inside the run's work directory."""
        p = os.path.join(self.workdir, name)
        os.makedirs(p, exist_ok=True)
        return p

    def wrote(self, kind: str, nbytes: int) -> None:
        self.written[kind] = self.written.get(kind, 0) + int(nbytes)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_window(self) -> float:
        """End set-up: the card idle, every shape warmed up.  Returns the
        window's start on the host clock."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.perf_counter()
        self.record["setup_s"] = now - T0
        return now

    def close_window(self) -> None:
        """After the window's last work: read the device memory's peak,
        and which forbidden modules the process holds."""
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))
        self.found_forbidden = forbidden_modules()

    def warm_profiler(self) -> None:
        """Start and stop the profiler once, so that the traced window
        does not pay its first start (CUPTI's set-up)."""
        if self.trace:
            with self.profiler():
                self.sync()
            self._profilers.clear()

    @contextlib.contextmanager
    def profiler(self):
        """``torch.profiler`` over the enclosed region: host spans on
        every thread, and the card's kernels and copies.  The trace is
        read when the run ends (``read_traces``)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True))
        prof.start()
        try:
            yield prof
        finally:
            self.sync()
            prof.stop()
            self._profilers.append(prof)

    def read_traces(self) -> List[dict]:
        """The Chrome traces of the profiled regions, each written to the
        work directory, read back and deleted."""
        out = []
        for i, prof in enumerate(self._profilers):
            path = os.path.join(self.workdir, f"trace{i}.json")
            prof.export_chrome_trace(path)
            self.wrote("traces", os.path.getsize(path))
            out.append(load_json(path))
            os.remove(path)
        self._profilers.clear()
        return out


def run_cell(config: dict, mix: dict, metrics: List[dict], *, seed: int,
             seconds: float, trace: bool, backend: str, device,
             workdir: Optional[str] = None, control: Optional[str] = None
             ) -> dict:
    """Run a cell once and return its result (without printing it).
    ``metrics`` are the ``BENCHMARK.json`` entries this run reports."""
    device = torch.device(device)
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="fdk_bench-") if own else workdir
    ctx = Context(config=config, mix=mix, seed=seed, seconds=seconds,
                  trace=trace, backend=backend, device=device,
                  workdir=workdir, control=control)
    try:
        driver = load_module("driver", mix["driver"])
        driver.run(ctx)
        for t in ctx.read_traces():
            for key, span_name in driver.TRACE_WINDOWS.items():
                s = tr.summarize(t, span_name)
                if s is not None:
                    ctx.record["trace"][key] = s
    finally:
        ctx.close()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    correct, compared = judge(ctx.numbers, mix["limits"])
    correct = correct and ctx.failed == 0 and ctx.attempted > 0
    values = {}
    for m in metrics:
        reader = load_module("metric", m["name"])
        v = reader.read(ctx.record)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": ctx.memory_peak or 0}
    result = {"correct": bool(correct), "attempted": ctx.attempted,
              "failed": ctx.failed, "metrics": values, "device": dev}
    main_trace = ctx.record["trace"].get(next(iter(driver.TRACE_WINDOWS)))
    if trace and main_trace:
        dev["busy_s"] = main_trace["busy_s"]
        dev["window_s"] = main_trace["window_s"]
        result["breakdown"] = {"device_ops": main_trace["device_ops"],
                               "idle_gaps": main_trace["idle_gaps"]}
    result["written_bytes"] = dict(ctx.written,
                                   total=sum(ctx.written.values()))
    result["forbidden_modules"] = ctx.found_forbidden
    result["compared"] = compared
    return result


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` its
    per-layer metrics, else its end-to-end ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"fdk_bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fdk_bench: the cell needs {chips} card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    config = load_json(find("config", cell["config"]))
    mix = load_json(find("traffic", cell["traffic"]))
    card = power_limit()
    print(f"fdk_bench: {args.workload} seed {args.seed} on {card}",
          file=sys.stderr, flush=True)
    result = run_cell(config, mix, cell_metrics(bench, args.workload,
                                                bool(args.trace)),
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), backend="cuda",
                      device=torch.device("cuda", 0))
    result["card"] = card
    gc.collect()
    found = forbidden_modules()
    if found:
        print(f"fdk_bench: the process holds {found} once the window has "
              "closed; no result", file=sys.stderr)
        return 3
    w = result.pop("written_bytes")
    line = (f"fdk_bench: bytes written {w['total']} ({w}); wchar "
            f"{process_written_bytes()}")
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    result.pop("forbidden_modules")
    compared = result.pop("compared")
    result["compared"] = compared
    print(json.dumps(result), flush=True)
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
