#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (corda_tpu_torch).
The cell's configuration, traffic and metrics are found by name
(spec.py). The run makes its inputs from the seed, warms every call
shape the cell uses, then drives corda_tpu_torch's signature
verification SPI in a closed loop for the window (loop.py). Once the
window has closed it reads the device's peak memory, frees the
program's state, and holds every answer against the plain reference
(check.py). With --trace 1 the window runs under torch.profiler and the
line carries the per-layer metrics and the breakdown; with --trace 0
the end-to-end ones.

The last lines on standard error are the numbers compared with their
limits; the last line on standard output is the result. Without a card
(or with fewer than the cell asks for) it prints no result and exits 2;
if jax, jaxlib, flax or the JAX package (corda_tpu) is loaded once the
window has closed, it names them and exits 3.

--control runs the control in the program's place (check.MemoControl),
which must come out as not correct; the driver never passes it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = frozenset({"jax", "jaxlib", "flax", "corda_tpu"})
WARM_ROUNDS = 2         # rounds of `in_flight` calls per caller before the window


def process_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    one thread for the CPU math libraries (the run is one process whose
    host work is single-threaded Python and C)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    build = root / "build"
    os.environ["CORDA_TPU_TORCH_KERNEL_STORE"] = "1"
    os.environ["CORDA_TPU_TORCH_KERNEL_DIR"] = str(build / "corda_tpu_torch")
    os.environ["CUDA_CACHE_PATH"] = str(build / "port_bench" / "cuda-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "port_bench" / "torch-extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "port_bench" / "triton-cache")
    os.environ["USE_FLAX"] = "0"


def banned_modules() -> list:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in BANNED})


def card_peak(device_name: str, sms: int):
    """{"imad_per_s", "bytes_per_s"} of the card from peaks.json, None
    for a card the table does not hold."""
    table = json.loads((ROOT / "port_bench" / "peaks.json").read_text())
    for part, peak in table.items():
        if part in device_name and peak["sms"] == sms:
            return {"imad_per_s": peak["imad_per_clk_per_sm"] * peak["sms"] * peak["sm_mhz"] * 1e6,
                    "bytes_per_s": peak["hbm_bytes_per_s"]}
    return None


def _chunks(layout: list, rows: list, max_batch: int) -> int:
    per_scheme = Counter(rows[i].scheme for i in layout)
    return sum(math.ceil(n / max_batch) for n in per_scheme.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             make_verifier=None, cell=None, t_start: float = T_START) -> tuple:
    """One run of cell `name`. Returns (result line as a dict, the
    numbers compared). Caller k drives `make_verifier(k)`, by default
    the program's verifier; the tests pass a stand-in, to plant faults,
    and `cell` (a spec.Cell at a size a CPU holds)."""
    from port_bench import check, imad, loop, spec, sut, traffic
    from port_bench import devtrace
    from port_bench.result import Run

    marks = [("start", t_start), ("imports", time.perf_counter())]
    cell = cell if cell is not None else spec.cell(name, ROOT)
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: (spec.reader(m["name"]), m["unit"]) for m in metrics}
    tr = traffic.build(seed, cell.config, cell.traffic)
    requests = sut.requests(tr.rows)
    calls = [[requests[i] for i in layout] for layout in tr.layouts]
    del requests
    marks.append(("inputs", time.perf_counter()))
    batch_sizes = cell.config["batch_sizes"]
    if make_verifier is None:
        def make_verifier(k):
            # caller k on card k of a cell that asks for several
            where = f"cuda:{k % cell.chips}" if device == "cuda" and cell.chips > 1 else device
            return sut.verifier(where, batch_sizes)
    verifiers = [make_verifier(k) for k in range(tr.callers)]

    import torch

    on_card = device.startswith("cuda") and torch.cuda.is_available()
    marks.append(("verifiers", time.perf_counter()))
    for _ in range(WARM_ROUNDS):
        for k, v in enumerate(verifiers):
            handles = [v.verify_batch_async(calls[(k + j) % len(calls)])
                       for j in range(tr.in_flight)]
            for h in handles:
                h.result()
                h.device_seconds()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities):     # the profiler's first start is slow
            verifiers[0].verify_batch_async(calls[0]).result()
        prof = profile(activities=activities)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm", t_start + setup_s))
    print("setup " + " ".join(f"{b[0]}_s {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)

    if prof is not None:
        prof.start()
    records = loop.run(verifiers, calls, seconds, tr.in_flight, traced=trace)
    if on_card:
        torch.cuda.synchronize()
    summary = None
    if prof is not None:
        prof.stop()
        summary = devtrace.summarise(prof.profiler.kineto_results.events())
        del prof
    memory_peak = max(torch.cuda.max_memory_allocated(d) for d in range(cell.chips)) if on_card else 0
    device_name = torch.cuda.get_device_name() if on_card else "cpu"
    sms = torch.cuda.get_device_properties(0).multi_processor_count if on_card else 0
    del verifiers, calls
    if on_card:
        torch.cuda.empty_cache()

    answers = check.reference_answers(tr.rows)
    numbers = check.compare(records, tr.layouts, answers)
    in_window = [c for c in records if c.in_window and c.error is None]
    max_batch = max(batch_sizes)
    run = Run(seconds=seconds, setup_s=setup_s, calls=in_window, all_calls=records,
              chunks=[_chunks(layout, tr.rows, max_batch) for layout in tr.layouts],
              trace=summary)
    if summary is not None:
        per_row = [imad.row_imad(r.scheme, r.key, r.signature, r.message) for r in tr.rows]
        run.imad = [sum(per_row[i] for i in layout) for layout in tr.layouts]
        run.bytes = [sum(imad.row_bytes(tr.rows[i].scheme) for i in layout)
                     for layout in tr.layouts]
        run.peak = card_peak(device_name, sms)
    values = {}
    for metric, (module, unit) in readers.items():
        value = module.read(run)
        if value is not None:
            values[metric] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": device_name, "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    result = {
        "correct": check.is_correct(numbers),
        "attempted": sum(c.rows for c in records),
        "failed": numbers["failed_rows"],
        "metrics": values,
        "device": dev,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    errors = sorted({c.error for c in records if c.error is not None})
    for e in errors[:5]:
        print(f"call failed: {e}", file=sys.stderr)
    result["check"] = check.record(numbers)
    return result, numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the control (check.MemoControl) in the program's place")
    args = p.parse_args(argv)
    process_env(ROOT)
    # the checkout's root in place of this script's directory, whose
    # module names (check, spec, loop, ...) must not shadow others
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))
    from port_bench import check, spec

    chips = spec.cell(args.workload, ROOT).chips
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible: no result", file=sys.stderr)
        return 2
    make = (lambda k: check.MemoControl()) if args.control else None
    result, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               make_verifier=make)
    found = banned_modules()
    if found:
        print(f"loaded once the window closed: {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(check.lines(numbers)) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
