"""Run one cell of the benchmark once and print its result line.

    python3 qzbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It loads, warms up, measures for
``--seconds``, judges every answer against the plain reference, and
prints one JSON object as the last line of standard output (the numbers
compared, each beside its limit, are the last lines of standard error).
With ``--trace 1`` the metrics are the cell's per-layer ones. Without as
many CUDA cards as the cell asks for it exits with 2 and prints no
result; it never falls back to the CPU.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: glibc's ``mallopt`` parameters
M_TRIM_THRESHOLD, M_TOP_PAD, M_MMAP_MAX = -1, -2, -4


def steady_allocator() -> None:
    """Keep the memory that requests free inside the process: glibc's
    malloc maps no block of its own and gives no free memory back, so
    each request's host buffers (its output, the d2h fetches' pageable
    destinations) reuse pages that are already there instead of mapping,
    faulting in and unmapping fresh ones. Where mapping is slow and
    uneven, as in a sandboxed kernel, that churn set a run's pace apart
    from the program's own work. No byte of any answer changes."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(M_MMAP_MAX, 0)
    libc.mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1)
    libc.mallopt(M_TOP_PAD, 256 << 20)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    steady_allocator()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from qzbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"{args.workload} needs {cell.chips} CUDA card(s); "
                         f"{found} found\n")
        return 2
    result, checks, info = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), t_process=T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        sys.stderr.write(f"modules that no run may load were loaded: "
                         f"{', '.join(found)}\n")
        return 3
    line = harness.report(result, checks, info)
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
