"""run_perf_test: the multi-process throughput harness.

Counterpart of ``tools/run_perf_test.sh``, the analog of the reference's
``test/performance_tests/run_perf_test.sh`` (:53-125): start N processes
of ``python -m qatzip_tpu_torch.tools.qztest -m 4 -t T -l L -b B -D dir
-v --device D``, print their ``[INFO]`` lines, and sum every ``N Gbps``
field of those lines as the shell script's awk does (``gbps_sum``). On
one GPU the processes share the card. The device is ``--device`` (the
shell script's ``-s`` set QZTPU_FORCE_SW=1; here ``--device cpu`` runs
the kernels' plain versions on the host).

Usage: python -m qatzip_tpu_torch.tools.run_perf_test [-p 4] [-t 4]
       [-l 20] [-b 65536] [-D comp|decomp|both] [--device cuda|cpu]

Exit code 1 if any process failed or outlived ``--timeout``.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

from ..cli import add_device_arg
from ..constants import QzError
from ..runtime import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# awk's reading of a string as a number: its longest numeric prefix
_AWK_NUM = re.compile(r"\s*([+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?)")


def _awk_number(field: str) -> float:
    m = _AWK_NUM.match(field)
    return float(m.group(1)) if m else 0.0


def gbps_sum(lines) -> float:
    """The shell script's sum over its processes' logs: for each line
    holding ``[INFO]``, split at ", " (awk -F', '), and add every field
    holding " Gbps" with its first " Gbps" removed, read as awk reads a
    number."""
    total = 0.0
    for line in lines:
        if "[INFO]" not in line:
            continue
        for field in line.rstrip("\n").split(", "):
            if " Gbps" in field:
                total += _awk_number(field.replace(" Gbps", "", 1))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_perf_test",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("-p", dest="procs", type=int, default=4)
    ap.add_argument("-t", dest="threads", type=int, default=4)
    ap.add_argument("-l", dest="loops", type=int, default=20)
    ap.add_argument("-b", dest="block_sz", type=int, default=65536)
    ap.add_argument("-D", dest="direction", default="both",
                    choices=["comp", "decomp", "both"])
    ap.add_argument("--timeout", type=float, default=1800,
                    help="seconds to wait for each process")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)      # no GPU: fail before starting any
    except QzError as e:
        print(f"run_perf_test: {e}", file=sys.stderr)
        return 1

    print(f"[perf] {args.procs} procs x {args.threads} threads, "
          f"loops={args.loops} block={args.block_sz} dir={args.direction} "
          f"device={args.device}", flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "qatzip_tpu_torch.tools.qztest", "-m", "4",
           "-t", str(args.threads), "-l", str(args.loops),
           "-b", str(args.block_sz), "-D", args.direction, "-v",
           "--device", args.device]
    with tempfile.TemporaryDirectory(prefix="qztorch_perf_") as tmp:
        logs = [os.path.join(tmp, f"proc{i}.log")
                for i in range(1, args.procs + 1)]
        procs = []
        for log in logs:
            with open(log, "w") as out, open(log + ".err", "w") as err:
                procs.append(subprocess.Popen(cmd, stdout=out, stderr=err,
                                              env=env, cwd=REPO))
        rc = 0
        try:
            for proc in procs:
                if proc.wait(timeout=args.timeout) != 0:
                    rc = 1
        except subprocess.TimeoutExpired:
            rc = 1
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lines = []
        for log in logs:
            with open(log) as f:
                lines += [ln for ln in f if "[INFO]" in ln]
            if rc:
                with open(log + ".err") as f:
                    sys.stderr.write(f.read())
    sys.stdout.write("".join(lines))
    print(f"[perf] TOTAL: {gbps_sum(lines):.3f} Gbps across {args.procs} "
          f"processes")
    return rc


if __name__ == "__main__":
    sys.exit(main())
