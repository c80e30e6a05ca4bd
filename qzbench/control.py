"""The control: the plain reference put in the program's place with one
guarantee that the configuration states broken, which the comparison
that decides ``correct`` has to fail.

The system states no precision; the guarantee broken is the work a
faster program would be tempted to skip. For gzip-ext and LZ4 that is
the checksum: the control writes every gzip-ext member with stock zlib
at the session's level and a CRC32 of 0 in its footer, and every LZ4
frame with its blocks stored and an XXH32 content checksum of 0. qzstd's
zstd frames carry no checksum, so for an LZ4s session it is the
post-process itself: the control returns the session's own framing,
``[size:u32][LZ4s block]*`` with every block literals alone, and makes
no zstd frame. Everything else (framing, sizes, the payloads' bytes) is
right.

    python3 qzbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3

runs the control through the harness at the cell's own traffic, once a
seed, and prints each run's numbers (one JSON line a seed, then one with
the smallest reading of each number). The benchmark's own runs never run
it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import struct  # noqa: E402
import sys  # noqa: E402
import zlib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from qzbench import reference  # noqa: E402


def lz4s_literals(chunk: bytes) -> bytes:
    """An LZ4s block that holds ``chunk`` as one run of literals: the
    token's high nibble, the length's 255-byte extensions, the bytes."""
    n = len(chunk)
    if n < 15:
        return bytes([n << 4]) + chunk
    ext = n - 15
    return bytes([0xF0]) + b"\xff" * (ext // 255) + bytes([ext % 255]) + chunk


class ControlSession:
    """``compress`` as the configuration frames it, checksum left out."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.hw = cfg["session"]["hw_buff_sz"]
        self.level = cfg["session"]["comp_lvl"]

    def compress(self, data: bytes) -> bytes:
        chunks = reference.chunks_of(bytes(data), self.hw)
        if self.cfg["algorithm"] == "lz4s":
            return b"".join(struct.pack("<I", len(b)) + b
                            for b in map(lz4s_literals, chunks))
        if self.cfg["algorithm"] == "lz4":
            fd = struct.pack("<BBQ", 0x4C, 0x40, len(data))
            parts = [struct.pack("<I", reference.LZ4_MAGIC), fd,
                     bytes([(reference.xxh32(fd) >> 8) & 0xFF])]
            for c in chunks:
                parts += [struct.pack("<I", len(c) | reference.LZ4_STORED), c]
            parts.append(struct.pack("<II", 0, 0))   # content checksum 0
            return b"".join(parts)
        parts = []
        for c in chunks:
            z = zlib.compressobj(self.level, zlib.DEFLATED, -15)
            payload = z.compress(c) + z.flush()
            parts += [struct.pack("<BBBB4sBBH2sHII", 0x1F, 0x8B, 8, 4,
                                  b"\0" * 4, 0, 255, 12, b"QZ", 8, len(c),
                                  len(payload)),
                      payload, struct.pack("<II", 0, len(c))]  # CRC32 0
        return b"".join(parts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="run the control of a cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from qzbench import harness
    cell = harness.load_cell(args.workload)
    least = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks, info = harness.run_cell(
            cell, seed, args.seconds, False, t_process=time.perf_counter(),
            device="cpu", make_session=ControlSession, check_engine=False)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": checks}), flush=True)
        for k, v in checks.items():
            least[k] = min(least.get(k, v), v)
    print(json.dumps({"least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
