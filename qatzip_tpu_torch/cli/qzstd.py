"""qzstd — zstd-format CLI via the LZ4S→zstd sequence bridge.

Parity reference: utils/qzstd.c + utils/qzstd_main.c: compression runs an
LZ4S_BK session whose output is post-processed by ``zstdCallBack`` into
standard zstd frames through ZSTD_compressSequences (utils/qzstd.c:211-278,
294-432); small inputs go straight to ZSTD_compressCCtx (:369-378);
decompression is plain zstd streaming (:434+). Options -d -h -L -o -C -r -P
(README.md:312-328), and --device {cuda,cpu} (default cuda). Counterpart
of ``qatzip_tpu/cli/qzstd.py``: the same flags, messages and exit codes.

Usage: python -m qatzip_tpu_torch.cli.qzstd [options] [files...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import params as P
from ..constants import QzError
from ..session import QzSession
from ..postproc import zstd_callback, zstd_compress, zstd_decompress
from . import add_device_arg, device_error

SRC_BUFF_LEN = 128 * 1024 * 1024
SMALL_INPUT = 1024  # direct-zstd threshold (utils/qzstd.c:369-378)


def _build_parser():
    p = argparse.ArgumentParser(prog="qzstd", add_help=False)
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-h", "--help", action="store_true")
    p.add_argument("-k", "--keep", action="store_true")
    p.add_argument("-f", dest="force", action="store_true")
    p.add_argument("-L", dest="level", type=int, default=1)
    p.add_argument("-o", dest="out_name", default=None)
    p.add_argument("-C", dest="chunk_sz", type=int, default=None)
    p.add_argument("-r", dest="req_cnt", type=int, default=None)
    p.add_argument("-P", dest="polling", default=None, choices=["busy"])
    add_device_arg(p)
    p.add_argument("files", nargs="*")
    return p


def _make_session(args) -> QzSession:
    params = P.get_defaults("lz4s")
    params.qzCallback = zstd_callback
    params.callback_external = {"level": args.level}
    params.common.comp_lvl = max(1, min(args.level, 12))
    if args.chunk_sz:
        params.common.hw_buff_sz = args.chunk_sz
    sess = QzSession(args.device)
    sess.setup_lz4s(params)
    return sess


def compress_file(args, in_name: str) -> int:
    out_name = args.out_name or in_name + ".zst"
    if os.path.exists(out_name) and not args.force:
        print(f"qzstd: {out_name} already exists; use -f", file=sys.stderr)
        return 1
    size = os.path.getsize(in_name)
    t0 = time.perf_counter()
    total_in = total_out = 0
    with open(in_name, "rb") as fin, open(out_name, "wb") as fout:
        if size < SMALL_INPUT:
            data = fin.read()
            out = zstd_compress(data, max(args.level, 1))
            total_in, total_out = len(data), len(out)
            fout.write(out)
        else:
            sess = _make_session(args)
            while True:
                buf = fin.read(SRC_BUFF_LEN)
                if not buf:
                    break
                out = sess.compress(buf)
                total_in += len(buf)
                total_out += len(out)
                fout.write(out)
    secs = time.perf_counter() - t0
    print(f"qzstd: {in_name}: {total_in} -> {total_out} bytes "
          f"({100*total_out/max(total_in,1):.1f}%) in {secs*1000:.0f} ms",
          file=sys.stderr)
    if not args.keep:
        os.unlink(in_name)
    return 0


def decompress_file(args, in_name: str) -> int:
    if not in_name.endswith(".zst"):
        print(f"qzstd: {in_name}: unknown suffix -- ignored", file=sys.stderr)
        return 1
    out_name = args.out_name or in_name[:-4]
    if os.path.exists(out_name) and not args.force:
        print(f"qzstd: {out_name} already exists; use -f", file=sys.stderr)
        return 1
    with open(in_name, "rb") as fin:
        data = fin.read()
    try:
        out = zstd_decompress(data)
    except (QzError, RuntimeError) as e:
        print(f"qzstd: {in_name}: {e}", file=sys.stderr)
        return 1
    with open(out_name, "wb") as fout:
        fout.write(out)
    if not args.keep:
        os.unlink(in_name)
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.help or not args.files:
        _build_parser().print_help()
        return 0
    if device_error("qzstd", args.device):
        return 1
    rc = 0
    for name in args.files:
        if not os.path.exists(name):
            print(f"qzstd: {name}: No such file or directory",
                  file=sys.stderr)
            rc = 1
            continue
        if args.decompress:
            rc |= decompress_file(args, name)
        else:
            rc |= compress_file(args, name)
    return rc


if __name__ == "__main__":
    sys.exit(main())
