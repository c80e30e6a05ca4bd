"""qzip — gzip-workalike CLI over the port's codec, on the GPU.

Behavior parity with the reference CLI (utils/qzip_main.c:38-200,
utils/qzip.c): compress/decompress files, directories (-R), and
stdin→stdout pipelines; suffix rules .gz/.7z/.lz4/.lz4s (utils/qzip.c
makeOutName, :545-637); per-file throughput/ratio stats (displayStats,
utils/qzip.c:138-169); options -A -d -f -h -H -k -V -L -C -O -r -R -o -P
and --device {cuda,cpu} (default cuda). Counterpart of
``qatzip_tpu/cli/qzip.py``: the same flags, messages, output names and
exit codes. A truncated zstd, LZ4s or 7z member reports
QZ_UNSUPPORTED_FMT, as in the JAX package.

Usage: python -m qatzip_tpu_torch.cli.qzip [options] [files...]
"""

from __future__ import annotations

import argparse
import os
import stat as statmod
import sys
import time
from typing import Optional

from .. import params as P
from ..constants import (QZ_DATA_ERROR, QZ_UNSUPPORTED_FMT, DataFormat,
                         Direction, HuffmanHdr, PollingMode, QzError)
from ..session import QzSession
from . import add_device_arg, device_error

SUFFIXES = {".gz", ".lz4", ".lz4s", ".7z", ".zst"}
SRC_BUFF_LEN = 512 * 1024 * 1024  # read granularity (utils/qzip.h:188)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qzip", add_help=False,
        description="Compress or decompress FILEs (GPU-accelerated).")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-h", "--help", action="store_true")
    p.add_argument("-k", "--keep", action="store_true",
                   help="keep (don't delete) input files")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-R", dest="recursive", action="store_true",
                   help="recurse into directories")
    p.add_argument("-A", dest="algorithm", default="deflate",
                   choices=["deflate", "lz4", "lz4s", "zstd"])
    p.add_argument("-H", dest="huffman", default="dynamic",
                   choices=["static", "dynamic"])
    p.add_argument("-O", dest="fmt", default=None,
                   choices=["gzip", "gzipext", "7z", "deflate_4B", "lz4",
                            "lz4s"])
    p.add_argument("-o", dest="out_name", default=None)
    p.add_argument("-L", dest="level", type=int, default=1)
    p.add_argument("-C", dest="chunk_sz", type=int, default=None)
    p.add_argument("-r", dest="req_cnt", type=int, default=None)
    p.add_argument("-f", dest="force", action="store_true")
    p.add_argument("-P", dest="polling", default=None, choices=["busy"])
    add_device_arg(p)
    p.add_argument("files", nargs="*")
    return p


_FMT_MAP = {
    "gzip": DataFormat.DEFLATE_GZIP,
    "gzipext": DataFormat.DEFLATE_GZIP_EXT,
    "7z": DataFormat.DEFLATE_RAW,
    "deflate_4B": DataFormat.DEFLATE_4B,
    "lz4": DataFormat.LZ4,
    "lz4s": DataFormat.LZ4S,
}


def _setup_session(args) -> QzSession:
    sess = QzSession(args.device)
    algo = args.algorithm
    fmt = _FMT_MAP[args.fmt] if args.fmt else None
    if algo in ("lz4",) or fmt == DataFormat.LZ4:
        params = P.get_defaults("lz4")
        _apply_common(params.common, args)
        sess.setup_lz4(params)
    elif algo in ("lz4s", "zstd") or fmt == DataFormat.LZ4S:
        params = P.get_defaults("lz4s")
        _apply_common(params.common, args)
        if algo == "zstd":
            from ..postproc import zstd_callback
            params.qzCallback = zstd_callback
        sess.setup_lz4s(params)
    else:
        params = P.get_defaults("deflate")
        params.huffman_hdr = (HuffmanHdr.STATIC_HDR if args.huffman == "static"
                              else HuffmanHdr.DYNAMIC_HDR)
        if fmt is not None:
            params.data_fmt = fmt
        _apply_common(params.common, args)
        sess.setup_deflate(params)
    return sess


def _apply_common(common, args):
    common.comp_lvl = args.level
    common.direction = (Direction.DIR_DECOMPRESS if args.decompress
                        else Direction.DIR_COMPRESS)
    if args.chunk_sz:
        common.hw_buff_sz = args.chunk_sz
    if args.req_cnt:
        common.req_cnt_thrshold = args.req_cnt
    if args.polling == "busy":
        common.polling_mode = PollingMode.BUSY_POLLING


def _display_stats(direction: str, in_sz: int, out_sz: int, secs: float):
    """displayStats analog (utils/qzip.c:138-169)."""
    mbit = in_sz * 8 / 1e6
    speed = mbit / secs if secs > 0 else 0.0
    print(f"Time taken:    {secs * 1000:9.0f} ms", file=sys.stderr)
    print(f"Throughput:    {speed:9.0f} Mbit/s", file=sys.stderr)
    if direction == "compress" and in_sz:
        ratio = in_sz / out_sz if out_sz else 0.0
        savings = 100.0 * (1 - out_sz / in_sz)
        print(f"Space Savings: {savings:9.1f} %", file=sys.stderr)
        print(f"Compression ratio: {ratio:.3f} : 1", file=sys.stderr)


def make_out_name(in_name: str, decompress: bool, fmt: Optional[str],
                  algorithm: str) -> Optional[str]:
    """Suffix rules (utils/qzip.c:545-637)."""
    if decompress:
        for suf in (".gz", ".lz4", ".lz4s", ".7z", ".zst"):
            if in_name.endswith(suf):
                return in_name[: -len(suf)]
        return None  # unknown suffix — refuse like gzip does
    if algorithm == "lz4" or fmt == "lz4":
        return in_name + ".lz4"
    if algorithm in ("lz4s",) or fmt == "lz4s":
        return in_name + ".lz4s"
    if algorithm == "zstd":
        return in_name + ".zst"
    if fmt == "7z":
        return in_name + ".7z"
    return in_name + ".gz"


def _detect_decomp_session(name: str, args) -> QzSession:
    """Pick decode algorithm from the file suffix."""
    if name.endswith(".lz4"):
        args.algorithm = "lz4"
    elif name.endswith(".lz4s"):
        args.algorithm = "lz4s"
    elif name.endswith(".zst"):
        args.algorithm = "zstd"
    else:
        args.algorithm = "deflate"
    return _setup_session(args)


def process_file(args, in_name: str) -> int:
    decompress = args.decompress
    out_name = args.out_name or make_out_name(
        in_name, decompress, args.fmt, args.algorithm)
    if out_name is None:
        print(f"qzip: {in_name}: unknown suffix -- ignored", file=sys.stderr)
        return 1
    if os.path.exists(out_name) and not args.force:
        print(f"qzip: {out_name} already exists; use -f to force",
              file=sys.stderr)
        return 1

    if decompress and in_name.endswith(".zst"):
        # zstd decode is a direct native path (utils/qzstd.c:434+)
        from ..postproc import zstd_decompress
        with open(in_name, "rb") as fin:
            try:
                out = zstd_decompress(fin.read())
            except QzError as e:
                # the JAX package's qzip lets this error out (exit 1)
                print(f"qzip: {in_name}: {e}", file=sys.stderr)
                return 1
        with open(out_name, "wb") as fout:
            fout.write(out)
        if not args.keep:
            os.unlink(in_name)
        return 0

    sess = (_detect_decomp_session(in_name, args) if decompress
            else _setup_session(args))

    st = os.stat(in_name)
    # block devices (reference sizes them with ioctl(BLKGETSIZE),
    # utils/qzip.c:279-286) stream through the same read loop; the device
    # node itself is never unlinked after compression
    is_blockdev = statmod.S_ISBLK(st.st_mode)
    total_in = total_out = 0
    t0 = time.perf_counter()
    try:
        with open(in_name, "rb") as fin, open(out_name, "wb") as fout:
            pending = b""
            while True:
                buf = pending + fin.read(SRC_BUFF_LEN - len(pending))
                pending = b""
                if not buf:
                    if total_in == 0 and not decompress:
                        # empty input still emits a valid empty member
                        # (34 bytes for gzipext, include/qatzip.h:1694)
                        out = sess.compress(b"")
                        total_out += len(out)
                        fout.write(out)
                    break
                if decompress:
                    out, consumed = sess.decompress(buf, return_consumed=True)
                    if consumed == 0:
                        # a recognized magic with no decodable member is a
                        # truncated/corrupt stream, not an unknown format
                        # (stock gzip: "unexpected end of file")
                        if buf[:2] == b"\x1f\x8b" or \
                                buf[:4] == b"\x04\x22\x4d\x18":
                            raise QzError(QZ_DATA_ERROR,
                                          f"{in_name}: unexpected end of "
                                          "input (truncated or corrupt "
                                          "member)")
                        raise QzError(QZ_UNSUPPORTED_FMT,
                                      f"{in_name}: not in a supported format")
                    pending = buf[consumed:]
                else:
                    out = sess.compress(buf)
                    consumed = len(buf)
                total_in += consumed
                total_out += len(out)
                fout.write(out)
    except QzError as e:
        print(f"qzip: {in_name}: {e}", file=sys.stderr)
        os.unlink(out_name)
        return 1
    secs = time.perf_counter() - t0
    _display_stats("decompress" if decompress else "compress",
                   total_in, total_out, secs)
    os.chmod(out_name, statmod.S_IMODE(st.st_mode))
    os.utime(out_name, (st.st_atime, st.st_mtime))
    if not args.keep and not is_blockdev:
        os.unlink(in_name)
    return 0


def process_dir(args, dirname: str) -> int:
    rc = 0
    for root, _dirs, files in os.walk(dirname):
        for f in sorted(files):
            path = os.path.join(root, f)
            if args.decompress:
                if not any(path.endswith(s) for s in SUFFIXES):
                    continue
            elif any(path.endswith(s) for s in SUFFIXES):
                continue
            rc |= process_file(args, path)
    return rc


def process_stream(args, fin, fout) -> int:
    """stdin→stdout pipeline (processStream analog, utils/qzip.c:773-881),
    with pending-input carry for multi-member decode."""
    sess = _setup_session(args)
    pending = b""
    chunk = 64 * 1024 * 1024
    while True:
        buf = pending + fin.read(chunk - len(pending))
        pending = b""
        if not buf:
            break
        if args.decompress:
            out, consumed = sess.decompress(buf, return_consumed=True)
            if consumed == 0:
                print("qzip: stdin: not in a supported format",
                      file=sys.stderr)
                return 1
            pending = buf[consumed:]
        else:
            out = sess.compress(buf)
        fout.write(out)
    fout.flush()
    return 0


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.help:
        parser.print_help()
        return 0
    if args.version:
        from .. import __version__
        from ..constants import API_VERSION
        print(f"qzip (qatzip_tpu_torch) {__version__}, API {API_VERSION}")
        return 0
    if args.decompress and args.fmt == "lz4s":
        print("Don't support lz4s decompression.", file=sys.stderr)
        return 1
    if device_error("qzip", args.device):
        return 1

    if not args.files:
        if sys.stdin.isatty():
            parser.print_help()
            return 0
        if sys.stdout.isatty() and not args.force and not args.decompress:
            print("qzip: compressed data not written to a terminal. "
                  "Use -f to force compression.\nFor help, type: qzip -h",
                  file=sys.stderr)
            return 1
        return process_stream(args, sys.stdin.buffer, sys.stdout.buffer)

    # 7z archive mode: N files/dirs → one archive
    if args.fmt == "7z" and not args.decompress:
        if not args.out_name:
            print("Should use '-o' to specify an output name", file=sys.stderr)
            return 1
        from ..formats.sevenzip import create_7z
        sess = _setup_session(args)
        t0 = time.perf_counter()
        total_in, total_out = create_7z(args.files, args.out_name, sess,
                                        recursive=True)
        _display_stats("compress", total_in, total_out,
                       time.perf_counter() - t0)
        return 0

    rc = 0
    for name in args.files:
        if name.endswith(".7z") and args.decompress:
            from ..formats.sevenzip import extract_7z
            try:
                extract_7z(name, ".")
            except QzError as e:
                print(f"qzip: {name}: {e}", file=sys.stderr)
                rc = 1
            continue
        if os.path.isdir(name):
            if args.recursive:
                rc |= process_dir(args, name)
            else:
                print(f"qzip: {name} is a directory -- ignored (use -R)",
                      file=sys.stderr)
                rc = 1
        elif os.path.exists(name):
            rc |= process_file(args, name)
        else:
            print(f"qzip: {name}: No such file or directory", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
