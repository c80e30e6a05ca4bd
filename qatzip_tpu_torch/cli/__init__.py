"""The command-line tools: qzip (gzip workalike), qzstd (lz4s -> zstd)
and aqzip (async). Each runs on the GPU unless ``--device cpu`` is given;
without a GPU and without it, each fails with the runtime's error."""

from __future__ import annotations

import sys

from ..constants import QzError


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="run on the GPU (the default) or the CPU")


def device_error(prog: str, device: str) -> bool:
    """Bring up ``device``'s engine; print the runtime's error and return
    True when there is none (no GPU and no ``--device cpu``)."""
    from ..runtime import get_runtime
    try:
        get_runtime().get_engine(device)
    except QzError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return True
    return False
