"""Multi-process chunk distribution on ``torch.distributed``.

Counterpart of ``qatzip_tpu/parallel/multihost.py``. The reference scales
by N processes x M threads on one node, the perf harness summing the
processes' Gbps (test/performance_tests/run_perf_test.sh:53-125). Here
``torch.distributed`` (the gloo backend, which runs on any host) brings
the processes up; each compresses the chunk stripe it owns on its local
engine, and a coordinator interleaves the stripes back into submission
order. Chunks are striped round-robin (``chunks[rank::world]``) so a
file's tail does not load one process.

``init_distributed`` reads no variable of its own: with no arguments it
takes torch's ``env://`` rendezvous (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) when ``WORLD_SIZE`` is set.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the process group (idempotent). Returns (rank, world size).

    With ``coordinator_address`` ("host:port" of rank 0), the group is
    ``init_process_group("gloo", init_method="tcp://...")`` with the given
    world size and rank; a world of one is a no-op. With no arguments it
    uses torch's ``env://`` rendezvous when ``WORLD_SIZE`` is set, and is
    otherwise a no-op returning (0, 1)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if (coordinator_address, num_processes, process_id) == (None,) * 3:
        if "WORLD_SIZE" not in os.environ:
            return 0, 1
        dist.init_process_group("gloo", init_method="env://")
        return dist.get_rank(), dist.get_world_size()
    if num_processes is not None and num_processes <= 1:
        return 0, 1
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("coordinator_address, num_processes and "
                         "process_id go together")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_stripe(num_items: int, pid: int, nprocs: int) -> List[int]:
    """Round-robin stripe of chunk indices owned by this host."""
    return list(range(pid, num_items, nprocs))


def compress_striped(chunks: Sequence[bytes], *, algorithm: str = "deflate",
                     level: int = 1, huffman_static: bool = False,
                     mini_match: int = 3, device="cuda"):
    """Compress this process's stripe of a global chunk list on the
    runtime's engine for ``device`` (``None``: the host engine, the
    software coder).

    Returns (stripe_indices, [(payload, crc32), ...]) for the chunks this
    process owns (rank and world size from ``torch.distributed`` when it
    is initialised, else (0, 1)). A coordinator interleaves the stripes
    back into global submission order (``interleave_stripes``): item i
    is ``stripes[i % world][i // world]``.
    The stripe is one engine request, so its row width follows its own
    longest chunk."""
    pid, nprocs = _rank_world()
    idx = host_stripe(len(chunks), pid, nprocs)
    mine = [chunks[i] for i in idx]
    if device is None:
        from ..engines import host_engine
        eng = host_engine
    else:
        from ..runtime import get_runtime
        eng = get_runtime().get_engine(device)
    results = eng.compress_chunks(mine, level=level, algorithm=algorithm,
                                  huffman_static=huffman_static,
                                  mini_match=mini_match)
    # the stripe crosses a process boundary (pickled): plain bytes
    return idx, [(bytes(p), c) for p, c in results]


def interleave_stripes(stripes: Sequence[Sequence], num_items: int) -> List:
    """Reassemble per-host stripe outputs into global submission order."""
    nprocs = len(stripes)
    out = [None] * num_items
    for pid, stripe in enumerate(stripes):
        for k, item in enumerate(stripe):
            out[pid + k * nprocs] = item
    return out
