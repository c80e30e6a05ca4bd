"""The system under test: ``qatzip_tpu_torch.QzSession`` set up from a
configuration file, the program's counters that say which engine
served a request, and the launches its route makes."""

from __future__ import annotations

from typing import Dict


def make_session(cfg: Dict, device):
    """A ``QzSession`` on ``device``, set up with the configuration's
    session parameters (``setup_deflate``, ``setup_lz4``, or
    ``setup_lz4s`` with the post-process that ``post_process`` names),
    built from the file alone and not from the program's defaults or
    settings files."""
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch import params as P
    from qatzip_tpu_torch.constants import DataFormat, HuffmanHdr
    s = dict(cfg["session"])
    sess = qz.QzSession(device=device)
    common = P.SessionParamsCommon(
        comp_lvl=s["comp_lvl"], hw_buff_sz=s["hw_buff_sz"],
        sw_backup=s["sw_backup"], input_sz_thrshold=s["input_sz_thrshold"])
    if cfg["algorithm"] == "deflate":
        rc = sess.setup_deflate(P.SessionParamsDeflate(
            common=common, huffman_hdr=HuffmanHdr[s["huffman_hdr"]],
            data_fmt=DataFormat[s["data_fmt"]]))
    elif cfg["algorithm"] == "lz4":
        rc = sess.setup_lz4(P.SessionParamsLZ4(common=common))
    elif cfg["algorithm"] == "lz4s":
        from qatzip_tpu_torch import postproc
        rc = sess.setup_lz4s(P.SessionParamsLZ4S(
            common=common, lz4s_mini_match=s["lz4s_mini_match"],
            qzCallback=postproc.zstd_callback,
            callback_external=post_process(cfg)))
    else:
        raise ValueError(f"unknown algorithm {cfg['algorithm']!r}")
    if rc != 0:
        raise RuntimeError(f"session set-up refused the parameters (rc {rc})")
    return sess


def post_process(cfg: Dict) -> Dict:
    """The ``callback_external`` of the post-process that an ``lz4s``
    configuration's ``post_process`` names: ``{"kind": "zstd", "level":
    n}`` is qzstd's ``zstdCallBack``, one zstd frame a block at zstd
    level ``n``. A bare LZ4s block stream is only a post-process's
    input, which no reader judges, so a configuration without one is
    refused."""
    pp = cfg.get("post_process")
    if not isinstance(pp, dict) or pp.get("kind") != "zstd":
        raise ValueError("an lz4s configuration needs a post_process "
                         "({\"kind\": \"zstd\", \"level\": n}): a bare LZ4s "
                         "block stream is only a post-process's input")
    return {"level": int(pp["level"])}


def reference_format(cfg: Dict) -> str:
    """The reference's reader for the configuration's output."""
    if cfg["algorithm"] == "lz4":
        return "lz4_frame"
    if cfg["algorithm"] == "lz4s":
        post_process(cfg)
        return "zstd_frames"
    if cfg["session"].get("data_fmt") == "DEFLATE_GZIP_EXT":
        return "gzip_ext"
    raise ValueError("the reference reads gzip-ext, LZ4 and zstd frames "
                     "only")


def engine_counts() -> Dict[str, int]:
    """The program's service counters summed over its threads
    (``hw_compress``, ``sw_compress``, ``cnv_fallback``, ...) and each
    hand kernel's launches (``ops/cuda_pack.LAUNCHES``), as
    ``launches.<kernel>``."""
    from qatzip_tpu_torch.ops import cuda_pack
    from qatzip_tpu_torch.utils.debug import get_counters
    total: Dict[str, int] = {}
    for per_thread in get_counters().snapshot().values():
        for k, v in per_thread.items():
            total[k] = total.get(k, 0) + v
    with cuda_pack._count_lock:
        for k, v in cuda_pack.LAUNCHES.items():
            total[f"launches.{k}"] = v
    return total


def route_launches(cfg: Dict, nbytes: int, cards: int) -> int:
    """The launches of each of the route's kernels (``route_kernels``)
    that a request of ``nbytes`` makes when every part of it is served on
    the cards: one row a ``hw_buff_sz`` chunk, the rows dealt over the
    cards in contiguous blocks as ``MeshEngine`` deals them, and each
    card launching the kernel once a tile of up to ``dispatch.TILE_B`` of
    its rows. The tile size is read from the program: it is its
    granularity, not a guess."""
    from qatzip_tpu_torch.parallel import dispatch
    hw = cfg["session"]["hw_buff_sz"]
    if hw > dispatch.DEV_MAX:
        raise ValueError("chunks over the tokenizer's reach take other "
                         "rows or routes; the route check has no rule "
                         "for them")
    rows = max(1, -(-nbytes // hw))
    cuts = [d * rows // cards for d in range(cards + 1)]
    return sum(-(-(hi - lo) // dispatch.TILE_B)
               for lo, hi in zip(cuts, cuts[1:]))
