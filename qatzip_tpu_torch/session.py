"""The compression session and the rc-returning qz* API.

Counterpart of ``qatzip_tpu/session.py`` (``QzSession_T``, the setup
family qzSetupSession{,Deflate,LZ4,LZ4S} src/qatzip.c:1027-1202,
qzTeardownSession / qzClose, qzCompress[Crc] and qzDecompress
:1997-2255, :2812-2997, qzMaxCompressedLength). The session takes the
torch device it runs on: ``"cuda"`` (the default: every visible card),
``"cuda:i"``, a list of devices, or ``"cpu"``, which runs the kernels'
plain versions. An LZ4s session runs its post-process
callback (for example ``postproc.zstd_callback``) on each compressed
request.

``compress_batch`` compresses many requests in one engine dispatch (the
async engine's batching). Two styles, as in the JAX package:
``session.compress(data) -> bytes`` raising QzError, and module-level
wrappers such as ``qz_compress(sess, src, dst) -> (rc, consumed,
produced)`` that return the reference's return codes.
"""

from __future__ import annotations

import copy
import threading
import zlib
from typing import Optional, Tuple

from . import codec as _codec
from . import params as P
from .bounds import max_compressed_length as _maxlen
from .constants import (API_VERSION, DataFormat, Direction, HuffmanHdr,
                        QZ_AUTO_SELECT_BEST, QZ_BUF_ERROR, QZ_OK, QZ_PARAMS,
                        QZ_POST_PROCESS_ERROR, QzError, SessionState)
from .engines import host_engine
from .ops.checksum import crc32_combine
from .runtime import get_runtime


class QzSession:
    """A compression session on a torch device (``"cuda"``: every visible
    card; ``"cuda:i"``, ``"cpu"``, or a list of devices: the runtime's
    ``resolve_device``)."""

    def __init__(self, device="cuda"):
        self._engine = get_runtime().get_engine(device)
        # the engine's devices (several where ``device`` names several:
        # runtime.resolve_device); ``device`` is the first
        self.devices = self._engine.devices
        self.device = self._engine.device
        self.state = SessionState.QZ_NONE
        self.params = None
        self.algorithm = "deflate"
        self.data_fmt = DataFormat.DEFLATE_GZIP_EXT
        self.huffman_hdr = HuffmanHdr.DYNAMIC_HDR
        self.mini_match = 3
        self.qz_callback = None
        self.qz_callback_external = None
        self.total_in = 0
        self.total_out = 0
        self.crc32 = 0
        # the totals and the running crc, which threads sharing the
        # session (the async workers) update
        self._totals_lock = threading.Lock()
        self._legacy_api = False

    # -- setup ---------------------------------------------------------------

    def _setup(self, params, algorithm: str, legacy: bool = False) -> int:
        rc = params.check()
        if rc != QZ_OK:
            return rc
        self.params = copy.deepcopy(params)
        self.algorithm = algorithm
        self.state = SessionState.QZ_SETUP_SW
        self._legacy_api = legacy
        return QZ_OK

    @property
    def common(self) -> P.SessionParamsCommon:
        if isinstance(self.params, P.SessionParams):
            return self.params.to_deflate().common
        return self.params.common

    def setup(self, params: Optional[P.SessionParams] = None) -> int:
        """qzSetupSession, the legacy deflate-only setup: level 9 goes to
        software zlib (src/qatzip.c:2101-2103)."""
        params = params or P.get_defaults("legacy")
        rc = self._setup(params, "deflate", legacy=True)
        if rc == QZ_OK:
            self.data_fmt = params.data_fmt
            self.huffman_hdr = params.huffman_hdr
        return rc

    def setup_deflate(self, params: P.SessionParamsDeflate = None) -> int:
        """qzSetupSessionDeflate: validate and adopt ``params``. Returns
        QZ_OK or QZ_PARAMS."""
        params = params or P.get_defaults("deflate")
        rc = self._setup(params, "deflate")
        if rc == QZ_OK:
            self.data_fmt = params.data_fmt
            self.huffman_hdr = params.huffman_hdr
        return rc

    def setup_lz4(self, params: P.SessionParamsLZ4 = None) -> int:
        """qzSetupSessionLZ4: LZ4 frames of 64 KiB blocks."""
        rc = self._setup(params or P.get_defaults("lz4"), "lz4")
        if rc == QZ_OK:
            self.data_fmt = DataFormat.LZ4
        return rc

    def setup_lz4s(self, params: P.SessionParamsLZ4S = None) -> int:
        """qzSetupSessionLZ4S: LZ4s block streams, handed to the params'
        ``qzCallback`` when it is set."""
        params = params or P.get_defaults("lz4s")
        rc = self._setup(params, "lz4s")
        if rc == QZ_OK:
            self.data_fmt = DataFormat.LZ4S
            self.mini_match = params.lz4s_mini_match
            self.qz_callback = params.qzCallback
            self.qz_callback_external = params.callback_external
        return rc

    def teardown(self) -> int:
        """qzTeardownSession: drop the params; the next request sets up
        the deflate defaults again."""
        self.state = SessionState.QZ_NONE
        self.params = None
        return QZ_OK

    def close(self) -> int:
        """qzClose."""
        return self.teardown()

    def _ready(self) -> P.SessionParamsCommon:
        """The session's common params, after the lazy default setup
        (qzCompressCrcExt sets a session up on first use,
        src/qatzip.c:2056-2077)."""
        if self.params is None:
            self.setup_deflate()
        self.state = SessionState.QZ_SETUP_HW
        return self.common

    # -- compress and decompress ------------------------------------------------

    def compress(self, data, last: bool = True, with_crc: bool = False):
        """Compress ``data`` to framed output (bytes, or (bytes, crc32)
        with ``with_crc``); updates the session totals and running crc.
        Every request is framed whole, so ``last`` changes nothing, as in
        the JAX package. An LZ4s session with a callback returns the
        callback's output (reference src/qatzip.c:2217-2249); a callback
        that fails raises QZ_POST_PROCESS_ERROR."""
        c = self._ready()
        if c.direction == Direction.DIR_DECOMPRESS:
            raise QzError(QZ_PARAMS, "session is decompress-only")
        data = bytes(data)
        legacy_sw = self._legacy_api and c.comp_lvl == 9
        out, crc = _codec.compress_buffer(
            data, algorithm=self.algorithm, data_fmt=self.data_fmt,
            level=c.comp_lvl, hw_buff_sz=c.hw_buff_sz,
            engine=None if legacy_sw else self._engine,
            sw_backup=c.sw_backup,
            input_sz_thrshold=c.input_sz_thrshold, mini_match=self.mini_match,
            huffman_static=self.huffman_hdr == HuffmanHdr.STATIC_HDR)
        if self.algorithm == "lz4s" and self.qz_callback is not None:
            try:
                out = self.qz_callback(self.qz_callback_external, data, out,
                                       self.mini_match)
            except Exception as e:  # noqa: BLE001 (any callback failure)
                raise QzError(QZ_POST_PROCESS_ERROR, str(e)) from None
        self._count(len(data), len(out), crc)
        return (out, crc) if with_crc else out

    def compress_batch(self, datas):
        """Compress many independent requests in ONE engine dispatch
        (the async engine's batching, src/qatzip.c:3578-3652): the
        batchable requests' chunks go to one ``compress_chunks`` call per
        row width (``codec.compress_buffers``) and each request is framed
        on its own. Returns [(out, crc32), ...] in order; each request's
        bytes are ``compress``'s.

        Requests under ``input_sz_thrshold`` go to software one at a
        time, as ``compress`` sends them. With no request at or over it,
        with ``QZ_AUTO_SELECT_BEST`` (a per-request pick) or an LZ4s
        callback, every request goes through ``compress``. A legacy
        level 9 session batches through the host engine."""
        c = self._ready()
        if c.direction == Direction.DIR_DECOMPRESS:
            raise QzError(QZ_PARAMS, "session is decompress-only")
        datas = [bytes(d) for d in datas]
        batchable = [i for i, d in enumerate(datas)
                     if len(d) >= c.input_sz_thrshold]
        if (not batchable or c.sw_backup == QZ_AUTO_SELECT_BEST
                or (self.algorithm == "lz4s"
                    and self.qz_callback is not None)):
            return [self.compress(d, with_crc=True) for d in datas]
        engine = (host_engine if self._legacy_api and c.comp_lvl == 9
                  else self._engine)
        results = [self.compress(d, with_crc=True)
                   if len(d) < c.input_sz_thrshold else None for d in datas]
        batch = _codec.compress_buffers(
            [datas[i] for i in batchable], algorithm=self.algorithm,
            data_fmt=self.data_fmt, level=c.comp_lvl,
            hw_buff_sz=c.hw_buff_sz, engine=engine,
            mini_match=self.mini_match,
            huffman_static=self.huffman_hdr == HuffmanHdr.STATIC_HDR)
        for i, (out, crc) in zip(batchable, batch):
            results[i] = (out, crc)
            self._count(len(datas[i]), len(out), crc)
        return results

    def decompress(self, data, max_out: Optional[int] = None,
                   return_consumed: bool = False):
        """qzDecompress: decode the session's framing, verifying each
        member's or frame's checksum; (out, bytes consumed) with
        ``return_consumed``. ``max_out`` bounds the gzip-ext walk as
        ``codec.decompress_buffer`` says."""
        if self._ready().direction == Direction.DIR_COMPRESS:
            raise QzError(QZ_PARAMS, "session is compress-only")
        out, consumed, _crc = _codec.decompress_buffer(
            bytes(data), data_fmt=self.data_fmt, algorithm=self.algorithm,
            max_out=max_out, engine=self._engine)
        self._count(consumed, len(out))
        return (out, consumed) if return_consumed else out

    def _count(self, nin: int, nout: int, crc: Optional[int] = None) -> None:
        """Add a request to the totals (and, for a compress, its crc to
        the running crc)."""
        with self._totals_lock:
            self.total_in += nin
            self.total_out += nout
            if crc is not None:
                self.crc32 = crc32_combine(self.crc32, crc, nin)

    def max_compressed_length(self, src_sz: int) -> int:
        """qzMaxCompressedLength for this session's algorithm, framing and
        chunk size (``bounds.py``)."""
        hw = (self.common.hw_buff_sz if self.params is not None
              else P.SessionParamsCommon().hw_buff_sz)
        return _maxlen(src_sz, algorithm=self.algorithm,
                       data_fmt=self.data_fmt, hw_buff_sz=hw)


# ---------------------------------------------------------------------------
# The rc-returning wrappers
# ---------------------------------------------------------------------------

def qz_init(sess: Optional[QzSession], sw_backup: int = 1) -> int:
    """qzInit for the session's device (the default device without one):
    QZ_OK, QZ_DUPLICATE, QZ_NO_HW or QZ_NOSW_NO_HW (``Runtime.init``)."""
    return get_runtime().init(sess.devices if sess is not None else "cuda",
                              sw_backup)


def qz_setup_session(sess: QzSession, params=None) -> int:
    return sess.setup(params)


def qz_setup_session_deflate(sess: QzSession, params=None) -> int:
    return sess.setup_deflate(params)


def qz_setup_session_lz4(sess: QzSession, params=None) -> int:
    return sess.setup_lz4(params)


def qz_setup_session_lz4s(sess: QzSession, params=None) -> int:
    return sess.setup_lz4s(params)


def qz_teardown_session(sess: QzSession) -> int:
    return sess.teardown()


def qz_close(sess: QzSession) -> int:
    return sess.close()


def qz_compress(sess: QzSession, src, dst: Optional[bytearray] = None,
                last: int = 1) -> Tuple[int, int, int]:
    """qzCompress into a buffer: (rc, consumed, produced).

    When ``dst`` is too small, the member framings still consume the
    whole ``hw_buff_sz`` chunks whose members fit and report QZ_BUF_ERROR
    with that progress; the reference's callers retry from there
    (utils/qzip.c:333-365). The session totals count only what was
    consumed (src/qatzip.c:2206-2215)."""
    src_b = bytes(src)
    try:
        out = sess.compress(src_b, last=bool(last))
    except QzError as e:
        return e.rc, 0, 0
    if dst is None:
        return QZ_OK, len(src_b), len(out)
    if len(out) <= len(dst):
        dst[:len(out)] = out
        return QZ_OK, len(src_b), len(out)
    if sess.data_fmt not in (DataFormat.DEFLATE_GZIP_EXT,
                             DataFormat.DEFLATE_GZIP, DataFormat.DEFLATE_4B):
        return QZ_BUF_ERROR, 0, 0
    from .formats.gzip_format import scan_members
    hw = sess.common.hw_buff_sz
    produced = consumed = 0
    for m in scan_members(out, sess.data_fmt):
        if produced + m.total_sz > len(dst):
            break
        produced += m.total_sz
        consumed += min(hw, len(src_b) - consumed)
    if produced:
        dst[:produced] = out[:produced]
    sess._count(consumed - len(src_b), produced - len(out))
    return QZ_BUF_ERROR, consumed, produced


def qz_compress_crc(sess: QzSession, src, last: int = 1
                    ) -> Tuple[int, bytes, int]:
    """qzCompressCrc: (rc, out, crc32 of src)."""
    try:
        out, crc = sess.compress(src, last=bool(last), with_crc=True)
        return QZ_OK, out, crc
    except QzError as e:
        return e.rc, b"", 0


def qz_decompress(sess: QzSession, src, dst: Optional[bytearray] = None
                  ) -> Tuple[int, int, int]:
    """qzDecompress into a buffer: (rc, consumed, produced); QZ_BUF_ERROR
    with nothing consumed when ``dst`` is too small."""
    try:
        out, consumed = sess.decompress(src, return_consumed=True)
    except QzError as e:
        return e.rc, 0, 0
    if dst is None:
        return QZ_OK, consumed, len(out)
    if len(out) > len(dst):
        return QZ_BUF_ERROR, 0, 0
    dst[:len(out)] = out
    return QZ_OK, consumed, len(out)


def qz_max_compressed_length(src_sz: int,
                             sess: Optional[QzSession] = None) -> int:
    if sess is not None:
        return sess.max_compressed_length(src_sz)
    return _maxlen(src_sz)


def qz_get_software_component_version_list() -> list:
    """qzGetSoftwareComponentVersionList: the port's own components (the
    reference's returns QZ_FAIL, src/qatzip.c:3406-3437)."""
    import torch

    from . import __version__, native
    from .ops import cuda_pack
    return [
        {"name": "qatzip_tpu_torch", "version": __version__,
         "api": API_VERSION},
        {"name": "zlib", "version": zlib.ZLIB_VERSION},
        {"name": "torch", "version": torch.__version__},
        {"name": "cuda", "version": torch.version.cuda or "none"},
        {"name": "qztorch_kernels",
         "version": "loaded" if cuda_pack._ext is not None else "not built"},
        {"name": "qztorch_native",
         "version": "loaded" if native._lib is not None else "not built"},
    ]


def qz_get_software_component_count() -> int:
    """qzGetSoftwareComponentCount."""
    return len(qz_get_software_component_version_list())


def qz_get_status(sess: Optional[QzSession]) -> dict:
    """qzGetStatus: the runtime's and the session's state (the
    reference's is a stub, src/qatzip.c:3062-3069)."""
    import torch
    rt = get_runtime()
    device = sess.device if sess is not None else None
    return {
        "initialized": device is not None and rt.initialized(sess.devices),
        "hw_available": torch.cuda.is_available(),
        "platform": device.type if device is not None else None,
        "n_devices": torch.cuda.device_count(),
        "gen4": False,
        "session_state": sess.state.name if sess else None,
        "total_in": sess.total_in if sess else 0,
        "total_out": sess.total_out if sess else 0,
    }
