"""qatzip_tpu_torch — the PyTorch / CUDA port of qatzip_tpu.

The port runs DEFLATE (gzip, zlib, raw, 4B; levels 1-9), LZ4 and LZ4s
compression with the JAX package's device tokenizer and packers, bit for
bit, on an NVIDIA GPU: the LZ77 candidate search, the greedy parse, the
deflate bit-packer, the Huffman lookup and histogram and the LZ4 byte
packer are hand-written CUDA kernels (``ops/cuda_pack.py``); the token
route packs in the host C++ packer. LZ4s output goes to zstd through
``postproc.zstd_callback``. The session API carries the legacy setup,
``QZ_AUTO_SELECT_BEST`` and the rc-returning ``qz_*`` wrappers. Around
it: the stream API (``QzStream``), batches (``QzSession.compress_batch``),
the async API (``AQzSession``, ``aqz_init``), the buffer pool
(``qz_malloc``), the settings file (``config.py``), CRC64 and metadata
blocks (``crc64.py``), 7z archives (``formats/sevenzip.py``) and the
``qzip`` / ``qzstd`` / ``aqzip`` tools (``python -m
qatzip_tpu_torch.cli.qzip``). The probe tool ``python -m
qatzip_tpu_torch.tools.devprims`` times the card's primitives with four
more kernels (``ops/devprims.py``). The device legs beside the host
routes: the crc32 of full rows (``ops/crc32_mxu.py``) and the LZ4 decode's
chain resolution (``ops/lz4_decode.py``), each a hand-written kernel,
taken where ``CudaEngine`` routes to them; ``utils/trace.py`` traces with
torch.profiler. It imports torch and never jax or qatzip_tpu.

Quick start::

    import qatzip_tpu_torch as qz
    sess = qz.QzSession(device="cuda")     # or device="cpu"
    sess.setup_deflate()                   # or setup_lz4(), setup_lz4s()
    blob = sess.compress(data)            # gzip-ext members
    assert sess.decompress(blob) == data
"""

from .async_engine import (  # noqa: F401
    AQzSession, aqz_init, aqz_stop, AQZ_OK, AQZ_NO_SPACE, AQZ_STOPPED,
)
from .bounds import max_compressed_length  # noqa: F401
from .constants import (  # noqa: F401
    DataFormat, Direction, HuffmanHdr, PollingMode, CrcType, MemType,
    QzError, SessionState, rc_name,
    QZ_OK, QZ_DUPLICATE, QZ_FORCE_SW, QZ_PARAMS, QZ_FAIL, QZ_BUF_ERROR,
    QZ_DATA_ERROR, QZ_TIMEOUT, QZ_NO_HW, QZ_LOW_MEM, QZ_UNSUPPORTED_FMT,
    QZ_NOSW_NO_HW, QZ_NOT_SUPPORTED, QZ_OUT_OF_RANGE, QZ_POST_PROCESS_ERROR,
    QZ_SW_BACKUP_OFF, QZ_SW_BACKUP_ON, QZ_AUTO_SELECT_BEST, QZ_HW_BUFF_SZ,
)
from .convert import params_from_reference  # noqa: F401
from .crc64 import (  # noqa: F401
    Crc64, Crc64Config, Metadata, MetadataBlock,
    qz_set_session_crc64_config, qz_get_session_crc64_config,
    qz_compress_crc64, qz_decompress_crc64,
    qz_allocate_metadata, qz_metadata_block_read, qz_metadata_block_write,
    qz_compress_with_metadata,
)
from .memory import qz_malloc, qz_free, qz_mem_find_addr, BufferPool  # noqa: F401
from .ops.checksum import adler32, crc32, crc32_combine  # noqa: F401
from .ops.lz77 import lz77_tokenize  # noqa: F401
from .ops.xxhash import xxh32  # noqa: F401
from .params import (  # noqa: F401
    SessionParams, SessionParamsCommon, SessionParamsDeflate,
    SessionParamsLZ4, SessionParamsLZ4S, get_defaults, set_defaults,
)
from .postproc import zstd_callback  # noqa: F401
from .session import (  # noqa: F401
    QzSession,
    qz_init, qz_close,
    qz_setup_session, qz_setup_session_deflate, qz_setup_session_lz4,
    qz_setup_session_lz4s, qz_teardown_session,
    qz_compress, qz_compress_crc, qz_decompress,
    qz_max_compressed_length, qz_get_status,
    qz_get_software_component_count, qz_get_software_component_version_list,
)
from .stream import (  # noqa: F401
    QzStream, qz_compress_stream, qz_decompress_stream, qz_end_stream,
)

__version__ = "0.1.0"
