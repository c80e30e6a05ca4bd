"""The port's CRC64, metadata blocks and 7z container against the JAX
package's, on the CPU.

The same inputs go through ``qatzip_tpu`` and ``qatzip_tpu_torch``
(``device="cpu"``): the same checksums, return codes, archive bytes and
extracted trees. Sessions that both packages drive take the software
route (``input_sz_thrshold`` above every request), so no JAX shape is
compiled; on the engine route the port is held to its own ``compress``.
The reader's BCJ, BCJ2, delta and LZMA chains and the hardened
extraction are checked on hand-made archives, as the JAX package's
``test_sevenzip_hardening.py`` and ``test_bcj2.py`` check its own copy.
"""

import ctypes
import gc
import lzma
import os
import struct
import zlib

import numpy as np
import pytest

import jax

from qatzip_tpu import crc64 as jcrc64
from qatzip_tpu import params as jparams
from qatzip_tpu import session as jsession
from qatzip_tpu.formats import sevenzip as jsz
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import crc64
from qatzip_tpu_torch.constants import (QZ_FAIL, QZ_OK, QZ_OUT_OF_RANGE,
                                        QZ_PARAMS, QzError)
from qatzip_tpu_torch.formats import sevenzip as sz

from tests.corpus import make_corpus
from tests.reference_native import require_reference_native


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Load the JAX package's native library first (the reference;
    tests/reference_native.py), and give what this module held back to the
    system when it ends (see test_torch_session.py)."""
    require_reference_native()
    yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


SW = 1 << 30
M64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def corpus():
    return make_corpus()


def _pair(**common):
    """A JAX and a port deflate session on the software route."""
    js, ps = jsession.QzSession(), qz.QzSession(device="cpu")
    jp, pp = jparams.SessionParamsDeflate(), qz.SessionParamsDeflate()
    for p in (jp, pp):
        p.common.input_sz_thrshold = SW
        for k, v in common.items():
            setattr(p.common, k, v)
    assert js.setup_deflate(jp) == ps.setup_deflate(pp) == QZ_OK
    return js, ps


# ---------------------------------------------------------------------------
# CRC64
# ---------------------------------------------------------------------------

CONFIGS = {
    "ecma": {},
    "xz": dict(initial_value=M64, reflect_in=True, reflect_out=True,
               xor_out=M64),
    "reflect-in-only": dict(polynomial=0x000000000000001B, reflect_in=True),
    "reflect-out-only": dict(polynomial=0x9A6C9329AC4BC9B5, initial_value=7,
                             reflect_out=True, xor_out=0x1234),
}


def test_crc64_check_vectors():
    assert qz.Crc64()(b"123456789") == 0x6C40DF5F0B497347   # CRC-64/ECMA-182
    xz = qz.Crc64(qz.Crc64Config(**CONFIGS["xz"]))
    assert xz(b"123456789") == 0x995DC9BBDF1939FA           # CRC-64/XZ


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 1000, 70001])
def test_crc64_matches_jax_and_the_python_loop(name, size):
    """The native slicing-by-8 route, the per-byte Python loop and the
    JAX package's Crc64 agree, from the initial value and from a running
    value."""
    data = np.random.default_rng(size).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    eng = qz.Crc64(qz.Crc64Config(**CONFIGS[name]))
    jeng = jcrc64.Crc64(jcrc64.Crc64Config(**CONFIGS[name]))
    init = eng.config.initial_value
    assert eng.compute(data) == eng._compute_py(data, init)
    assert eng(data) == jeng(data)
    assert eng.compute(data, 0xDEADBEEF) == jeng.compute(data, 0xDEADBEEF)
    half = size // 2
    assert eng.compute(data[half:], eng.compute(data[:half])) == eng.compute(
        data)


def test_session_crc64_config_matches_jax(corpus):
    data = corpus["text"][:50000]
    js, ps = _pair()
    out = []
    for mod, sess, fresh in ((qz, ps, qz.QzSession(device="cpu")),
                             (jcrc64, js, jsession.QzSession())):
        cfg = mod.qz_get_session_crc64_config(sess)
        rcs = [mod.qz_set_session_crc64_config(None, cfg),
               mod.qz_set_session_crc64_config(sess, None),
               mod.qz_set_session_crc64_config(fresh, cfg),
               mod.qz_set_session_crc64_config(
                   sess, mod.Crc64Config(polynomial=0)),
               mod.qz_set_session_crc64_config(
                   sess, mod.Crc64Config(**CONFIGS["xz"]))]
        errs = []
        for bad in (None, fresh):
            with pytest.raises(Exception) as e:
                mod.qz_get_session_crc64_config(bad)
            errs.append(e.value.rc)
        rc, blob, crc = mod.qz_compress_crc64(sess, data)
        drc, dec, dcrc = mod.qz_decompress_crc64(sess, blob)
        brc = mod.qz_decompress_crc64(sess, b"\x1f\x8b junk")
        out.append((cfg.polynomial, rcs, errs, rc, blob, crc, drc, dec,
                    dcrc, brc,
                    vars(mod.qz_get_session_crc64_config(sess))))
    assert out[0] == out[1]
    (poly, rcs, errs, rc, blob, crc, drc, dec, dcrc, brc, _cfg) = out[0]
    assert poly == 0x42F0E1EBA9EA3693
    assert rcs == [QZ_PARAMS, QZ_PARAMS, QZ_FAIL, QZ_PARAMS, QZ_OK]
    assert errs == [QZ_PARAMS, QZ_FAIL]
    assert rc == drc == QZ_OK and dec == data and crc == dcrc
    assert crc == qz.Crc64(qz.Crc64Config(**CONFIGS["xz"]))(data)
    assert brc[0] != QZ_OK


def test_compress_crc64_on_the_engine_route(corpus):
    data = corpus["json"][:100000]
    ps = qz.QzSession(device="cpu")
    ps.setup_deflate()
    rc, blob, crc = qz.qz_compress_crc64(ps, data)
    ref = qz.QzSession(device="cpu")
    ref.setup_deflate()
    assert (rc, blob, crc) == (QZ_OK, ref.compress(data), qz.Crc64()(data))
    assert qz.qz_decompress_crc64(ps, blob) == (QZ_OK, data, crc)


def test_metadata_matches_jax(corpus):
    """One block a chunk: offsets, sizes, flags and xxh32 of each plain
    chunk; read, write and their range errors."""
    data = corpus["text"][:200000]
    js, ps = _pair()
    out = []
    for mod, sess in ((qz, ps), (jcrc64, js)):
        md = mod.qz_allocate_metadata(len(data), 64 * 1024)
        rc, blob = mod.qz_compress_with_metadata(sess, data, md)
        blocks = [mod.qz_metadata_block_read(i, md)
                  for i in range(len(md.blocks))]
        w = [mod.qz_metadata_block_write(1, md, block_flags=0),
             mod.qz_metadata_block_write(9, md, block_flags=0),
             mod.qz_metadata_block_write(0, None),
             mod.qz_compress_with_metadata(sess, data, None)[0]]
        errs = []
        for call in (lambda: mod.qz_metadata_block_read(99, md),
                     lambda: mod.qz_metadata_block_read(0, None),
                     lambda: mod.qz_allocate_metadata(-1, 16),
                     lambda: mod.Metadata(0)):
            with pytest.raises(Exception) as e:
                call()
            errs.append(e.value.rc)
        out.append((rc, blob, blocks, w, errs,
                    mod.qz_metadata_block_read(1, md),
                    len(mod.qz_allocate_metadata(0, 4096).blocks)))
    assert out[0] == out[1]
    rc, blob, blocks, w, errs, after, nempty = out[0]
    assert rc == QZ_OK and len(blocks) == 4 and nempty == 1
    assert sum(b[1] for b in blocks) == len(blob)
    assert blocks[0][0] == 0 and all(b[2] == 1 for b in blocks)
    assert [b[3] for b in blocks] == [qz.xxh32(data[i * 65536:(i + 1) * 65536])
                                      for i in range(4)]
    assert w == [QZ_OK, QZ_OUT_OF_RANGE, QZ_PARAMS, QZ_PARAMS]
    assert errs == [QZ_OUT_OF_RANGE, QZ_PARAMS, QZ_PARAMS, QZ_PARAMS]
    assert after[2] == 0


# ---------------------------------------------------------------------------
# 7z: writer and reader
# ---------------------------------------------------------------------------

def _tree(root, corpus):
    (root / "sub").mkdir(parents=True)
    (root / "a.txt").write_bytes(corpus["text"][:60000])
    (root / "sub" / "b.bin").write_bytes(corpus["binary"][:30000])
    (root / "empty.txt").write_bytes(b"")
    (root / "noise").write_bytes(corpus["noise"][:20000])
    os.symlink("a.txt", root / "lnk")
    os.mkdir(root / "emptydir")
    t = 1_600_000_000
    for p in sorted(root.rglob("*"), reverse=True):
        os.utime(p, (t, t), follow_symlinks=False)


def _read_tree(root):
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p))
        elif p.is_dir():
            out[rel] = ("dir",)
        else:
            out[rel] = ("file", p.read_bytes())
    return out


@pytest.mark.parametrize("opts", [
    dict(), dict(folder_limit=40000), dict(encode_header=True),
    dict(session=True), dict(session=True, folder_limit=50000)],
    ids=["zlib", "folders", "encoded-header", "session", "session-folders"])
def test_7z_archive_matches_jax(tmp_path, corpus, opts):
    """The same tree gives the same archive bytes, listing and extracted
    tree in both packages (through a session on the software route, or
    zlib without one)."""
    opts = dict(opts)
    src = tmp_path / "src"
    _tree(src, corpus)
    js, ps = _pair()
    use_sess = opts.pop("session", False)
    arcs = []
    for mod, sess, tag in ((sz, ps, "p"), (jsz, js, "j")):
        arc = tmp_path / f"{tag}.7z"
        mod.create_7z([str(src)], str(arc), sess if use_sess else None, **opts)
        arcs.append(arc.read_bytes())
    assert arcs[0] == arcs[1]
    arc = tmp_path / "p.7z"
    assert sz.list_7z(str(arc)) == jsz.list_7z(str(arc))
    outs = []
    for mod, tag in ((sz, "po"), (jsz, "jo")):
        out = tmp_path / tag
        out.mkdir()
        mod.extract_7z(str(arc), str(out))
        outs.append(_read_tree(out / "src"))
    assert outs[0] == outs[1] == _read_tree(src)


def test_7z_through_the_engine_route(tmp_path, corpus):
    """An archive whose folders the port's engine compressed (raw DEFLATE
    through the session) extracts in both packages."""
    src = tmp_path / "src"
    _tree(src, corpus)
    ps = qz.QzSession(device="cpu")
    ps.setup_deflate()
    arc = tmp_path / "e.7z"
    sz.create_7z([str(src)], str(arc), ps, folder_limit=70000)
    for mod, tag in ((sz, "po"), (jsz, "jo")):
        out = tmp_path / tag
        mod.extract_7z(str(arc), str(out))
        assert _read_tree(out / "src") == _read_tree(src)


def test_7z_crc_detects_corruption_in_both(tmp_path):
    f = tmp_path / "x.dat"
    f.write_bytes(b"payload " * 5000)
    arc = tmp_path / "x.7z"
    sz.create_7z([str(f)], str(arc))
    blob = bytearray(arc.read_bytes())
    blob[40] ^= 0xFF
    arc.write_bytes(bytes(blob))
    for mod, cls in ((sz, QzError), (jsz, Exception)):
        with pytest.raises(cls):
            mod.extract_7z(str(arc), str(tmp_path / "o"))


def _write_archive(tmp_path, packed: bytes, hdr: bytes, name="a.7z"):
    start = struct.pack("<QQI", len(packed), len(hdr),
                        zlib.crc32(hdr) & 0xFFFFFFFF)
    arc = tmp_path / name
    with open(arc, "wb") as fh:
        fh.write(sz.MAGIC + sz.VERSION
                 + struct.pack("<I", zlib.crc32(start) & 0xFFFFFFFF) + start)
        fh.write(packed)
        fh.write(hdr)
    return arc


def _names(name):
    names = bytearray([0]) + name.encode("utf-16-le") + b"\x00\x00"
    return bytes([sz.K_NAME]) + sz.write_number(len(names)) + names


def _one_folder(packed, coders, unpack_sizes, crc=None, sub_crc=None,
                name="payload.bin", bind=b""):
    hdr = bytearray([sz.K_HEADER, sz.K_MAIN_STREAMS, sz.K_PACK_INFO])
    hdr += sz.write_number(0) + sz.write_number(1)
    hdr += bytes([sz.K_SIZE]) + sz.write_number(len(packed))
    hdr += bytes([sz.K_END, sz.K_UNPACK_INFO, sz.K_FOLDER])
    hdr += sz.write_number(1) + bytes([0]) + sz.write_number(len(coders))
    for codec, props in coders:
        if props:
            hdr += bytes([0x20 | len(codec)]) + codec
            hdr += sz.write_number(len(props)) + props
        else:
            hdr += bytes([len(codec)]) + codec
    hdr += bind
    hdr += bytes([sz.K_CODERS_UNPACK_SIZE])
    for s in unpack_sizes:
        hdr += sz.write_number(s)
    if crc is not None:
        hdr += bytes([sz.K_CRC, 1]) + struct.pack("<I", crc)
    hdr += bytes([sz.K_END, sz.K_SUBSTREAMS_INFO])
    if sub_crc is not None:
        hdr += bytes([sz.K_CRC, 1]) + struct.pack("<I", sub_crc)
    hdr += bytes([sz.K_END, sz.K_END])
    hdr += bytes([sz.K_FILES_INFO]) + sz.write_number(1) + _names(name)
    hdr += bytes([sz.K_END, sz.K_END])
    return bytes(hdr)


def _branchy(seed=7, n=4000) -> bytes:
    """Bytes dense in E8/E9 call and jump opcodes with rel32s that the
    x86 filters convert."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for _ in range(n):
        r = rng.random()
        if r < 0.3:
            out += b"\xe8" + struct.pack("<i", int(rng.integers(-(1 << 20),
                                                                1 << 20)))
        elif r < 0.4:
            out += b"\xe9" + struct.pack("<i", int(rng.integers(-(1 << 16),
                                                                1 << 16)))
        elif r < 0.45:
            out += bytes([0x0F, 0x80 + int(rng.integers(0, 16))])
            out += struct.pack("<i", int(rng.integers(0, 1 << 20)))
        else:
            out += rng.integers(0, 256, int(rng.integers(1, 8)),
                                dtype=np.uint8).tobytes()
    return bytes(out)


def _lzma2_raw(data: bytes):
    c = lzma.LZMACompressor(lzma.FORMAT_RAW,
                            filters=[{"id": lzma.FILTER_LZMA2, "preset": 6}])
    return c.compress(data) + c.flush(), bytes([24])


def test_filters_match_liblzma_and_jax():
    """The BCJ x86 and delta filters are liblzma's, byte for byte, and the
    JAX package's; BCJ2's four streams are the JAX package's."""
    data = _branchy()
    comp = lzma.LZMACompressor(lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_X86}, {"id": lzma.FILTER_LZMA2, "preset": 6}])
    blob = comp.compress(data) + comp.flush()
    liblzma = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "dict_size": 1 << 24}]).decompress(blob)
    enc = sz.bcj_x86_filter(data, encode=True)
    assert enc == liblzma == jsz.bcj_x86_filter(data, encode=True)
    assert enc != data and sz.bcj_x86_filter(enc, encode=False) == data
    for dist in (1, 2, 4, 16):
        enc = sz.delta_filter(data, dist, encode=True)
        assert enc == jsz.delta_filter(data, dist, encode=True)
        assert sz.delta_filter(enc, dist, encode=False) == data
    for case in (data, b"plain text " * 100, data[:500] + b"\xe8\x01\x02",
                 b"\xe9"):
        streams = sz.bcj2_encode(case)
        assert streams == jsz.bcj2_encode(case)
        assert sz.bcj2_decode(*streams, len(case)) == case
    main, call, jump, rc = sz.bcj2_encode(data)
    assert len(call) > 0 and len(jump) > 0 and len(main) < len(data)
    with pytest.raises(QzError):
        sz.bcj2_decode(main[:-5], call, jump, rc, len(data))
    with pytest.raises(QzError):
        sz.bcj2_decode(main, call[:2], jump, rc, len(data))


def test_range_coder_matches_jax():
    rng = np.random.default_rng(1)
    bits = [int(b) for b in rng.integers(0, 2, 4000)]
    ctxs = [int(c) for c in rng.integers(0, 258, 4000)]
    blobs = []
    for mod in (sz, jsz):
        probs = [1024] * 258
        enc = mod._RangeEncoder()
        for b, c in zip(bits, ctxs):
            enc.encode_bit(probs, c, b)
        blobs.append(enc.flush())
    assert blobs[0] == blobs[1]
    probs = [1024] * 258
    dec = sz._RangeDecoder(blobs[0])
    assert [dec.decode_bit(probs, c) for c in ctxs] == bits


def _extract_both(tmp_path, arc):
    """Each package's extraction of ``arc``: the file tree, or the rc of
    the QzError it raised."""
    got = []
    for mod, tag in ((sz, "p"), (jsz, "j")):
        out = tmp_path / f"out-{tag}"
        try:
            mod.extract_7z(str(arc), str(out))
            got.append(_read_tree(out) if out.exists() else {})
        except Exception as e:  # noqa: BLE001 (held alike across both)
            got.append(("error", type(e).__name__, getattr(e, "rc", None)))
    assert got[0] == got[1]
    return got[0]


def _coder(codec, nin=1, nout=1, props=b""):
    flags = len(codec) | (0x10 if (nin, nout) != (1, 1) else 0) | (
        0x20 if props else 0)
    out = bytearray([flags]) + codec
    if flags & 0x10:
        out += sz.write_number(nin) + sz.write_number(nout)
    if flags & 0x20:
        out += sz.write_number(len(props)) + props
    return bytes(out)


def _bcj2_archive(tmp_path, data, stock: bool, crc_ok=True):
    main, call, jump, rc = sz.bcj2_encode(data)
    crc = zlib.crc32(data) ^ (0 if crc_ok else 1)
    if stock:
        c2 = lzma.LZMACompressor(lzma.FORMAT_RAW, filters=[
            {"id": lzma.FILTER_LZMA2, "dict_size": 1 << 20}])
        lz1 = [{"id": lzma.FILTER_LZMA1, "lc": 3, "lp": 0, "pb": 2,
                "dict_size": 1 << 16}]

        def l1(b):
            c = lzma.LZMACompressor(lzma.FORMAT_RAW, filters=lz1)
            return c.compress(b) + c.flush()
        packs = [c2.compress(main) + c2.flush(), l1(call), l1(jump), rc]
        l1props = bytes([2 * 45 + 3]) + struct.pack("<I", 1 << 16)
        coders = [_coder(sz.CODEC_LZMA2, props=bytes([16])),
                  _coder(sz.CODEC_LZMA1, props=l1props),
                  _coder(sz.CODEC_LZMA1, props=l1props),
                  _coder(sz.CODEC_BCJ2, nin=4)]
        binds, packed_idx = [(3, 0), (4, 1), (5, 2)], [0, 1, 2, 6]
        sizes = [len(main), len(call), len(jump), len(data)]
    else:
        packs = [main, call, jump, rc]
        coders = [_coder(sz.CODEC_BCJ2, nin=4)]
        binds, packed_idx, sizes = [], [0, 1, 2, 3], [len(data)]
    hdr = bytearray([sz.K_HEADER, sz.K_MAIN_STREAMS, sz.K_PACK_INFO])
    hdr += sz.write_number(0) + sz.write_number(len(packs))
    hdr.append(sz.K_SIZE)
    for p in packs:
        hdr += sz.write_number(len(p))
    hdr += bytes([sz.K_END, sz.K_UNPACK_INFO, sz.K_FOLDER])
    hdr += sz.write_number(1) + bytes([0]) + sz.write_number(len(coders))
    hdr += b"".join(coders)
    for i, o in binds:
        hdr += sz.write_number(i) + sz.write_number(o)
    for i in packed_idx:
        hdr += sz.write_number(i)
    hdr.append(sz.K_CODERS_UNPACK_SIZE)
    for s in sizes:
        hdr += sz.write_number(s)
    hdr += bytes([sz.K_CRC, 1]) + struct.pack("<I", crc)
    hdr += bytes([sz.K_END, sz.K_END, sz.K_FILES_INFO]) + sz.write_number(1)
    hdr += _names("prog.exe") + bytes([sz.K_END, sz.K_END])
    return _write_archive(tmp_path, b"".join(packs), bytes(hdr))


@pytest.mark.parametrize("kind", ["bcj-lzma2", "delta-lzma2", "lzma1",
                                  "folder-crc-wrong", "bcj2-direct",
                                  "bcj2-stock", "bcj2-bad-crc"])
def test_7z_reader_chains_match_jax(tmp_path, kind):
    """Hand-made archives in stock 7-Zip's shapes (BCJ or delta over
    LZMA2, LZMA1, BCJ2 over pack streams or over LZMA2/LZMA1 coders), and
    wrong CRCs: both packages extract the same, or refuse alike."""
    data = _branchy(seed=11, n=6000)
    if kind in ("bcj-lzma2", "delta-lzma2"):
        bcj = kind == "bcj-lzma2"
        filt = (sz.bcj_x86_filter(data, encode=True) if bcj
                else sz.delta_filter(data, 4, encode=True))
        packed, l2 = _lzma2_raw(filt)
        coders = ([(sz.CODEC_BCJ_X86, b"")] if bcj
                  else [(sz.CODEC_DELTA, bytes([3]))]) + [(sz.CODEC_LZMA2, l2)]
        hdr = _one_folder(packed, coders, [len(data), len(filt)],
                          sub_crc=zlib.crc32(data),
                          bind=sz.write_number(0) + sz.write_number(1))
    elif kind == "lzma1":
        c = lzma.LZMACompressor(lzma.FORMAT_ALONE,
                                filters=[{"id": lzma.FILTER_LZMA1,
                                          "preset": 6}])
        alone = c.compress(data) + c.flush()
        packed = alone[13:]
        hdr = _one_folder(packed, [(sz.CODEC_LZMA1, alone[:5])], [len(data)],
                          sub_crc=zlib.crc32(data))
    elif kind == "folder-crc-wrong":
        packed, l2 = _lzma2_raw(data)
        hdr = _one_folder(packed, [(sz.CODEC_LZMA2, l2)], [len(data)],
                          crc=zlib.crc32(data) ^ 1)
    if kind.startswith("bcj2"):
        arc = _bcj2_archive(tmp_path, data, stock=kind == "bcj2-stock",
                            crc_ok=kind != "bcj2-bad-crc")
        name = "prog.exe"
    else:
        arc = _write_archive(tmp_path, packed, hdr)
        name = "payload.bin"
    got = _extract_both(tmp_path, arc)
    if kind in ("folder-crc-wrong", "bcj2-bad-crc"):
        assert got[0] == "error" and got[1] == "QzError"
    else:
        assert got == {name: ("file", data)}


def _empty_file_archive(tmp_path, name):
    hdr = bytearray([sz.K_HEADER, sz.K_FILES_INFO]) + sz.write_number(1)
    hdr += bytes([sz.K_EMPTY_STREAM]) + sz.write_number(1) + b"\x80"
    hdr += bytes([sz.K_EMPTY_FILE]) + sz.write_number(1) + b"\x80"
    hdr += _names(name) + bytes([sz.K_END, sz.K_END])
    return _write_archive(tmp_path, b"", bytes(hdr))


@pytest.mark.parametrize("name", ["../evil.txt", "/tmp/qz-evil-abs.txt",
                                  "link/inner.txt"])
def test_7z_hardened_extraction_matches_jax(tmp_path, name):
    """Zip-slip names and writes through a symlinked parent are refused
    alike, and nothing is written outside the destination."""
    outside = tmp_path / "outside"
    outside.mkdir()
    for tag in ("p", "j"):
        dest = tmp_path / f"out-{tag}"
        dest.mkdir()
        (dest / "link").symlink_to(outside)
    arc = _empty_file_archive(tmp_path, name)
    got = _extract_both(tmp_path, arc)
    assert got[0] == "error" and got[1] == "QzError"
    assert not (tmp_path / "evil.txt").exists()
    assert not os.path.exists("/tmp/qz-evil-abs.txt")
    assert not (outside / "inner.txt").exists()


def test_7z_truncated_header_matches_jax(tmp_path):
    src = tmp_path / "f.bin"
    src.write_bytes(np.random.default_rng(3).integers(
        0, 256, 4096, dtype=np.uint8).tobytes())
    arc = tmp_path / "t.7z"
    sz.create_7z([str(src)], str(arc))
    blob = bytearray(arc.read_bytes())
    hdr_off, hdr_sz, _ = struct.unpack_from("<QQI", blob, 12)
    cut = hdr_sz // 2
    hdr = bytes(blob[32 + hdr_off:32 + hdr_off + cut])
    start = struct.pack("<QQI", hdr_off, cut, zlib.crc32(hdr) & 0xFFFFFFFF)
    bad = tmp_path / "bad.7z"
    bad.write_bytes(bytes(blob[:8]) + struct.pack(
        "<I", zlib.crc32(start) & 0xFFFFFFFF) + start
        + bytes(blob[32:32 + hdr_off + cut]))
    got = _extract_both(tmp_path, bad)
    assert got[0] == "error" and got[1] == "QzError"
    for mod in (sz, jsz):
        with pytest.raises(Exception) as e:
            mod.list_7z(str(bad))
        assert type(e.value).__name__ == "QzError"
