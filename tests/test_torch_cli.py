"""The port's qzip, qzstd and aqzip against the JAX package's, on the CPU.

Each case runs the same steps (argument lists, with files the test writes
from ``tests/corpus.py``) through ``qatzip_tpu.cli.*.main`` in one
directory and ``qatzip_tpu_torch.cli.*.main`` with ``--device cpu`` in
another; after every step the return codes, the files in each directory
and the error messages must agree. A settings file (``QZTPU_CONF``)
raises ``input_sz_thrshold`` above every read for both packages, so both
take the software route and no JAX shape is compiled. On the engine
route the port's tools are held to its own sessions. Without a GPU and
without ``--device cpu`` each tool exits 1 with the runtime's error.
"""

import ctypes
import gc
import gzip
import io
import os
import re
import subprocess
import sys

import pytest
import torch

import jax

from qatzip_tpu.cli import aqzip as jaqzip
from qatzip_tpu.cli import qzip as jqzip
from qatzip_tpu.cli import qzstd as jqzstd
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import native, postproc
from qatzip_tpu_torch.cli import aqzip, qzip, qzstd

from tests.corpus import make_corpus
from tests.reference_native import require_reference_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module")
def corpus():
    return make_corpus()


@pytest.fixture()
def software(tmp_path, monkeypatch):
    """Both packages' sessions on the software route, from a settings
    file."""
    conf = tmp_path / "qztpu.conf"
    conf.write_text("[SHIM]\ninput_sz_thrshold = 1073741824\n")
    monkeypatch.setenv("QZTPU_CONF", str(conf))
    monkeypatch.delenv("QZTPU_SECTION_NAME", raising=False)


#: the timing lines the tools print on success
STATS = re.compile(r"(Time taken|Throughput|Space Savings|Compression ratio)"
                   r"|(qzstd|aqzip): .*\d+ -> \d+ bytes")

TOOLS = {"qzip": (qzip, jqzip), "qzstd": (qzstd, jqzstd),
         "aqzip": (aqzip, jaqzip)}


def _tree(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _setup(root, files, corpus):
    """Write ``files`` {relative path: corpus key or bytes} under root,
    every file and directory with one mtime (7z archives record it)."""
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(corpus[src] if isinstance(src, str) else src)
    t = 1_600_000_000
    for dirpath, dirs, fs in os.walk(root):
        for name in fs + dirs:
            os.utime(os.path.join(dirpath, name), (t, t))


def _run(mod, argv, capsys):
    """(exit code, stdout, the error lines of stderr) of one tool run. An
    exception the tool lets out exits 1 as a program (its error lines are
    then the exception's type)."""
    try:
        rc = mod.main(argv)
        raised = None
    except Exception as e:  # noqa: BLE001 (a program exits 1 on it)
        rc, raised = 1, [f"raised {type(e).__name__}"]
    cap = capsys.readouterr()
    errs = raised or [ln for ln in cap.err.splitlines()
                      if not STATS.match(ln)]
    return rc, re.sub(r"API \S+", "API", cap.out), errs


def _both(tmp_path, monkeypatch, capsys, corpus, files, steps):
    """Run ``steps`` [(tool, argv) or ("rm", path)] in a port directory
    and a JAX one set up alike; after each, the two must agree. Returns
    the port's [(rc, stdout, errors, tree)] per step."""
    roots = {"p": tmp_path / "port", "j": tmp_path / "jax"}
    for root in roots.values():
        root.mkdir()
        _setup(root, files, corpus)
    seen = []
    for tool, *argv in steps:
        step = {}
        for side, root in roots.items():
            monkeypatch.chdir(root)
            if tool == "rm":
                os.unlink(argv[0])
                continue
            mod = TOOLS[tool][0 if side == "p" else 1]
            args = (["--device", "cpu"] if side == "p" else []) + argv
            rc, out, errs = _run(mod, args, capsys)
            out = out.replace("qatzip_tpu_torch", "qatzip_tpu")
            step[side] = (rc, out, errs, _tree(root))
        if tool != "rm":
            p, j = step["p"], step["j"]
            if j[2][:1] == ["raised RuntimeError"]:
                # the JAX qzip lets a failed zstd decode out; the port
                # reports it (QZ_POST_PROCESS_ERROR): both exit 1
                assert "QZ_POST_PROCESS_ERROR" in p[2][0]
                p = (p[0], p[1], j[2], p[3])
            assert p == j, (tool, argv)
            seen.append(p)
    return seen


def _gz(corpus):
    full = gzip.compress(corpus["text"][:40000], 1)
    return {"trunc.gz": full[:len(full) // 2], "junk.gz": b"\x00\x01garbage",
            "short.gz": b"\x1f", "trunc.lz4": b"\x04\x22\x4d\x18\x60",
            "trunc.zst": b"\x28\xb5\x2f\xfd\x00"}


CASES = {
    "gzip": ({"f.txt": "text"}, [
        ("qzip", "-k", "f.txt"), ("qzip", "-d", "f.txt.gz"),
        ("qzip", "-d", "-f", "-k", "f.txt.gz"), ("rm", "f.txt"),
        ("qzip", "-d", "f.txt.gz")]),
    "formats-levels": ({"f.txt": "json"}, [
        ("qzip", "-H", "static", "-k", "-o", "s.gz", "f.txt"),
        ("qzip", "-O", "deflate_4B", "-k", "-o", "q.4b", "f.txt"),
        ("qzip", "-O", "gzip", "-L", "9", "-C", "16384", "-k", "-o", "g.gz",
         "f.txt"),
        ("qzip", "-L", "4", "-C", "4096", "-r", "8", "-P", "busy", "-k",
         "-o", "l.gz", "f.txt")]),
    "lz4": ({"f.bin": "binary"}, [
        ("qzip", "-A", "lz4", "f.bin"), ("qzip", "-d", "f.bin.lz4"),
        ("qzip", "-O", "lz4", "-k", "-o", "o.lz4", "f.bin")]),
    "zstd-lz4s": ({"f.txt": "text", "tiny.txt": "tiny"}, [
        ("qzip", "-A", "zstd", "-k", "f.txt"),
        ("qzip", "-d", "-f", "f.txt.zst"),
        ("qzip", "-A", "lz4s", "-k", "f.txt"),
        ("qzip", "-d", "-O", "lz4s", "f.txt.lz4s"),
        ("qzip", "-d", "-f", "f.txt.lz4s"),
        ("qzip", "-A", "zstd", "tiny.txt")]),
    "tree": ({"d/a.txt": "text", "d/sub/b.txt": "json", "d/sub/c.gz":
              b"already"}, [
        ("qzip", "d"), ("qzip", "-R", "-k", "d"), ("rm", "d/a.txt"),
        ("rm", "d/sub/b.txt"), ("qzip", "-R", "-d", "-f", "d")]),
    "7z": ({"t/a.txt": "text", "t/sub/b.bin": "binary", "t/e": "empty",
            "x.txt": "json"}, [
        ("qzip", "-O", "7z", "t"),
        ("qzip", "-O", "7z", "-o", "a.7z", "t", "x.txt"),
        ("rm", "t/a.txt"), ("rm", "t/sub/b.bin"), ("rm", "t/e"),
        ("rm", "x.txt"), ("qzip", "-d", "a.7z")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_qzip_matches_jax(tmp_path, monkeypatch, capsys, corpus, software,
                          case):
    files, steps = CASES[case]
    seen = _both(tmp_path, monkeypatch, capsys, corpus, files, steps)
    assert all(s[0] in (0, 1) for s in seen)
    tree = seen[-1][3]
    if case == "gzip":
        assert [s[0] for s in seen] == [0, 1, 0, 0]
        assert "already exists" in seen[1][2][0]
        assert tree["f.txt"] == corpus["text"]
        assert "f.txt.gz" not in tree
    elif case == "formats-levels":
        for name in ("s.gz", "g.gz", "l.gz"):
            assert gzip.decompress(tree[name]) == corpus["json"]
        s = qz.QzSession(device="cpu")
        p = qz.SessionParamsDeflate()
        p.data_fmt = qz.DataFormat.DEFLATE_4B
        s.setup_deflate(p)
        assert s.decompress(tree["q.4b"]) == corpus["json"]
    elif case == "lz4":
        assert tree["f.bin"] == corpus["binary"]
        assert tree["o.lz4"][:4] == b"\x04\x22\x4d\x18"
    elif case == "zstd-lz4s":
        assert seen[1][3]["f.txt"] == corpus["text"]
        assert "f.txt" not in tree       # the failed decode's output
        assert [s[0] for s in seen] == [0, 0, 0, 1, 1, 0]
        assert "Don't support lz4s decompression." in seen[3][2]
        assert postproc.zstd_decompress(tree["tiny.txt.zst"]) == b"abc"
    elif case == "tree":
        assert seen[0][0] == 1 and "is a directory" in seen[0][2][0]
        assert tree["d/a.txt"] == corpus["text"]
        assert tree["d/sub/b.txt"] == corpus["json"]
        assert tree["d/sub/c.gz"] == b"already"
    elif case == "7z":
        assert seen[0][0] == 1 and "Should use '-o'" in seen[0][2][0]
        assert tree["t/a.txt"] == corpus["text"]
        assert tree["t/sub/b.bin"] == corpus["binary"]
        assert tree["x.txt"] == corpus["json"] and tree["t/e"] == b""


def test_qzip_errors_match_jax(tmp_path, monkeypatch, capsys, corpus,
                               software):
    """Truncated or foreign members, missing files, unknown suffixes and
    the empty file (one 34-byte member) give the same codes, messages and
    files; no partial output is left."""
    files = {"f.txt": "text", "e": "empty", **_gz(corpus),
             "a.7z": b"7z\xbc\xaf\x27\x1c\x00\x04" + b"\x00" * 10}
    steps = [("qzip", "-d", "-o", "t.out", "trunc.gz"),
             ("qzip", "-d", "-o", "j.out", "junk.gz"),
             ("qzip", "-d", "-o", "s.out", "short.gz"),
             ("qzip", "-d", "-o", "l.out", "trunc.lz4"),
             ("qzip", "-d", "-o", "z.out", "trunc.zst"),
             ("qzip", "-d", "a.7z"),
             ("qzip", "-d", "f.txt"), ("qzip", "nope"),
             ("qzip", "-k", "e"), ("qzip", "-V")]
    seen = _both(tmp_path, monkeypatch, capsys, corpus, files, steps)
    rcs = [s[0] for s in seen]
    assert rcs[:4] == [1, 1, 1, 1] and rcs[5:8] == [1, 1, 1]
    assert rcs[8:] == [0, 0]
    assert qzip.main(["-h"]) == jqzip.main(["-h"]) == 0
    assert "unexpected end of input" in seen[0][2][0]
    assert "QZ_DATA_ERROR" in seen[1][2][0] and "QZ_DATA_ERROR" in seen[3][2][0]
    # a tail shorter than the magic: QZ_UNSUPPORTED_FMT, as in the JAX
    # package (not QZ_DATA_ERROR)
    assert "QZ_UNSUPPORTED_FMT" in seen[2][2][0]
    # a 7z file cut inside its signature header lets struct.error out of
    # both packages' readers (exit 1)
    assert seen[5][2] == ["raised error"]
    assert "unknown suffix" in seen[6][2][0]
    assert "No such file" in seen[7][2][0]
    tree = seen[-1][3]
    assert not {"t.out", "j.out", "s.out", "l.out"} & set(tree)
    assert len(tree["e.gz"]) == 34 and gzip.decompress(tree["e.gz"]) == b""
    assert seen[9][1].startswith("qzip (qatzip_tpu) ")


@pytest.mark.parametrize("decompress", [False, True])
def test_qzip_pipeline_matches_jax(corpus, software, decompress):
    """stdin to stdout (processStream): the same bytes."""
    data = corpus["text"][:150000] + corpus["noise"][:20000]
    outs = []
    for mod, argv in ((qzip, ["--device", "cpu"]), (jqzip, [])):
        blob = data
        if decompress:
            blob = gzip.compress(data[:90000], 1) + gzip.compress(data[90000:])
            argv = argv + ["-d"]
        fout = io.BytesIO()
        assert mod.process_stream(mod._build_parser().parse_args(argv),
                                  io.BytesIO(blob), fout) == 0
        outs.append(fout.getvalue())
    assert outs[0] == outs[1]
    assert (outs[0] if decompress else gzip.decompress(outs[0])) == data


@pytest.mark.skipif(not native.get_lib().has_zstd,
                    reason="no libzstd.so.1 of version 1.5 or later")
def test_qzstd_matches_jax(tmp_path, monkeypatch, capsys, corpus, software):
    files = {"z.txt": "text", "s.txt": b"small input " * 50, "x.bin": "json"}
    steps = [("qzstd", "-k", "z.txt"), ("qzstd", "-k", "s.txt"),
             ("qzstd", "-k", "-L", "3", "-C", "16384", "-o", "x.zst",
              "x.bin"),
             ("qzstd", "-k", "z.txt"), ("qzstd", "-d", "z.txt.zst"),
             ("rm", "z.txt"), ("qzstd", "-d", "z.txt.zst"),
             ("qzstd", "-d", "x.bin"), ("qzstd", "nope")]
    seen = _both(tmp_path, monkeypatch, capsys, corpus, files, steps)
    assert [s[0] for s in seen] == [0, 0, 0, 1, 1, 0, 1, 1]
    assert qzstd.main([]) == jqzstd.main([]) == 0
    tree = seen[-1][3]
    assert tree["z.txt"] == corpus["text"] and "z.txt.zst" not in tree
    assert postproc.zstd_decompress(tree["s.txt.zst"]) == b"small input " * 50
    assert postproc.zstd_decompress(tree["x.zst"]) == corpus["json"]


def test_aqzip_matches_jax(tmp_path, monkeypatch, capsys, corpus, software):
    files = {"a.dat": "text", "e.dat": "empty"}
    steps = [("aqzip", "-k", "-C", "16384", "a.dat"),
             ("aqzip", "-k", "a.dat"),
             ("aqzip", "-k", "-f", "-C", "65536", "-t", "3", "-w", "2",
              "--digest", "a.dat"),
             ("aqzip", "-d", "-k", "-f", "a.dat.gz"),
             ("aqzip", "-d", "a.dat"), ("aqzip", "-k", "e.dat"),
             ("aqzip", "nope")]
    seen = _both(tmp_path, monkeypatch, capsys, corpus, files, steps)
    assert [s[0] for s in seen] == [0, 1, 0, 0, 1, 0, 1]
    tree = seen[-1][3]
    assert tree["a.dat"] == corpus["text"]
    assert gzip.decompress(tree["a.dat.gz"]) == corpus["text"]
    assert seen[2][1].strip() == __import__("hashlib").sha256(
        tree["a.dat.gz"]).hexdigest()
    assert gzip.decompress(tree["e.dat.gz"]) == b""


def test_tools_on_the_engine_route_are_the_sessions(tmp_path, monkeypatch,
                                                   corpus):
    """Without the settings file the port's tools take the engine route
    (the CPU engine): their files are the port's own sessions' output."""
    monkeypatch.delenv("QZTPU_CONF", raising=False)
    monkeypatch.chdir(tmp_path)
    data = corpus["text"][:200000]
    (tmp_path / "f.txt").write_bytes(data)
    assert qzip.main(["--device", "cpu", "-k", "f.txt"]) == 0
    s = qz.QzSession(device="cpu")
    s.setup_deflate()
    blob = (tmp_path / "f.txt.gz").read_bytes()
    assert blob == s.compress(data) and gzip.decompress(blob) == data
    assert aqzip.main(["--device", "cpu", "-k", "-f", "-C", "65536",
                       "f.txt"]) == 0
    assert (tmp_path / "f.txt.gz").read_bytes() == b"".join(
        s.compress(data[o:o + 65536]) for o in range(0, len(data), 65536))
    if native.get_lib().has_zstd:
        assert qzstd.main(["--device", "cpu", "-k", "f.txt"]) == 0
        p = qz.SessionParamsLZ4S()
        p.qzCallback = qz.zstd_callback
        p.callback_external = {"level": 1}
        z = qz.QzSession(device="cpu")
        z.setup_lz4s(p)
        assert (tmp_path / "f.txt.zst").read_bytes() == z.compress(data)
        assert postproc.zstd_decompress(
            (tmp_path / "f.txt.zst").read_bytes()) == data


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_without_a_gpu_fails(tmp_path, monkeypatch, capsys, tool):
    """No GPU and no ``--device cpu``: exit 1 with the runtime's error,
    no output and the input kept; nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "f.txt").write_bytes(b"data " * 1000)
    assert TOOLS[tool][0].main(["f.txt"]) == 1
    assert "QZ_NOSW_NO_HW" in capsys.readouterr().err
    assert sorted(os.listdir(tmp_path)) == ["f.txt"]


def test_qzip_module_runs_as_a_program(tmp_path):
    """``python -m qatzip_tpu_torch.cli.qzip``: a pipe through
    ``--device cpu`` decodes with stock gzip; with no GPU visible and no
    ``--device`` it exits 1."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    data = b"piped through the module " * 4000
    r = subprocess.run([sys.executable, "-m", "qatzip_tpu_torch.cli.qzip",
                        "--device", "cpu"], input=data, capture_output=True,
                       env=env, cwd=tmp_path, timeout=300)
    assert r.returncode == 0 and gzip.decompress(r.stdout) == data
    r = subprocess.run([sys.executable, "-m", "qatzip_tpu_torch.cli.qzip",
                        "-k", "x"], capture_output=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode == 1 and b"QZ_NOSW_NO_HW" in r.stderr
