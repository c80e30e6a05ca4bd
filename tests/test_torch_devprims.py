"""The probe kernels' plain versions against the JAX tool's Pallas kernels.

``tools/devprims.py`` builds its Pallas kernels inside ``main()``, so the
module loads the tool by path at B = 1, records every ``pallas_call`` of
one ``main()`` run (kernel and keyword arguments, in call order), and
calls the recorded kernels again, in interpret mode, on inputs made from
a seed with numpy. ``qatzip_tpu_torch.ops.devprims``'s plain versions
(what the wrappers run for CPU tensors) must give the same words: the
lane, wide-lane and sublane gathers, the static and the dynamic rolls,
and the bitonic sort with its payload, on random, tie-heavy and bit-31
keys. The port's tool runs end to end on the CPU, and its u32 sums equal
the JAX kernels' on the same inputs.
"""

import contextlib
import ctypes
import gc
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas

from qatzip_tpu_torch.ops import devprims as dv
from qatzip_tpu_torch.tools import devprims as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the recordings, in the JAX tool's call order
ORDER = ("lane", "lane_wide", "sublane", "roll_static", "roll_dyn",
         "bitonic", "bitonic_check")


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Give what this module held back to the system when it ends (the
    test runner keeps each worker for many files; JAX keeps every
    compiled program, glibc the freed pages)."""
    yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


@pytest.fixture(scope="module")
def jax_kernels():
    """{name: callable} of the JAX tool's Pallas kernels at B = 1, each
    the real ``pallas_call`` of a recorded kernel, called eagerly."""
    real = pallas.pallas_call
    seen = []

    def recorder(kernel, **kwargs):
        seen.append((kernel, kwargs))
        return real(kernel, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setenv("PRIMS_B", "1")
    mp.setenv("PRIMS_ITERS", "1")
    mp.setattr(pallas, "pallas_call", recorder)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_devprims_tool", os.path.join(REPO, "tools", "devprims.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            mod.main()
    finally:
        mp.undo()
    assert '"error"' not in out.getvalue()
    assert len(seen) == len(ORDER)
    return {name: real(kernel, **kw)
            for name, (kernel, kw) in zip(ORDER, seen)}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


@pytest.mark.parametrize("name,shape,axis", [
    ("lane", (512, 128), 1), ("lane_wide", (8192, 1024), 1),
    ("sublane", (512, 128), 0)])
def test_gathers_match_jax(jax_kernels, name, shape, axis):
    rng = np.random.default_rng(11)
    x = _words(rng, shape)
    hi = shape[axis]
    idx = rng.integers(0, hi, shape).astype(np.int32)
    idx[:3] = 0                                  # the edges of the range
    idx[3:6] = hi - 1
    want = np.asarray(jax_kernels[name](x, idx))
    ref = dv.lane_gather_ref if axis == 1 else dv.sublane_gather_ref
    assert (_u32(ref(_t(x), _t(idx))) == want).all()
    wrapper = dv.lane_gather if axis == 1 else dv.sublane_gather
    assert (_u32(wrapper(_t(x), _t(idx))) == want).all()


@pytest.mark.parametrize("shifts", [
    None, (1, 3, 9, 27, 31, 77, 111), (0, 127, 64, 32, 31, 33, 1)],
    ids=["static", "dynamic", "dynamic-edges"])
def test_rolls_match_jax(jax_kernels, shifts):
    x = _words(np.random.default_rng(12), (4096, 128))
    if shifts is None:
        want = np.asarray(jax_kernels["roll_static"](x))
        got = dv.roll_sum_ref(_t(x))
    else:
        sh = np.asarray(shifts, np.int32)
        want = np.asarray(jax_kernels["roll_dyn"](sh, x))
        got = dv.roll_sum_ref(_t(x), torch.from_numpy(sh))
    assert (_u32(got) == want).all()
    wrapped = dv.roll_sum(_t(x), None if shifts is None
                          else torch.tensor(shifts, dtype=torch.int32))
    assert torch.equal(wrapped, got)


def _bitonic_keys(kind, rng):
    """(512, 128) uint32 keys: random; from 8 values with bit 31 set in
    half of them; rows of one key; sorted rows; reverse-sorted rows."""
    shape = (512, 128)
    if kind == "random":
        return _words(rng, shape)
    if kind == "ties-bit31":
        vals = np.array([0, 7, 1 << 20, 0x7FFFFFFF, 1 << 31, (1 << 31) + 7,
                         0xFFFFFFF0, 0xFFFFFFFF], np.uint32)
        return vals[rng.integers(0, 8, shape)]
    if kind == "all-equal":
        return np.repeat(_words(rng, (512, 1)), 128, axis=1)
    keys = np.sort(_words(rng, shape), axis=1)
    return keys if kind == "sorted" else keys[:, ::-1]


@pytest.mark.parametrize("kind", ["random", "ties-bit31", "all-equal",
                                  "sorted", "reversed"])
def test_bitonic_matches_jax(jax_kernels, kind):
    """Keys equal np.sort's; the payload follows the network, which is
    not a stable sort's order on ties."""
    rng = np.random.default_rng(13)
    keys = _bitonic_keys(kind, rng)
    vals = _words(rng, keys.shape)
    wk, wv = (np.asarray(a) for a in jax_kernels["bitonic"](keys, vals))
    gk, gv = dv.bitonic128_ref(_t(keys), _t(vals))
    assert (_u32(gk) == wk).all() and (_u32(gv) == wv).all()
    assert (wk == np.sort(keys, axis=1)).all()
    ck, cv = dv.bitonic128(_t(keys), _t(vals))
    assert torch.equal(ck, gk) and torch.equal(cv, gv)
    if kind == "ties-bit31":
        stable = np.take_along_axis(vals, np.argsort(keys, 1, kind="stable"),
                                    1)
        assert not (stable == wv).all()


def test_tool_runs_on_the_cpu_with_the_jax_kernels_sums(jax_kernels):
    """One line per case, nothing failed, and every sum equal to the JAX
    kernels' (the Pallas cases) or numpy's (the library cases) on the
    tool's own inputs."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        lines = tool.main(["--device", "cpu", "--b", "1", "--iters", "1"])
    assert out.getvalue().count("\n") == len(lines) == 14
    assert all("error" not in ln for ln in lines)
    got = {ln["case"]: ln for ln in lines}
    assert got["bitonic128_correct"]["ok"] is True
    host = tool.inputs(1)

    def s(*arrays):
        return int(sum(int(a.astype(np.uint64).sum()) for a in arrays)
                   & 0xFFFFFFFF)
    keys, ctx = host["keys"], [host[f"ctx{i}"] for i in range(4)]
    want = {f"sort{n}": s(keys, *ctx[:n - 1]) for n in (1, 2, 5)}
    want["sortseg2-8192"] = want["sortseg2-2048"] = s(keys, ctx[0])
    want["xla_gather"] = s(np.take_along_axis(keys, host["idx_w"], 1))
    for case, name in (("pl_gather_lane", "lane"),
                       ("pl_gather_lane_wide", "lane_wide"),
                       ("pl_gather_sublane", "sublane")):
        want[case] = s(np.asarray(jax_kernels[name](
            host[f"{case}_x"], host[f"{case}_idx"])))
    x512 = host["x512"]
    want["pl_roll_static7"] = s(np.asarray(jax_kernels["roll_static"](x512)))
    want["pl_roll_dyn7"] = s(np.asarray(jax_kernels["roll_dyn"](
        np.asarray(tool.DYN_SHIFTS, np.int32), x512)))
    want["pl_bitonic128"] = s(*(np.asarray(a) for a in jax_kernels["bitonic"](
        keys.reshape(-1, 128), ctx[0].reshape(-1, 128))))
    want["lax_sort128"] = want["pl_bitonic128"]
    assert {c: got[c]["sum"] for c in want} == want
    for ln in lines[:-1]:
        assert ln["best_ms"] > 0 and ln["bound_ms"] > 0 and ln["gbps"] > 0


def _wrapper_calls():
    """{kernel: (call, tensors, bad_shapes)}: each wrapper's call on small
    valid CPU tensors (``call(*tensors)``), and argument lists whose
    shapes or extents its kernel does not take."""
    from qatzip_tpu_torch.ops import cuda_pack as cp
    from qatzip_tpu_torch.ops import deflate_pack as dp
    from qatzip_tpu_torch.ops import lz4_pack as lp

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype)
    key = (torch.arange(256, dtype=torch.int32) | (5 << 8)).expand(2, 256)
    b8, i32 = torch.bool, torch.int32
    planes = [z(2, 256), z(2, 256), z(2, 256, dtype=b8), z(2, 256, dtype=b8)]
    lz4 = [z(2, 256, dtype=torch.uint8)] + planes
    return {
        "candidate_search": (
            lambda k, c: cp.candidate_search(k, c, probes=7, min_match=4,
                                             pbits=8),
            [key.contiguous(), z(3, 2, 256)],
            [[z(2, 96), z(3, 2, 96)], [key.contiguous(), z(3, 2, 128)]]),
        "parse_scan": (lambda im, ml: cp.parse_scan(im, ml, 64),
                       [z(2, 256, dtype=b8), z(2, 256)],
                       [[z(2, 200, dtype=b8), z(2, 200)],
                        [z(2, 256, dtype=b8), z(2, 128)]]),
        "pack_rows": (
            lambda *t: dp.pack_rows(*t[:4], t[4], max_words=64, lpack=t[5],
                                    dpack=t[6]),
            planes + [z(2), z(2, 256), z(2, 256)],
            [planes[:3] + [z(2, 128, dtype=b8), z(2), z(2, 256), z(2, 256)],
             planes + [z(3), z(2, 256), z(2, 256)]]),
        "huffman_lookup": (cp.huffman_lookup,
                           [z(2, 286), z(2, 30), z(2, 256), z(2, 256)],
                           [[z(2, 285), z(2, 30), z(2, 256), z(2, 256)],
                            [z(2, 286), z(2, 30), z(2, 256), z(2, 255)]]),
        "symbol_histogram": (cp.symbol_histogram, [z(2, 256), z(2, 256)],
                             [[z(2, 256), z(3, 256)]]),
        "lz4_pack_rows": (lambda *t: lp.lz4_pack_rows(*t, max_words=64), lz4,
                          [lz4[:4] + [z(2, 128, dtype=b8)]]),
        "lane_gather": (dv.lane_gather, [z(8, 128), z(8, 128)],
                        [[z(8, 96), z(8, 96)], [z(8, 128), z(8, 64)]]),
        "sublane_gather": (dv.sublane_gather, [z(8, 128), z(8, 128)],
                           [[z(6, 128), z(6, 128)], [z(8, 128), z(4, 128)]]),
        "roll_sum": (dv.roll_sum, [z(8, 128), torch.tensor([1, 5], dtype=i32)],
                     [[z(8, 96), None], [z(8, 128), z(33)],
                      [z(8, 128), z(0)]]),
        "bitonic128": (dv.bitonic128, [z(8, 128), z(8, 128)],
                       [[z(8, 64), z(8, 64)], [z(8, 128), z(7, 128)]]),
    }


@pytest.mark.parametrize("kernel", sorted(dv.LAUNCHES))
def test_wrappers_refuse_what_the_kernels_do_not_take(kernel):
    """Every wrapper refuses, before its kernel could run, each of its
    tensors in a wrong dtype (TypeError) and laid out non-contiguously
    (ValueError), and shapes its kernel does not take (ValueError); its
    valid call on the CPU runs the plain version and launches nothing."""
    call, tensors, bad_shapes = _wrapper_calls()[kernel]
    before = dict(dv.LAUNCHES)
    call(*tensors)
    for i, t in enumerate(tensors):
        args = list(tensors)
        args[i] = t.to(torch.int64)
        with pytest.raises(TypeError):
            call(*args)
        args[i] = torch.stack([t, t], dim=-1)[..., 0]
        assert args[i].shape == t.shape and not args[i].is_contiguous()
        with pytest.raises(ValueError):
            call(*args)
    for args in bad_shapes:
        with pytest.raises(ValueError):
            call(*args)
    assert dv.LAUNCHES == before


# every C entry of qz_kernels.h as a stub that returns ``rc_next``; the
# sublane gather's also keeps its arguments in ``seen``
BINDING_STUBS = r"""
#include <stdint.h>
#include "qz_kernels.h"
int rc_next;
long long seen[6];
#define STUB(name, ...) int name(__VA_ARGS__) { return rc_next; }
STUB(qz_candidate_search, const void* a, const void* b, void* c, int d,
     int e, int f, int g, int h, int i, void* s)
STUB(qz_parse_scan, const void* a, const void* b, void* c, void* d, int e,
     int f, void* s)
STUB(qz_pack_rows, const void* a, const void* b, const void* c,
     const void* d, const void* e, const void* f, const void* g,
     const void* h, void* i, void* j, int k, int l, int m, void* s)
STUB(qz_huffman_lookup, const void* a, const void* b, const void* c,
     const void* d, void* e, void* f, int g, int h, void* s)
STUB(qz_symbol_histogram, const void* a, const void* b, void* c, int d,
     int e, void* s)
STUB(qz_lz4_pack_rows, const void* a, const void* b, const void* c,
     const void* d, const void* e, void* f, void* g, void* h, int i, int j,
     int k, void* s)
STUB(qz_lane_gather, const void* a, const void* b, void* c, int d, int e,
     void* s)
STUB(qz_roll_sum, const void* a, const void* b, int c, void* d, int e,
     void* s)
STUB(qz_bitonic128, const void* a, const void* b, void* c, void* d, int e,
     void* s)
int qz_sublane_gather(const void* x, const void* idx, void* out, int log_r,
                      int log_c, void* s) {
  seen[0] = (intptr_t)x; seen[1] = (intptr_t)idx; seen[2] = (intptr_t)out;
  seen[3] = log_r; seen[4] = log_c; seen[5] = (intptr_t)s;
  return rc_next;
}
const char* qz_cuda_error_string(int code) { return "stub error"; }
"""


def test_kernel_binding_builds_with_the_host_compiler(tmp_path):
    """``csrc/binding.c`` compiles warning-free with the build's own host
    compiler command against Python.h and qz_kernels.h alone (no nvcc, no
    PyTorch header), and, linked with stubs for the CUDA entries, passes
    each argument through, returns None, raises RuntimeError when the
    entry reports a refused launch, and refuses arguments that are not
    ints, out of range or miscounted."""
    import importlib.machinery
    import importlib.util
    from qatzip_tpu_torch.ops import _build
    stub = tmp_path / "stubs.c"
    stub.write_text(BINDING_STUBS)
    objs = [str(tmp_path / "binding.o"), str(tmp_path / "stubs.o")]
    log = _build._run_all([
        _build.binding_command(os.path.join(_build.CSRC_DIR, "binding.c"),
                               objs[0]),
        _build.binding_command(str(stub), objs[1])])
    assert "warning" not in log, log
    so = str(tmp_path / "_qz_kernels.so")
    _build._run_all([["cc", "-shared", "-o", so, *objs]])
    loader = importlib.machinery.ExtensionFileLoader("_qz_kernels", so)
    spec = importlib.util.spec_from_file_location("_qz_kernels", so,
                                                  loader=loader)
    ext = importlib.util.module_from_spec(spec)
    loader.exec_module(ext)
    assert {n for n in dir(ext) if not n.startswith("_")} == set(dv.LAUNCHES)
    lib = ctypes.CDLL(so)
    rc = ctypes.c_int.in_dll(lib, "rc_next")
    seen = (ctypes.c_longlong * 6).in_dll(lib, "seen")
    big = (1 << 47) + 16
    assert ext.sublane_gather(big, 0, big + 64, 9, 7, 12345) is None
    assert list(seen) == [big, 0, big + 64, 9, 7, 12345]
    rc.value = 2
    with pytest.raises(RuntimeError, match=r"^sublane_gather launch failed: "
                       r"cudaError 2 \(stub error\)$"):
        ext.sublane_gather(1, 2, 3, 4, 5, 6)
    rc.value = 0
    with pytest.raises(TypeError):
        ext.sublane_gather(1, 2, 3, 4, 5)
    with pytest.raises(TypeError):
        ext.roll_sum(1, None, 0, 3, 4, 5)
    with pytest.raises(OverflowError):
        ext.lane_gather(1, 2, 3, 1 << 31, 5, 6)
    with pytest.raises(OverflowError):
        ext.lane_gather(-1, 2, 3, 4, 5, 6)
    assert ext.pack_rows(*range(1, 15)) is None


def test_port_tool_and_chip_check_import_without_jax():
    """The port, its probe tool and the chip check import with jax and
    the JAX package unavailable, as on the card's machine."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['qatzip_tpu'] = None; "
            "import qatzip_tpu_torch, qatzip_tpu_torch.tools.devprims, "
            "chip_smoke; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
