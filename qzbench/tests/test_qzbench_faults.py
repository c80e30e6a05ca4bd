"""Whole runs of each cell on the CPU at a small size (the harness's look
for a card skipped): sound, they come out correct; with the timed path
broken underneath, or with the control in the program's place, they come
out not correct. Each fault a cell can have: a step that returns its
input unchanged (the session's compress: an engine that returned its
LZ4 chunks unchanged would be framed as stored blocks, a valid answer
that only the ratio sees), half of a request's chunks left out and filled from the
rest, the exchange between the cards left out (the four-card cell), an
answer altered where it is produced. ``lz4s_zstd`` is qzstd's LZ4s
session with the zstd post-process, a configuration with a file and no
cell: it runs here under the bulk traffic."""

import dataclasses
import json
import os
import time

import pytest

from qzbench import control, harness

#: each cell's request size here; "x4" is the bulk DEFLATE cell over four
#: devices (the four-card configuration's MeshEngine, on CPU shares)
SMALL = {"deflate_l1.bulk64m": 262144, "lz4_l1.bulk64m": 262144,
         "deflate_l1.small64k_t4": 65536, "x4": 524288, "lz4s_zstd": 262144}


def config(name):
    with open(os.path.join(harness.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def small_cell(name):
    if name == "lz4s_zstd":
        cell = dataclasses.replace(harness.load_cell("lz4_l1.bulk64m"),
                                   name="lz4s_zstd.bulk64m",
                                   config=config("lz4s_zstd"))
    else:
        cell = harness.load_cell("deflate_l1.bulk64m" if name == "x4"
                                 else name)
    r = SMALL[name]
    t = dict(cell.traffic, request_bytes=r, buffer_bytes=4 * r, buffers=1,
             clients=min(2, cell.traffic["clients"]), block=4, group=2)
    return dataclasses.replace(cell, traffic=t)


def device_of(name):
    return ["cpu"] * 4 if name == "x4" else "cpu"


def run(name, **kw):
    res, checks, _info = harness.run_cell(
        small_cell(name), 2**35 + 11, 0.3, False, t_process=time.perf_counter(),
        device=device_of(name), check_engine=False, **kw)
    return res, checks


def half(chunks, res):
    h = len(res) // 2
    return res[:len(res) - h] + res[:h]


def altered(chunks, res):
    """One payload altered: every 64th byte flipped (a single byte can
    land on an LZ4 offset that points at equal bytes, an answer still
    right)."""
    i = len(res) // 2
    p = bytearray(res[i][0])
    for k in range(len(p) // 2, len(p), 64):
        p[k] ^= 0x20
    return res[:i] + [(bytes(p), res[i][1])] + res[i + 1:]


FAULTS = {"half": half, "altered": altered}
CASES = [(cell, f) for cell in SMALL for f in FAULTS
         if not (f == "half" and cell == "deflate_l1.small64k_t4")]


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(cell):
    res, checks = run(cell)
    assert res["correct"] and res["attempted"] >= 1, checks
    assert res["failed"] == 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """The fault is planted when the window opens: set-up's warm-up is
    sound (an altered LZ4s block that the post-process refuses would
    otherwise end the run in set-up, with no line at all)."""
    from qatzip_tpu_torch.parallel import dispatch
    orig = dispatch.CudaEngine.compress_rows
    orig_window = harness._window
    armed = []

    def broken(self, chunks, *a, **kw):
        got = orig(self, chunks, *a, **kw)
        return FAULTS[fault](chunks, got) if armed else got

    def window(*a, **kw):
        armed.append(True)
        return orig_window(*a, **kw)
    monkeypatch.setattr(dispatch.CudaEngine, "compress_rows", broken)
    monkeypatch.setattr(harness, "_window", window)
    res, checks = run(cell)
    assert not res["correct"] and res["failed"] >= 1, checks


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_compress_that_returns_its_input_is_not_correct(cell, monkeypatch):
    import qatzip_tpu_torch as qz
    monkeypatch.setattr(qz.QzSession, "compress",
                        lambda self, data, *a, **kw: bytes(data))
    res, checks = run(cell)
    assert not res["correct"] and res["failed"] >= 1, checks


def test_the_exchange_between_cards_left_out_is_not_correct(monkeypatch):
    from qatzip_tpu_torch.parallel import dispatch
    orig = dispatch.MeshEngine.compress_rows

    def no_exchange(self, chunks, *a, **kw):
        got = orig(self, chunks, *a, **kw)
        first = self._shares(len(chunks))[0]
        mine = got[first[1]:first[2]]
        return [mine[i % len(mine)] for i in range(len(got))]
    monkeypatch.setattr(dispatch.MeshEngine, "compress_rows", no_exchange)
    res, checks = run("x4")
    assert not res["correct"], checks


@pytest.mark.parametrize("cell", ["deflate_l1.bulk64m", "lz4_l1.bulk64m"])
def test_the_control_is_not_correct(cell):
    res, checks = run(cell, make_session=control.ControlSession)
    assert not res["correct"] and checks["checksum_errors"] >= 1, checks
    assert checks["content_errors"] == checks["frame_errors"] == 0


def test_the_control_of_the_zstd_post_process_is_not_correct():
    """qzstd's frames carry no checksum: the control leaves out the
    post-process, and its LZ4s blocks are no zstd frame."""
    res, checks = run("lz4s_zstd", make_session=control.ControlSession)
    assert not res["correct"] and checks["frame_errors"] >= 1, checks


def test_the_controls_lz4s_blocks_are_what_the_post_process_takes():
    """Every byte of the control but the missing post-process follows the
    format: the port's post-process turns its blocks into frames that
    read back."""
    from qatzip_tpu_torch import postproc
    from qzbench import corpus, reference
    data = corpus.silesia_like(3 * 65536 + 300, "ctl")
    blocks = control.ControlSession(config("lz4s_zstd")).compress(data)
    frames = postproc.zstd_callback({"level": 1}, data, blocks, 3)
    c, wrong = reference.judge("zstd_frames", 65536, [(0, data, frames)])
    assert c == reference.zero_counts() and wrong == [False]


def test_an_lz4s_config_without_a_post_process_is_refused():
    from qzbench import sut
    cfg = config("lz4s_zstd")
    assert sut.reference_format(cfg) == "zstd_frames"
    del cfg["post_process"]
    with pytest.raises(ValueError, match="post_process"):
        sut.make_session(cfg, "cpu")
    with pytest.raises(ValueError, match="post_process"):
        sut.reference_format(cfg)


def _req(nbytes):
    return harness.Request(0, 0, b"\0" * nbytes, b"", 0, 0, 0, 0)


@pytest.mark.parametrize("name,nbytes,cards,want", [
    ("deflate_l1", 64 << 20, 1, 4),         # 1024 chunks, 4 tiles of 256
    ("lz4_l1", 64 << 20, 1, 4),
    ("deflate_l1", 64 << 10, 1, 1),          # one chunk, one tile
    ("deflate_l1", (64 << 20) + 1, 1, 5),    # a 1-byte last chunk
    ("deflate_l1_x4", 64 << 20, 4, 4),       # 256 rows a card
    ("deflate_l1_x4", 64 << 10, 4, 1),       # one row on one card
    ("lz4s_zstd", 64 << 20, 1, 4),
])
def test_route_launches_are_one_a_tile(name, nbytes, cards, want):
    from qzbench import sut
    assert sut.route_launches(config(name), nbytes, cards) == want


def test_a_request_with_a_tile_routed_away_is_short():
    """A bulk request whose four tiles made three launches of the route's
    kernel (one tile served some other way) is one launch short, though
    the engine's counter took the whole request; so is a window of small
    requests one of which made none."""
    cell = harness.load_cell("deflate_l1.bulk64m")
    before = {"hw_compress": 10, "launches.pack_rows": 40}
    bulk = [_req(64 << 20)] * 3
    for launches, short in ((12, 0), (11, 1), (8, 4)):
        after = {"hw_compress": 13, "launches.pack_rows": 40 + launches}
        got = harness._engine_checks(cell.config, before, after, bulk, 1)
        assert got == {"off_engine": 0, "route_short": short}
    small = [_req(64 << 10)] * 5
    after = {"hw_compress": 15, "launches.pack_rows": 44}
    got = harness._engine_checks(cell.config, before, after, small, 1)
    assert got == {"off_engine": 0, "route_short": 1}
    assert harness.LIMITS["route_short"] == 0
