"""BENCHMARK.json against the benchmark's contract, and the files each
of its cells is found by."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from qzbench import harness, traffic

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "qzbench/run.py"]
    assert BENCH["paths"] == ["qzbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("qzbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in BENCH[group]]
        assert all(NAME.match(n) for n in group_names)
        names += group_names if group != "configs" else []
    assert len(names) == len(set(names))
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
            [c["source"] for c in BENCH["configs"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_at_most_one_four_chip_cell():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    assert [w["name"] for w in four] in ([], ["deflate_l1_x4.bulk64m"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.config["chips"] == c.chips
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    conf = next(x for x in BENCH["configs"] if x["name"] == entry["config"])
    assert conf["file"] == f"qzbench/configs/{entry['config']}.json"
    assert c.config["reduced"] == conf["reduced"]
    traffic.check(c.traffic)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_is_in_cells_that_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in harness.load_cell(cell).end_to_end}
    for label, targets in getattr(harness.reader(metric), "WRAPS", {}).items():
        for t in targets:
            assert ":" in t and t.startswith("qatzip_tpu_torch.")


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    found = []
    for base, _dirs, files in os.walk(os.path.join(ROOT, "qzbench")):
        if os.path.basename(base) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(base, f)):
                    if mod.split(".")[0] in harness.FORBIDDEN:
                        found.append((f, mod))
    assert not found


def test_a_run_loads_no_forbidden_module():
    """A whole run on the CPU, in a fresh process: nothing it loads is
    JAX, the JAX package, bench.py, chip_smoke.py or tests/ (top-level
    names compared whole)."""
    code = (
        "import sys, time, dataclasses\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from qzbench import harness\n"
        "c = harness.load_cell('deflate_l1.small64k_t4')\n"
        "t = dict(c.traffic, clients=2, buffer_bytes=262144, block=4,"
        " group=2)\n"
        "c = dataclasses.replace(c, traffic=t)\n"
        "r, k, i = harness.run_cell(c, 3, 0.5, True, t_process=0.0,"
        " device='cpu', check_engine=False)\n"
        "assert r['correct'], k\n"
        "print(sorted(m.split('.')[0] for m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "qatzip_tpu_torch" in loaded
    assert not loaded & harness.FORBIDDEN


def test_run_without_a_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "qzbench/run.py", "--workload", "deflate_l1.bulk64m",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout and "metrics" not in out.stdout


NEW_METRIC = '''"""A metric added as a file: requests of the window."""


def read(run):
    return float(len(run.requests))
'''


def _copy(tmp_path):
    """A copy of qzbench/, and its files' bytes to hold it to."""
    shutil.copytree(os.path.join(ROOT, "qzbench"), tmp_path / "qzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return {p: open(p, "rb").read()
            for p in map(str, (tmp_path / "qzbench").rglob("*"))
            if os.path.isfile(p)}


def _reports(bench, cell, metric="compress_gbps"):
    """Add ``cell`` to the cells that report the end-to-end ``metric``, as
    a new cell that reports it does: the entry's ``workloads`` grows."""
    m = next(e for e in bench["end_to_end"] if e["name"] == metric)
    if "workloads" in m:
        m["workloads"].append(cell)


def _run_in_copy(tmp_path, bench, cell, metric, seconds=0.5):
    """Run ``cell`` of the copy on the CPU; (its line's ``metric``, its
    ``attempted``)."""
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]\n"
        "from qzbench import harness\n"
        f"assert harness.ROOT == {str(tmp_path)!r}, harness.ROOT\n"
        f"c = harness.load_cell({cell!r})\n"
        f"r, k, i = harness.run_cell(c, 9, {seconds}, True, t_process=0.0,"
        " device='cpu', check_engine=False)\n"
        "assert r['correct'], k\n"
        f"print(r['metrics'][{metric!r}]['value'], r['attempted'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    value, attempted = out.stdout.strip().splitlines()[-1].split()
    return float(value), int(attempted)


def test_a_new_config_cell_and_metric_are_files_and_entries(tmp_path):
    """In a copy of qzbench/ and BENCHMARK.json, a configuration, a
    traffic mix, a cell and a per-layer metric added as new files and
    entries run with no file of the copy edited."""
    before = _copy(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(tmp_path / "qzbench/configs/deflate_l1.json"))
    cfg["session"]["hw_buff_sz"] = 32768
    (tmp_path / "qzbench/configs/deflate_l1_32k.json").write_text(
        json.dumps(cfg))
    (tmp_path / "qzbench/traffic/tiny.json").write_text(json.dumps(
        {"generator": "closed", "clients": 1, "request_bytes": 131072,
         "buffers": 2, "buffer_bytes": 131072, "order": "round_robin"}))
    (tmp_path / "qzbench/metrics/requests_seen.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "deflate_l1_32k", "source": "x",
                             "file": "qzbench/configs/deflate_l1_32k.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "deflate_l1_32k.tiny",
                               "config": "deflate_l1_32k", "traffic": "tiny",
                               "chips": 1, "why": "x"})
    _reports(bench, "deflate_l1_32k.tiny")
    bench["per_layer"].append({"name": "requests_seen.tiny", "unit": "req",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "compress_gbps",
                               "workloads": ["deflate_l1_32k.tiny"]})
    seen, _ = _run_in_copy(tmp_path, bench, "deflate_l1_32k.tiny",
                           "requests_seen.tiny")
    assert seen >= 1
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_an_lz4s_zstd_config_and_cell_are_files_and_entries(tmp_path):
    """In a copy, qzstd's configuration (an LZ4s session with the zstd
    post-process, judged by the zstd reader) with a traffic mix, a cell
    and a per-layer metric added as files and entries runs correct with
    no file of the copy edited."""
    before = _copy(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "qzbench/traffic/tiny.json").write_text(json.dumps(
        {"generator": "closed", "clients": 1, "request_bytes": 196608,
         "buffers": 2, "buffer_bytes": 196608, "order": "round_robin"}))
    (tmp_path / "qzbench/metrics/requests_seen.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "lz4s_zstd", "source": "x",
                             "file": "qzbench/configs/lz4s_zstd.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "lz4s_zstd.tiny",
                               "config": "lz4s_zstd", "traffic": "tiny",
                               "chips": 1, "why": "x"})
    _reports(bench, "lz4s_zstd.tiny")
    bench["per_layer"].append({"name": "requests_seen.tiny", "unit": "req",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "compress_gbps",
                               "workloads": ["lz4s_zstd.tiny"]})
    seen, _ = _run_in_copy(tmp_path, bench, "lz4s_zstd.tiny",
                           "requests_seen.tiny")
    assert seen >= 1
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


PACED = '''"""An open loop: one client, one request every ``period_s``."""

from .. import corpus


def check(spec):
    if not spec.get("period_s", 0) > 0:
        raise ValueError("a paced mix needs period_s")


class Traffic:
    clients = 1

    def __init__(self, spec, seed):
        self.data = corpus.silesia_like(spec["request_bytes"], f"{seed}:p")
        self.period = spec["period_s"]

    def schedule(self, client):
        i = 0
        while True:
            yield 0, self.data, i * self.period
            i += 1

    def warmup(self, client):
        return self.data
'''

SUBMIT_GAP = '''"""The shortest gap between two submissions, in ms."""


def read(run):
    ps = sorted(r.ps for r in run.requests)
    return min(b - a for a, b in zip(ps, ps[1:])) / 1e6 if ps[1:] else None
'''


def test_a_new_traffic_generator_is_a_file(tmp_path):
    """In a copy, a generator of another kind (an open loop that sends a
    request every 0.1 s) added as a file, with a mix naming it, a cell
    and a metric, runs with no file of the copy edited: the window sends
    each request when it is due, and not before."""
    before = _copy(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "qzbench/traffic/paced.py").write_text(PACED)
    (tmp_path / "qzbench/traffic/paced4k.json").write_text(json.dumps(
        {"generator": "paced", "request_bytes": 4096, "period_s": 0.1}))
    (tmp_path / "qzbench/metrics/submit_gap_ms.py").write_text(SUBMIT_GAP)
    bench["workloads"].append({"name": "deflate_l1.paced4k",
                               "config": "deflate_l1", "traffic": "paced4k",
                               "chips": 1, "why": "x"})
    _reports(bench, "deflate_l1.paced4k")
    bench["per_layer"].append({"name": "submit_gap_ms.paced", "unit": "ms",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "compress_gbps",
                               "workloads": ["deflate_l1.paced4k"]})
    gap, attempted = _run_in_copy(tmp_path, bench, "deflate_l1.paced4k",
                                  "submit_gap_ms.paced", seconds=0.55)
    assert gap >= 99.0 and 2 <= attempted <= 6
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
