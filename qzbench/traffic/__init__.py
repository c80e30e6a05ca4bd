"""Traffic: a mix is a data file ``traffic/<mix>.json`` that names its
generator, ``traffic/<generator>.py``, with the generator's parameters.
A cell with new traffic adds a mix file, and a new kind of traffic (an
open loop, a mix of sizes) a generator file; neither edits a file that
is there.

A generator module has:

* ``check(spec)``: raises ValueError on a mix it cannot run;
* ``Traffic(spec, seed)``: the requests of one run, made from the seed,
  with ``clients`` (client threads, each with a session of its own),
  ``warmup(client)`` (the bytes of the one request a client sends in
  set-up) and ``schedule(client)``: an endless iterator of the client's
  requests as ``(key, data, at)``. ``key`` names the input (answers to
  one key that are byte for byte equal share one check), ``data`` is the
  request's bytes, and ``at`` the seconds after the window's start at
  which it is due, or None to send it when the client's previous request
  has returned (a closed loop). A request is due no earlier than the
  client's previous one.

The window (``harness._window``) sends each client's requests in order,
waits until one is due, and counts its latency from when it was due.
A client sends no request that is due, or that it reaches, after the
window's end.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))


def generator(spec: Dict):
    """The module ``traffic/<spec["generator"]>.py``."""
    name = spec.get("generator")
    if not isinstance(name, str) or not os.path.isfile(
            os.path.join(HERE, f"{name}.py")):
        raise ValueError(f"a traffic mix names no generator file: {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def check(spec: Dict) -> None:
    generator(spec).check(spec)


def load(name: str) -> Dict:
    """The mix ``traffic/<name>.json``, checked by its generator."""
    with open(os.path.join(HERE, f"{name}.json")) as f:
        spec = json.load(f)
    check(spec)
    return spec


def make(spec: Dict, seed: int):
    """The requests of one run of the mix ``spec`` with ``seed``."""
    return generator(spec).Traffic(spec, seed)
