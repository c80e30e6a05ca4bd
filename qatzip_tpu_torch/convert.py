"""Carry a session's parameters across from the JAX package.

A codec has no weights; the state that crosses between the two packages
is the session configuration. ``params_from_reference`` takes one of the
JAX package's session parameter structs as ``dataclasses.asdict`` gives
it (enums as ints) and gives this package's struct of the same kind:
deflate, LZ4 or LZ4s, told apart by their fields. An LZ4s callback and
its external argument are not carried: the caller sets its own.
"""

from __future__ import annotations

import dataclasses

from .constants import DataFormat, Direction, HuffmanHdr, PollingMode
from .params import (SessionParamsCommon, SessionParamsDeflate,
                     SessionParamsLZ4, SessionParamsLZ4S)

_ENUMS = {"direction": Direction, "polling_mode": PollingMode}
# the fields beside ``common`` of each kind
_KINDS = {
    frozenset({"huffman_hdr", "data_fmt"}): SessionParamsDeflate,
    frozenset(): SessionParamsLZ4,
    frozenset({"lz4s_mini_match", "qzCallback", "callback_external"}):
        SessionParamsLZ4S,
}


def params_from_reference(d: dict):
    """This package's params from the JAX package's as a dict."""
    fields = {f.name for f in dataclasses.fields(SessionParamsCommon)}
    common = dict(d["common"])
    rest = frozenset(d) - {"common"}
    unknown = set(common) - fields
    if unknown or rest not in _KINDS:
        raise ValueError(f"unknown parameter fields: "
                         f"{sorted(unknown or rest)}")
    for name, enum in _ENUMS.items():
        if name in common:
            common[name] = enum(common[name])
    common = SessionParamsCommon(**common)
    kind = _KINDS[rest]
    if kind is SessionParamsDeflate:
        return SessionParamsDeflate(common=common,
                                    huffman_hdr=HuffmanHdr(d["huffman_hdr"]),
                                    data_fmt=DataFormat(d["data_fmt"]))
    if kind is SessionParamsLZ4S:
        return SessionParamsLZ4S(common=common,
                                 lz4s_mini_match=int(d["lz4s_mini_match"]))
    return SessionParamsLZ4(common=common)
