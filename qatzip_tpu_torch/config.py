"""The settings file: per-section session defaults.

Counterpart of ``qatzip_tpu/config.py`` (the reference's QAT ``.conf``
files and its ``QAT_SECTION_NAME`` override, src/qatzip.c:530-558). The
file is INI. It is found at ``$QZTPU_CONF``, else ``./qztpu.conf``, else
``~/.config/qztpu.conf``; its section is ``$QZTPU_SECTION_NAME``, by
default ``SHIM``. ``params.get_defaults`` overlays the section's session
parameters::

    [SHIM]
    hw_buff_sz = 65536
    comp_lvl = 1
    sw_backup = 1

The file sets only parameters a caller can set on a session anyway: no
route and no tuning knob. ``tile_chunks`` is read as a number, as in the
JAX package, and nothing uses it.
"""

from __future__ import annotations

import configparser
import os
from typing import Dict, Optional

_DEFAULT_SECTION = "SHIM"   # the reference's default section name

_INT_KEYS = {"tile_chunks", "hw_buff_sz", "strm_buff_sz", "comp_lvl",
             "input_sz_thrshold", "req_cnt_thrshold", "wait_cnt_thrshold",
             "sw_backup", "max_forks", "lz4s_mini_match"}

#: the common session parameters a section may set
_COMMON_KEYS = ("comp_lvl", "hw_buff_sz", "strm_buff_sz",
                "input_sz_thrshold", "req_cnt_thrshold", "wait_cnt_thrshold",
                "sw_backup", "max_forks")


def _conf_path() -> Optional[str]:
    explicit = os.environ.get("QZTPU_CONF")
    if explicit and os.path.exists(explicit):
        return explicit
    for cand in ("./qztpu.conf", os.path.expanduser("~/.config/qztpu.conf")):
        if os.path.exists(cand):
            return cand
    return None


def section_name() -> str:
    """The active section (QAT_SECTION_NAME, src/qatzip.c:536-538)."""
    return os.environ.get("QZTPU_SECTION_NAME", _DEFAULT_SECTION)


def load(section: Optional[str] = None) -> Dict[str, object]:
    """The section's settings: numbers for ``_INT_KEYS`` (a value that is
    not one is skipped), strings otherwise; empty without a file, a
    readable one or the section."""
    path = _conf_path()
    if path is None:
        return {}
    cp = configparser.ConfigParser()
    try:
        cp.read(path)
    except configparser.Error:
        return {}
    sec = section or section_name()
    if sec not in cp:
        return {}
    out: Dict[str, object] = {}
    for key, raw in cp[sec].items():
        if key in _INT_KEYS:
            try:
                out[key] = int(raw, 0)
            except ValueError:
                continue
        else:
            out[key] = raw
    return out


def apply_to_params(params, settings: Optional[Dict[str, object]] = None):
    """Overlay ``settings`` (by default the active section's) on a
    session params object; returns it."""
    settings = settings if settings is not None else load()
    common = getattr(params, "common", params)
    for key in _COMMON_KEYS:
        if key in settings and hasattr(common, key):
            setattr(common, key, settings[key])
    if "lz4s_mini_match" in settings and hasattr(params, "lz4s_mini_match"):
        params.lz4s_mini_match = settings["lz4s_mini_match"]
    return params
