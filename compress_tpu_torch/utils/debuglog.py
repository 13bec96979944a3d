"""Env-gated debug tracing — the reference's debugEncoder/debugDecoder
compile-time flags (zstd/zstd.go:13-20) as a runtime convention.

Enable per subsystem with a comma list:

    COMPRESS_TPU_DEBUG=zstd,s2,engine,flate,device  (or "all")

Messages go to stderr with a `[ct:<tag>]` prefix so they interleave
cleanly with test output. Zero overhead when disabled beyond one set
lookup.  The JAX package's convention, with its variable and tags.
"""

from __future__ import annotations

import os
import sys

_enabled: set | None = None


def enabled(tag: str) -> bool:
    global _enabled
    if _enabled is None:
        v = os.environ.get("COMPRESS_TPU_DEBUG", "")
        _enabled = {x.strip() for x in v.split(",") if x.strip()}
    return "all" in _enabled or tag in _enabled


def dbg(tag: str, msg: str, *args) -> None:
    if enabled(tag):
        print(f"[ct:{tag}] " + (msg % args if args else msg),
              file=sys.stderr, flush=True)


def _reset_for_tests() -> None:
    global _enabled
    _enabled = None
