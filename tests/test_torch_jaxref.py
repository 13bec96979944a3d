"""The JAX package's native core, loaded before a port test compares with
it.

The reference builds its core lazily (``compress_tpu/_native``): every
process compiles to the same ``libct_<hash>.so.tmp`` in its cache and
renames it, with no lock.  When several pytest workers start on a cold
cache they race for that file; a loser logs ``native build failed`` and
runs the whole session on the reference's Python fallbacks, whose frames
differ from the native ones the port is held to.

``reference_core()`` repairs a worker that lost: under a file lock it
waits (at most ``WAIT_S`` seconds) for the library the reference names,
removes and rebuilds it if it does not load, then clears the reference's
``_tried`` flag and loads it again, with a warning that says so.  If the
core still does not load it fails the test; it never skips.  With ``COMPRESS_TPU_NONATIVE`` set the
reference runs on its fallbacks by design and nothing is done.

The port test modules that compare with the reference's native output use
it through ``jax_native_core``, a module-scoped autouse fixture:
``from test_torch_jaxref import jax_native_core  # noqa: F401``.
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile
import time
import warnings

import pytest

pytest.importorskip("jax")

from compress_tpu import _native as jax_native  # noqa: E402

WAIT_S = 300


def cache_path() -> str:
    """The library the reference loads: ``$COMPRESS_TPU_CACHE`` or
    ``$TMPDIR/compress_tpu_native``, then ``libct_<source hash>.so``."""
    cache = os.environ.get(
        "COMPRESS_TPU_CACHE",
        os.path.join(tempfile.gettempdir(), "compress_tpu_native"))
    return os.path.join(cache, f"libct_{jax_native._source_hash()}.so")


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path, mode=os.RTLD_LOCAL)
    except OSError:
        return False
    return True


def _rebuild(path: str) -> None:
    """The reference's compiler line, into a temporary file of this
    process's own, renamed over ``path``."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           *jax_native._cpu_flags(), "-fno-exceptions", "-o", tmp,
           *jax_native._sources()]
    try:
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, timeout=WAIT_S)
        if r.returncode != 0:
            pytest.fail(f"reference core build failed:\n{r.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def reference_core():
    """The reference's loaded native library (see the module docstring);
    None only under ``COMPRESS_TPU_NONATIVE``."""
    if os.environ.get("COMPRESS_TPU_NONATIVE"):
        return None
    lib = jax_native.raw()
    if lib is not None:
        return lib
    path = cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(os.path.dirname(path), "port_tests.lock"),
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        deadline = time.monotonic() + WAIT_S
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.5)
        if not (os.path.exists(path) and _loads(path)):
            if os.path.exists(path):
                os.unlink(path)
            _rebuild(path)
        with jax_native._lock:
            jax_native._tried = False
            jax_native._lib = None
        lib = jax_native.raw()
    if lib is not None:
        warnings.warn(f"the reference's native core was reloaded after a "
                      f"lost build ({path})")
    if lib is None:
        pytest.fail(f"the reference's native core does not load ({path})")
    return lib


@pytest.fixture(scope="module", autouse=True)
def jax_native_core():
    """The reference's native core, loaded before the module's tests."""
    return reference_core()


def test_reference_core_loaded():
    if os.environ.get("COMPRESS_TPU_NONATIVE"):
        assert jax_native.raw() is None
    else:
        assert jax_native.raw() is not None
        assert os.path.exists(cache_path())


def test_reference_core_recovers_a_lost_build(monkeypatch):
    """A worker that lost the build race (``_tried`` set, no library)
    loads the library another worker built."""
    if os.environ.get("COMPRESS_TPU_NONATIVE"):
        assert reference_core() is None
        return
    reference_core()
    with jax_native._lock:
        jax_native._tried = True
        jax_native._lib = None
    assert jax_native.raw() is None
    assert reference_core() is not None
    assert jax_native.raw() is not None


def test_reference_core_rebuilds_a_broken_library(monkeypatch, tmp_path):
    """A library file that does not load is removed and built once more."""
    if os.environ.get("COMPRESS_TPU_NONATIVE"):
        assert reference_core() is None
        return
    monkeypatch.setenv("COMPRESS_TPU_CACHE", str(tmp_path))
    path = cache_path()
    with open(path, "wb") as f:
        f.write(b"not a shared object")
    with jax_native._lock:
        jax_native._tried = True
        jax_native._lib = None
    assert reference_core() is not None
    assert _loads(path)
    assert jax_native.lib_crc32c(b"123456789") == 0xE3069283
