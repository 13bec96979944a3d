"""The port's command-line tools (``cli/``: ``s2c``, ``s2d``, ``s2sx``,
``zstdio``, ``builddict``) against the JAX package's, in-process on the
CPU: every output file byte for byte (tolerance 0) and the same exit
codes.  ``-device`` and ``s2sx`` run the port's parallel engine on
``block_mesh(device="cpu")``; the JAX package's run on its CPU mesh.  The
self-extractor is run in a subprocess.  No test touches the network.
"""

import io
import os
import subprocess
import sys
import tarfile

import pytest

pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")

from compress_tpu.cli import builddict as jax_builddict  # noqa: E402
from compress_tpu.cli import s2c as jax_s2c  # noqa: E402
from compress_tpu.cli import s2d as jax_s2d  # noqa: E402
from compress_tpu.cli import s2sx as jax_s2sx  # noqa: E402
from compress_tpu.cli import zstdio as jax_zstdio  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from compress_tpu_torch.cli import builddict, s2c, s2d, s2sx, zstdio  # noqa: E402
from compress_tpu_torch.parallel import block_mesh  # noqa: E402
from compress_tpu_torch.s2 import stream as S2S  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

CPU = block_mesh(device="cpu")


@pytest.fixture(scope="module")
def data():
    """8 corpus blocks (the classes in turn) and a 12,345-byte tail."""
    return (corpus.corpus_blocks(8, 31).tobytes()
            + corpus.corpus_blocks(1, 32).tobytes()[:12_345])


@pytest.fixture
def dirs(tmp_path):
    """A directory for each package's run."""
    out = (tmp_path / "port", tmp_path / "jax")
    for d in out:
        d.mkdir()
    return out


def put(dirs, name, blob):
    for d in dirs:
        (d / name).write_bytes(blob)
    return [str(d / name) for d in dirs]


def run_both(port_main, jax_main, dirs, name, flags, **port_kw):
    """Each package's ``main`` on its own copy of ``name``; the exit codes
    must agree."""
    paths = [str(d / name) for d in dirs]
    rc = port_main([*flags, paths[0]], **port_kw)
    jrc = jax_main([*flags, paths[1]])
    assert rc == jrc
    return rc


def same_file(dirs, name):
    a, b = ((d / name).read_bytes() for d in dirs)
    assert a == b, name
    return a


# -- s2c and s2d ---------------------------------------------------------------


S2C_FLAGS = {
    "default": [],
    "faster": ["-faster"],
    "slower": ["-slower"],
    "block": ["-block"],
    "block_faster": ["-block", "-faster"],
    "block_slower": ["-block", "-slower"],
    "snappy": ["-snappy"],
    "snappy_block": ["-snappy", "-block"],
    "snappy_slower": ["-snappy", "-slower"],
    "no_index": ["-no-index"],
    "blocksize": ["-blocksize", "64K"],
    "pad": ["-pad", "4K"],
    "cpu1": ["-cpu", "1"],
    "verify": ["-verify", "-q"],
    "device_no_index": ["-device", "-no-index"],
    "device_snappy": ["-device", "-snappy"],
}


@pytest.mark.parametrize("case", sorted(S2C_FLAGS))
def test_s2c_equals_jax(data, dirs, case):
    flags = S2C_FLAGS[case]
    put(dirs, "in.bin", data)
    assert run_both(s2c.main, jax_s2c.main, dirs, "in.bin", flags,
                    mesh=CPU) == 0
    ext = ".sz" if "-snappy" in flags else ".s2"
    blob = same_file(dirs, "in.bin" + ext)
    if "-block" in flags:
        from compress_tpu_torch import s2

        assert s2.decode(blob) == data
    else:
        assert S2S.Reader(io.BytesIO(blob)).read() == data


def test_s2c_device_index_and_s2d_seek(data, dirs):
    """``-device`` with ``-index`` (the default): the JAX package's stream
    followed by the index ``index_stream`` builds from it, which ``s2d
    -offset`` and ``-tail`` seek; the JAX package's stream has no index
    and its ``s2d -offset`` raises."""
    from compress_tpu_torch.parallel import s2_stream_encode_device
    from compress_tpu_torch.s2.index import index_stream

    put(dirs, "in.bin", data)
    assert run_both(s2c.main, jax_s2c.main, dirs, "in.bin", ["-device"],
                    mesh=CPU) == 0
    ours, theirs = ((d / "in.bin.s2").read_bytes() for d in dirs)
    assert theirs == s2_stream_encode_device(data, CPU)
    assert ours == theirs + index_stream(theirs).append_to()
    src = str(dirs[0] / "in.bin.s2")
    for off in (0, 1, 65_535, 65_536, 300_001, len(data) - 1):
        out = str(dirs[0] / f"at{off}")
        assert s2d.main(["-q", "-offset", str(off), "-o", out, src]) == 0
        with open(out, "rb") as f:
            assert f.read() == data[off:]
    assert s2d.main(["-q", "-tail", "777", "-o", out, src]) == 0
    with open(out, "rb") as f:
        assert f.read() == data[-777:]
    with pytest.raises(ValueError):
        jax_s2d.main(["-q", "-offset", "5", "-o", out,
                      str(dirs[1] / "in.bin.s2")])


def test_s2c_recomp_stdout_safe(data, dirs, capsysbinary):
    buf = io.BytesIO()
    w = S2S.Writer(buf, snappy=True)
    w.write(data)
    w.close()
    put(dirs, "in.sz", buf.getvalue())
    assert run_both(s2c.main, jax_s2c.main, dirs, "in.sz",
                    ["-recomp", "-c"]) == 0
    out = capsysbinary.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    assert S2S.Reader(io.BytesIO(out[:half])).read() == data
    put(dirs, "in.sz.s2", b"present")
    assert run_both(s2c.main, jax_s2c.main, dirs, "in.sz",
                    ["-recomp", "-safe"]) == 1
    assert run_both(s2c.main, jax_s2c.main, dirs, "in.sz", ["-recomp"]) == 0
    assert S2S.Reader(io.BytesIO(same_file(dirs, "in.sz.s2"))).read() == data


def test_s2c_rm_and_output_name(data, dirs):
    put(dirs, "gone.bin", data[:70_000])
    assert run_both(s2c.main, jax_s2c.main, dirs, "gone.bin", ["-rm"]) == 0
    same_file(dirs, "gone.bin.s2")
    assert not any((d / "gone.bin").exists() for d in dirs)
    assert s2c.out_name("http://host/a/b", False) == jax_s2c.out_name(
        "http://host/a/b", False)
    assert s2c.parse_size("4M") == jax_s2c.parse_size("4M") == 4 << 20
    with pytest.raises(SystemExit):
        s2c.main(["-faster", "-slower", "x"])


def _s2_stream(data):
    buf = io.BytesIO()
    w = S2S.Writer(buf, add_index=True, block_size=1 << 16)
    w.write(data)
    w.close()
    return buf.getvalue()


S2D_FLAGS = {
    "default": [],
    "cpu1": ["-cpu", "1"],
    "cpu4": ["-cpu", "4"],
    "offset": ["-offset", "70000"],
    "offset_k": ["-offset", "300K"],
    "tail": ["-tail", "9999"],
}


@pytest.mark.parametrize("case", sorted(S2D_FLAGS))
def test_s2d_equals_jax(data, dirs, case):
    flags = S2D_FLAGS[case]
    put(dirs, "in.s2", _s2_stream(data))
    assert run_both(s2d.main, jax_s2d.main, dirs, "in.s2",
                    [*flags, "-q"]) == 0
    got = same_file(dirs, "in")
    if "-offset" in flags:
        assert got == data[s2c.parse_size(flags[1]):]
    elif "-tail" in flags:
        assert got == data[-9999:]
    else:
        assert got == data


def test_s2d_block_verify_stdout_safe(data, dirs, capsysbinary):
    from compress_tpu_torch import s2

    put(dirs, "raw.s2", s2.encode_better(data))
    assert run_both(s2d.main, jax_s2d.main, dirs, "raw.s2",
                    ["-block", "-c"]) == 0
    assert capsysbinary.readouterr().out == data * 2
    assert run_both(s2d.main, jax_s2d.main, dirs, "raw.s2",
                    ["-block", "-verify"]) == 0
    assert not any((d / "raw").exists() for d in dirs)
    put(dirs, "raw", b"present")
    assert run_both(s2d.main, jax_s2d.main, dirs, "raw.s2",
                    ["-block", "-safe"]) == 1
    put(dirs, "other.bin", _s2_stream(data[:1000]))
    assert run_both(s2d.main, jax_s2d.main, dirs, "other.bin", []) == 0
    assert same_file(dirs, "other.bin.decoded") == data[:1000]


def test_s2d_untar(data, dirs):
    tb = io.BytesIO()
    with tarfile.open(fileobj=tb, mode="w") as tf:
        for name, blob in (("a.txt", data[:5000]), ("sub/b.bin", data[-777:])):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            info.mtime = 1
            tf.addfile(info, io.BytesIO(blob))
    put(dirs, "t.tar.s2", _s2_stream(tb.getvalue()))
    for d in dirs:
        (d / "x").mkdir()
    assert s2d.main(["-untar", "-q", "-o", str(dirs[0] / "x"),
                     str(dirs[0] / "t.tar.s2")]) == 0
    assert jax_s2d.main(["-untar", "-q", "-o", str(dirs[1] / "x"),
                         str(dirs[1] / "t.tar.s2")]) == 0
    assert same_file(dirs, "x/a.txt") == data[:5000]
    assert same_file(dirs, "x/sub/b.bin") == data[-777:]


def test_globs_expand_as_jax(data, dirs):
    for d in dirs:
        for i in range(3):
            (d / f"g{i}.txt").write_bytes(data[i * 1000:(i + 2) * 1000])
    pat = [str(d / "g*.txt") for d in dirs]
    assert s2c.expand_args([pat[0]]) == [str(dirs[0] / f"g{i}.txt")
                                         for i in range(3)]
    assert s2c.main(["-q", pat[0]]) == jax_s2c.main(["-q", pat[1]]) == 0
    for i in range(3):
        same_file(dirs, f"g{i}.txt.s2")


# -- s2sx ----------------------------------------------------------------------


def test_s2sx_equals_jax_and_extracts(data, dirs):
    put(dirs, "doc.bin", data)
    sx = s2sx.build_sx(str(dirs[0] / "doc.bin"), mesh=CPU)
    jsx = jax_s2sx.build_sx(str(dirs[1] / "doc.bin"))
    with open(sx, "rb") as a, open(jsx, "rb") as b:
        assert a.read() == b.read()
    for d in dirs:
        (d / "doc.bin").unlink()
    subprocess.run([sys.executable, sx], cwd=dirs[0], check=True,
                   capture_output=True, timeout=120,
                   env={"PATH": os.environ.get("PATH", "")})
    assert (dirs[0] / "doc.bin").read_bytes() == data


def test_s2sx_main_output_path(data, dirs, capsys):
    [path, _] = put(dirs, "m.bin", data[:100_000])
    out = str(dirs[0] / "m.sx.py")
    assert s2sx.main(["-o", out, path], mesh=CPU) == 0
    assert capsys.readouterr().out.strip() == out
    assert s2sx._STUB == jax_s2sx._STUB


# -- zstdio --------------------------------------------------------------------


ZSTDIO_FLAGS = {
    "level1": ["-level", "1"],
    "level2": [],
    "level3": ["-level", "3"],
    "level4": ["-level", "4"],
    "crc": ["-crc"],
    "accel": ["-accel"],
    "accel_level3": ["-accel", "-level", "3"],
    "accel_crc": ["-accel", "-crc"],
}


@pytest.mark.parametrize("case", sorted(ZSTDIO_FLAGS))
def test_zstdio_equals_jax(data, dirs, case):
    flags = ZSTDIO_FLAGS[case]
    put(dirs, "z.bin", data)
    assert run_both(zstdio.main, jax_zstdio.main, dirs, "z.bin", flags) == 0
    blob = same_file(dirs, "z.bin.zst")
    assert zstandard.ZstdDecompressor().stream_reader(
        io.BytesIO(blob), read_across_frames=True).read() == data
    assert run_both(zstdio.main, jax_zstdio.main, dirs, "z.bin.zst",
                    ["-d"]) == 0
    assert same_file(dirs, "z.bin") == data


@pytest.mark.parametrize("kind", ("raw", "zstd"))
def test_zstdio_dictionary_equals_jax(data, dirs, kind):
    samples = [data[i:i + 4096] for i in range(0, 8 * 65536, 65536)]
    if kind == "raw":
        d = data[:20_000]
    else:
        from compress_tpu_torch.zstd.dict import build_dict

        d = build_dict(samples, data[:20_000], dict_id=77)
    put(dirs, "d.dict", d)
    put(dirs, "s.bin", data[5000:60_000])
    dpaths = [str(x / "d.dict") for x in dirs]
    assert zstdio.main(["-D", dpaths[0], str(dirs[0] / "s.bin")]) == 0
    assert jax_zstdio.main(["-D", dpaths[1], str(dirs[1] / "s.bin")]) == 0
    same_file(dirs, "s.bin.zst")
    for i, main in enumerate((zstdio.main, jax_zstdio.main)):
        assert main(["-d", "-D", dpaths[i], "-o", str(dirs[i] / "back"),
                     str(dirs[i] / "s.bin.zst")]) == 0
    assert same_file(dirs, "back") == data[5000:60_000]


def test_zstdio_stdout(data, dirs, capsysbinary):
    put(dirs, "c.bin", data[:50_000])
    assert run_both(zstdio.main, jax_zstdio.main, dirs, "c.bin",
                    ["-c", "-level", "3"]) == 0
    out = capsysbinary.readouterr().out
    assert out[:len(out) // 2] == out[len(out) // 2:]
    assert Z.decompress(out[:len(out) // 2]) == data[:50_000]


# -- builddict -----------------------------------------------------------------


@pytest.mark.parametrize("fmt", ("raw", "zstd", "s2"))
def test_builddict_equals_jax(data, dirs, fmt):
    names = []
    for i in range(8):
        name = f"s{i}.json"
        put(dirs, name, b'{"name": "user", "id": %d, "tags": ["a","b"]}'
            % i * 20 + data[i * 65536:i * 65536 + 500])
        names.append(name)
    for i, main in enumerate((builddict.main, jax_builddict.main)):
        assert main(["-format", fmt, "-maxsize", "4096", "-dictID", "9",
                     "-o", str(dirs[i] / "d.bin"),
                     *[str(dirs[i] / n) for n in names]]) == 0
    blob = same_file(dirs, "d.bin")
    if fmt == "zstd":
        from compress_tpu_torch.zstd.dict import load_dict

        assert load_dict(blob).id == 9
