"""The port's HTTP middleware (``gzhttp``) against the JAX package's, on
the CPU: ``tests/test_gzhttp.py``'s cases and the streamed responses, each
served by both middlewares and compared byte for byte (status, header
list in order, body; tolerance 0).  The jitter is a hash of the content,
so the responses are deterministic.  Stdlib ``gzip`` and the port's own
decoders read the bodies back.
"""

import gzip as stdgzip
import io

import pytest

pytest.importorskip("jax")

from compress_tpu import gzhttp as jax_gzhttp  # noqa: E402
from compress_tpu import gzip as jax_gzip  # noqa: E402
from compress_tpu_torch import corpus, gzhttp  # noqa: E402
from compress_tpu_torch import gzip as G  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

BODY = b"<html>" + b"compressible body content " * 200 + b"</html>"


def make_app(body=BODY, ctype="text/html", extra_headers=(), chunks=1):
    def app(environ, start_response):
        headers = [("Content-Length", str(len(body)))]
        if ctype is not None:
            headers.insert(0, ("Content-Type", ctype))
        headers += list(extra_headers)
        start_response("200 OK", headers)
        step = max(1, -(-len(body) // chunks))
        return [body[i:i + step] for i in range(0, len(body), step)] or [b""]

    return app


def serve(mw, accept="gzip", **env_extra):
    environ = {"HTTP_ACCEPT_ENCODING": accept, "wsgi.input": io.BytesIO(b"")}
    environ.update(env_extra)
    out = {}

    def sr(status, headers, exc_info=None):
        out["status"] = status
        out["headers"] = list(headers)
        return lambda b: None

    parts = [bytes(p) for p in mw(environ, sr)]
    return out["status"], out["headers"], parts


def both(app_kw, mw_kw, accept="gzip", **env):
    """The response of each package's middleware to the same request."""
    ours = serve(gzhttp.gzip_handler(make_app(**app_kw), **mw_kw), accept,
                 **env)
    theirs = serve(jax_gzhttp.gzip_handler(make_app(**app_kw), **mw_kw),
                   accept, **env)
    assert ours == theirs
    return ours


def hmap(headers):
    return {k.lower(): v for k, v in headers}


CASES = {
    "gzip": ({}, {"min_size": 10}, "gzip, deflate"),
    "below_min_size": ({"body": b"tiny"}, {"min_size": 100}, "gzip"),
    "not_accepted": ({}, {"min_size": 10}, "br;q=1, gzip;q=0"),
    "qvalue_case": ({}, {"min_size": 10}, "GZIP"),
    "zstd_preferred": ({}, {"min_size": 10, "enable_zstd": True,
                            "prefer_zstd": True}, "gzip, zstd"),
    "zstd_by_q": ({}, {"min_size": 10, "enable_zstd": True},
                  "gzip;q=0.5, zstd"),
    "zstd_disabled": ({}, {"min_size": 10}, "zstd"),
    "star": ({}, {"min_size": 10, "enable_zstd": True}, "*"),
    "type_filtered": ({"ctype": "image/png"}, {
        "min_size": 10, "content_types": {"text/html"}}, "gzip"),
    "type_excepted": ({}, {"min_size": 10, "except_content_types": {
        "text/html"}}, "gzip"),
    "etag_suffix": ({"extra_headers": [("ETag", '"abc"')]}, {
        "min_size": 10, "suffix_etag": "-gz"}, "gzip"),
    "etag_drop": ({"extra_headers": [("ETag", '"abc"')]}, {
        "min_size": 10, "drop_etag": True}, "gzip"),
    "already_encoded": ({"extra_headers": [("Content-Encoding", "br")]}, {
        "min_size": 10}, "gzip"),
    "content_range": ({"extra_headers": [("Content-Range", "bytes 0-9/99")]},
                      {"min_size": 10}, "gzip"),
    "accept_ranges": ({"extra_headers": [("Accept-Ranges", "bytes")]}, {
        "min_size": 10, "keep_accept_ranges": True}, "gzip"),
    "jitter_gzip": ({}, {"min_size": 10, "random_jitter": 256}, "gzip"),
    "jitter_zstd": ({}, {"min_size": 10, "random_jitter": 256,
                         "enable_zstd": True, "prefer_zstd": True}, "zstd"),
    "jitter_other_body": ({"body": BODY + b"x"}, {
        "min_size": 10, "random_jitter": 256}, "gzip"),
    "levels": ({}, {"min_size": 10, "level": 9, "zstd_level": 4}, "gzip"),
    "incompressible": ({"body": bytes(range(256)) * 8}, {"min_size": 10},
                       "gzip"),
    "sniffed_text": ({"ctype": None, "body": b"compress me please " * 200},
                     {"min_size": 10, "content_types": {"text/plain"}},
                     "gzip"),
    "sniffed_binary": ({"ctype": None, "body": bytes(range(256)) * 20}, {
        "min_size": 10, "content_types": {"text/plain"}}, "gzip"),
    "streamed_gzip": ({"chunks": 9}, {"min_size": 100}, "gzip"),
    "streamed_zstd": ({"chunks": 9}, {"min_size": 100, "enable_zstd": True,
                                      "prefer_zstd": True}, "zstd"),
    "streamed_jitter_gzip": ({"chunks": 5}, {
        "min_size": 100, "random_jitter": 100}, "gzip"),
    "streamed_jitter_zstd": ({"chunks": 5}, {
        "min_size": 100, "random_jitter": 100, "enable_zstd": True},
        "zstd"),
    "streamed_identity": ({"chunks": 5}, {"min_size": 100}, "identity"),
    "streamed_sniffed": ({"chunks": 7, "ctype": None}, {"min_size": 100},
                         "gzip"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_middleware_equals_jax(case):
    app_kw, mw_kw, accept = CASES[case]
    status, headers, parts = both(app_kw, mw_kw, accept)
    body = b"".join(parts)
    want = app_kw.get("body", BODY)
    enc = hmap(headers).get("content-encoding")
    if enc == "gzip" and "Content-Encoding" not in dict(
            app_kw.get("extra_headers", ())):
        assert stdgzip.decompress(body) == want
        assert G.decompress(body)[0] == want
    elif enc == "zstd":
        assert Z.decompress(body) == want
    else:
        assert body == want
    assert status == "200 OK"


def test_negotiation_equals_jax():
    for header in ("GZip;Q=0.5, ZSTD", "gzip;q=abc", "", "*;q=0.1",
                   "zstd;q=0, gzip", "br , deflate"):
        assert gzhttp.parse_accept_encoding(
            header) == jax_gzhttp.parse_accept_encoding(header)
        for z in (False, True):
            for p in (False, True):
                assert gzhttp.negotiate(header, z, p) == jax_gzhttp.negotiate(
                    header, z, p)


def test_detect_content_type_equals_jax():
    samples = [b"<!DOCTYPE html><html>...", b"%PDF-1.4 blah",
               b"\x89PNG\r\n\x1a\n rest", b"hello plain words " * 10,
               bytes(range(256)), b"RIFF\x00\x00\x00\x00WAVEfmt ",
               b"RIFF\x00\x00\x00\x00WEBPVP8 ", b"<?xml version='1.0'?>",
               b"\x28\xb5\x2f\xfd\x00", b"  \n<div>x</div>", b""]
    for s in samples:
        assert gzhttp.GzipMiddleware.detect_content_type(
            s) == jax_gzhttp.GzipMiddleware.detect_content_type(s)


@pytest.mark.parametrize("encoding", ("gzip", "zstd"))
def test_compressed_request_body_equals_jax(encoding):
    payload = corpus.corpus_blocks(1, 5).tobytes()[:30_000]
    blob = (G.compress(payload) if encoding == "gzip"
            else Z.compress(payload, level=2))
    seen = []

    def app(environ, start_response):
        seen.append((environ["wsgi.input"].read(),
                     environ.get("CONTENT_LENGTH"),
                     "HTTP_CONTENT_ENCODING" in environ))
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [b"ok"]

    outs = []
    for mod in (gzhttp, jax_gzhttp):
        mw = mod.gzip_handler(app, allow_compressed_requests=True)
        outs.append(serve(mw, "gzip", HTTP_CONTENT_ENCODING=encoding,
                          **{"wsgi.input": io.BytesIO(blob)}))
    assert outs[0] == outs[1]
    assert seen[0] == seen[1] == (payload, str(len(payload)), False)


@pytest.mark.parametrize("encoding", ("gzip", "zstd"))
def test_transport_equals_jax(encoding):
    payload = corpus.corpus_blocks(1, 6).tobytes()[:50_000]
    asked = []

    def server(method, url, headers, body):
        asked.append(dict(headers))
        blob = (jax_gzip.compress(payload) if encoding == "gzip"
                else Z.compress(payload, level=3, checksum=True))
        return 200, [("Content-Encoding", encoding),
                     ("Content-Length", str(len(blob)))], blob

    for enable_zstd in (True, False):
        ours = gzhttp.Transport(server, enable_zstd=enable_zstd)("GET", "/x")
        theirs = jax_gzhttp.Transport(server, enable_zstd=enable_zstd)(
            "GET", "/x")
        assert ours == theirs
        assert ours[2] == payload
    assert asked[0] == asked[1]
    # a caller that set Accept-Encoding itself gets the body as sent
    hdr = {"Accept-Encoding": "gzip"}
    raw = gzhttp.Transport(server)("GET", "/x", hdr)
    assert raw == jax_gzhttp.Transport(server)("GET", "/x", hdr)
    assert raw[1]["content-encoding"] == encoding
    assert gzhttp.Transport(server, always_decompress=True)(
        "GET", "/x", hdr)[2] == payload


def test_pluggable_compressors_equal_jax():
    calls = []

    def my_gzip(body, level):
        calls.append(level)
        return stdgzip.compress(body, 6, mtime=0)

    outs = [serve(mod.GzipMiddleware(make_app(), min_size=10,
                                     gzip_compress=my_gzip), "gzip")
            for mod in (gzhttp, jax_gzhttp)]
    assert outs[0] == outs[1]
    assert calls == [5, 5]
    assert stdgzip.decompress(b"".join(outs[0][2])) == BODY
