"""gzhttp — transparent HTTP compression middleware (WSGI) + client helper.

Reference parity: gzhttp/ — GzipHandler/NewWrapper server middleware with
MinSize buffering, content-type filtering, Accept-Encoding q-value
negotiation (case-insensitive, RFC 7231), optional zstd responses
(EnableZstd/PreferZstd), BREACH-mitigating random length jitter
(RandomJitter), ETag suffix/drop, request-body decompression
(AllowCompressedRequests); and Transport, the client round-tripper that
advertises gzip+zstd and transparently decodes (gzhttp/transport.go).
The Go reference wraps http.Handler; the Python-native surface is WSGI.
The JAX package's ``gzhttp`` on the port's gzip and zstd; the jitter is a
hash of the content, so responses compare byte for byte.
"""

from __future__ import annotations

import hashlib
import io

from compress_tpu_torch import gzip as tgzip
from compress_tpu_torch import zstd as tzstd
from compress_tpu_torch.zstd.frame import write_skippable_frame

DEFAULT_MIN_SIZE = 1400  # reference: DefaultMinSize


def parse_accept_encoding(header: str) -> dict[str, float]:
    """Accept-Encoding with q-values, case-insensitive (RFC 7231 §5.3)."""
    out: dict[str, float] = {}
    for part in (header or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, params = part.partition(";")
        q = 1.0
        for p in params.split(";"):
            p = p.strip()
            if p.lower().startswith("q="):
                try:
                    q = float(p[2:])
                except ValueError:
                    q = 0.0
        out[name.strip().lower()] = q
    return out


def negotiate(header: str, zstd_enabled: bool, prefer_zstd: bool) -> str | None:
    accepted = parse_accept_encoding(header)
    gz = accepted.get("gzip", accepted.get("*", 0.0))
    zs = accepted.get("zstd", accepted.get("*", 0.0)) if zstd_enabled else 0.0
    if gz <= 0 and zs <= 0:
        return None
    if zs > 0 and (prefer_zstd or zs > gz or gz <= 0):
        return "zstd"
    return "gzip" if gz > 0 else None


class GzipMiddleware:
    """WSGI middleware — the GzipHandler/NewWrapper equivalent.

    Options mirror the reference: min_size (MinSize), level
    (CompressionLevel), content_types (ContentTypes), enable_zstd /
    prefer_zstd / zstd_level, suffix_etag / drop_etag, random_jitter
    (RandomJitter BREACH mitigation), allow_compressed_requests."""

    def __init__(self, app, min_size: int = DEFAULT_MIN_SIZE, level: int = 5,
                 content_types=None, except_content_types=None,
                 enable_zstd: bool = False, prefer_zstd: bool = False,
                 zstd_level: int = 2, suffix_etag: str = "",
                 drop_etag: bool = False, random_jitter: int = 0,
                 jitter_buffer: int = 1 << 16,
                 allow_compressed_requests: bool = False,
                 keep_accept_ranges: bool = False,
                 gzip_compress=None, zstd_compress=None):
        self.app = app
        self.min_size = min_size
        self.level = max(1, min(level, 9))
        self.content_types = content_types
        self.except_content_types = except_content_types
        self.enable_zstd = enable_zstd
        self.prefer_zstd = prefer_zstd
        self.zstd_level = zstd_level
        self.suffix_etag = suffix_etag
        self.drop_etag = drop_etag
        self.random_jitter = random_jitter
        self.jitter_buffer = jitter_buffer
        self.allow_compressed_requests = allow_compressed_requests
        self.keep_accept_ranges = keep_accept_ranges
        # pluggable compressor implementations (reference:
        # gzhttp/writer/interface.go GzipWriterFactory / ZstdWriterFactory
        # via the Implementation/ZstdImplementation options): callables
        # (body, level) -> compressed bytes replacing the built-ins
        self.gzip_compress = gzip_compress
        self.zstd_compress = zstd_compress

    @staticmethod
    def detect_content_type(data: bytes) -> str:
        """Sniff an untyped body (reference: gzhttp sniffs via
        http.DetectContentType before applying the type filter). Compact
        signature set + text/binary heuristic; always returns a type."""
        d = bytes(data[:512])
        s = d.lstrip(b" \t\r\n")
        low = s[:64].lower()
        for tag in (b"<!doctype html", b"<html", b"<head", b"<body",
                    b"<script", b"<iframe", b"<h1", b"<div", b"<p>",
                    b"<table", b"<a "):
            if low.startswith(tag):
                return "text/html; charset=utf-8"
        if low.startswith(b"<?xml"):
            return "text/xml; charset=utf-8"
        sigs = (
            (b"%PDF-", "application/pdf"),
            (b"\x1f\x8b", "application/x-gzip"),
            (b"PK\x03\x04", "application/zip"),
            (b"\x89PNG\r\n\x1a\n", "image/png"),
            (b"\xff\xd8\xff", "image/jpeg"),
            (b"GIF87a", "image/gif"),
            (b"GIF89a", "image/gif"),
            (b"BM", "image/bmp"),
            (b"OggS", "application/ogg"),
            (b"\x00\x00\x01\x00", "image/x-icon"),
            (b"fLaC", "audio/flac"),
            (b"\x28\xb5\x2f\xfd", "application/zstd"),
        )
        for sig, t in sigs:
            if d.startswith(sig):
                return t
        if d.startswith(b"RIFF") and d[8:12] == b"WAVE":
            return "audio/wave"
        if d.startswith(b"RIFF") and d[8:12] == b"WEBP":
            return "image/webp"
        text_ok = all(b >= 0x20 or b in (9, 10, 11, 12, 13, 27) for b in d)
        return ("text/plain; charset=utf-8" if text_ok
                else "application/octet-stream")

    def _type_ok(self, ctype: str) -> bool:
        base = (ctype or "").split(";")[0].strip().lower()
        if self.except_content_types and base in self.except_content_types:
            return False
        if self.content_types is not None:
            return base in self.content_types
        return True

    def __call__(self, environ, start_response):
        # request body decompression (AllowCompressedRequests)
        if self.allow_compressed_requests:
            ce = (environ.get("HTTP_CONTENT_ENCODING") or "").lower()
            if ce in ("gzip", "zstd"):
                body = environ["wsgi.input"].read()
                if ce == "gzip":
                    body, _ = tgzip.decompress(body)
                else:
                    body = tzstd.decompress(body)
                environ["wsgi.input"] = io.BytesIO(body)
                environ["CONTENT_LENGTH"] = str(len(body))
                del environ["HTTP_CONTENT_ENCODING"]

        enc = negotiate(environ.get("HTTP_ACCEPT_ENCODING", ""),
                        self.enable_zstd, self.prefer_zstd)
        captured = {}

        def cap_start(status, headers, exc_info=None):
            captured["status"] = status
            captured["headers"] = headers
            return lambda b: None

        # stream-aware buffering (reference: gzhttp buffers until MinSize
        # then streams compressed chunks as the handler writes,
        # gzhttp/compress.go:565): pull chunks until the decision
        # threshold; if the app is exhausted we keep the exact buffered
        # ("small response") behavior incl. Content-Length and the
        # bigger-than-body fallback; otherwise compress incrementally and
        # yield chunks as they are produced.
        it = iter(self.app(environ, cap_start))
        chunks = []
        size = 0
        exhausted = False
        threshold = max(self.min_size, 1)
        while size < threshold:
            try:
                c = next(it)
            except StopIteration:
                exhausted = True
                break
            chunks.append(c)
            size += len(c)
        tail_chunk = None
        if not exhausted:
            # one lookahead pull so single-yield bodies stay buffered
            try:
                tail_chunk = next(it)
            except StopIteration:
                exhausted = True
        body = b"".join(chunks)
        status = captured["status"]
        headers = list(captured["headers"])
        hmap = {k.lower(): v for k, v in headers}

        if not exhausted:
            return self._stream_response(environ, start_response, status,
                                         headers, hmap, body, tail_chunk, it)

        ctype = hmap.get("content-type", "")
        sniffed = None
        if not ctype and body:
            # untyped body: sniff before filtering (reference behavior)
            sniffed = self.detect_content_type(body)
            ctype = sniffed
        skip = (
            enc is None
            or len(body) < self.min_size
            or "content-encoding" in hmap
            or "content-range" in hmap
            or not self._type_ok(ctype)
        )
        if skip:
            start_response(status, headers)
            return [body]
        if sniffed is not None:
            headers.append(("Content-Type", sniffed))

        if enc == "zstd":
            if self.zstd_compress is not None:
                comp = self.zstd_compress(body, self.zstd_level)
            else:
                comp = tzstd.compress(body, level=self.zstd_level,
                                      checksum=True)
            if self.random_jitter:
                comp = self._jitter_zstd(comp, body) + comp
        else:
            if self.gzip_compress is not None:
                comp = self.gzip_compress(body, self.level)
            else:
                comp = tgzip.compress(body, self.level)
            if self.random_jitter:
                comp = self._jitter_gzip(body) + comp
        if len(comp) >= len(body):
            start_response(status, headers)
            return [body]

        out_headers = []
        for k, v in headers:
            kl = k.lower()
            if kl in ("content-length", "accept-ranges") and not (
                kl == "accept-ranges" and self.keep_accept_ranges
            ):
                continue
            if kl == "etag":
                if self.drop_etag:
                    continue
                if self.suffix_etag and v.endswith('"'):
                    v = v[:-1] + self.suffix_etag + '"'
            out_headers.append((k, v))
        out_headers.append(("Content-Encoding", enc))
        out_headers.append(("Vary", "Accept-Encoding"))
        out_headers.append(("Content-Length", str(len(comp))))
        start_response(status, out_headers)
        return [comp]

    def _stream_response(self, environ, start_response, status, headers,
                         hmap, buffered, tail_chunk, it):
        """Compress an unexhausted body incrementally: chunks reach the
        client as the app yields them (no Content-Length; the server
        chunk-encodes). Reference: gzhttp streams through pooled writers
        once past MinSize (gzhttp/compress.go:565)."""
        enc = negotiate(environ.get("HTTP_ACCEPT_ENCODING", ""),
                        self.enable_zstd, self.prefer_zstd)
        ctype = hmap.get("content-type", "")
        sniffed = None
        if not ctype and buffered:
            sniffed = self.detect_content_type(buffered)
            ctype = sniffed
        if (enc is None or "content-encoding" in hmap
                or "content-range" in hmap or not self._type_ok(ctype)):
            start_response(status, headers)

            def passthrough():
                if buffered:
                    yield buffered
                if tail_chunk is not None:
                    yield tail_chunk
                yield from it

            return passthrough()
        if sniffed is not None:
            headers.append(("Content-Type", sniffed))
        out_headers = []
        for k, v in headers:
            kl = k.lower()
            if kl in ("content-length", "accept-ranges") and not (
                kl == "accept-ranges" and self.keep_accept_ranges
            ):
                continue
            if kl == "etag":
                if self.drop_etag:
                    continue
                if self.suffix_etag and v.endswith('"'):
                    v = v[:-1] + self.suffix_etag + '"'
            out_headers.append((k, v))
        out_headers.append(("Content-Encoding", enc))
        out_headers.append(("Vary", "Accept-Encoding"))
        start_response(status, out_headers)

        class _Sink:
            def __init__(s):
                s.parts = []

            def write(s, b):
                s.parts.append(bytes(b))
                return len(b)

            def drain(s):
                if not s.parts:
                    return b""
                out = b"".join(s.parts)
                s.parts = []
                return out

        mw = self

        def gen():
            sink = _Sink()
            if enc == "zstd":
                from compress_tpu_torch.zstd import stream as _zs

                if mw.random_jitter:
                    n = mw._content_hash(buffered) % mw.random_jitter
                    yield write_skippable_frame(bytes(n), 0x50 & 0xF)
                w = _zs.Writer(sink, level=mw.zstd_level)
            else:
                if mw.random_jitter:
                    yield mw._jitter_gzip(buffered)
                w = tgzip.Writer(sink, level=mw.level)
            w.write(buffered)
            w.flush()
            d = sink.drain()
            if d:
                yield d
            if tail_chunk is not None:
                w.write(tail_chunk)
                d = sink.drain()
                if d:
                    yield d
            for c in it:
                if not c:
                    continue
                w.write(c)
                w.flush()
                d = sink.drain()
                if d:
                    yield d
            w.close()
            d = sink.drain()
            if d:
                yield d

        return gen()

    def _content_hash(self, body: bytes) -> int:
        h = hashlib.sha256(body[: self.jitter_buffer]).digest()
        return int.from_bytes(h[:4], "little")

    def _jitter_zstd(self, comp: bytes, body: bytes) -> bytes:
        # length hiding: content-derived padding in a skippable frame
        # (reference: writeZstdSkippableFrame, gzhttp/compress.go:480)
        n = self._content_hash(body) % self.random_jitter
        return write_skippable_frame(bytes(n), 0x50 & 0xF)

    def _jitter_gzip(self, body: bytes) -> bytes:
        # gzip jitter: an empty-name extra gzip member of padded size
        n = self._content_hash(body) % self.random_jitter
        return tgzip.compress(b"", 1, header=tgzip.Header(extra=bytes(n)))


def gzip_handler(app, **opts):
    """Reference: gzhttp.GzipHandler(h) — middleware with defaults."""
    return GzipMiddleware(app, **opts)


class Transport:
    """Client-side transparent decompression (reference: gzhttp.Transport).

    Wraps a callable request fn: (method, url, headers, body) ->
    (status, headers, body); advertises gzip+zstd and decodes responses."""

    def __init__(self, inner, enable_zstd: bool = True,
                 always_decompress: bool = False):
        self.inner = inner
        self.enable_zstd = enable_zstd
        self.always_decompress = always_decompress

    def __call__(self, method, url, headers=None, body=None):
        headers = dict(headers or {})
        asked = False
        if "accept-encoding" not in {k.lower() for k in headers}:
            headers["Accept-Encoding"] = "gzip,zstd" if self.enable_zstd else "gzip"
            asked = True
        status, rheaders, rbody = self.inner(method, url, headers, body)
        hmap = {k.lower(): v for k, v in rheaders.items()} if isinstance(
            rheaders, dict) else {k.lower(): v for k, v in rheaders}
        ce = hmap.get("content-encoding", "").lower()
        if (asked or self.always_decompress) and ce in ("gzip", "zstd"):
            if ce == "gzip":
                rbody, _ = tgzip.decompress(rbody)
            else:
                rbody = tzstd.decompress(rbody)
            hmap.pop("content-encoding", None)
            hmap.pop("content-length", None)
        return status, hmap, rbody


__all__ = [
    "GzipMiddleware", "gzip_handler", "Transport",
    "parse_accept_encoding", "negotiate", "DEFAULT_MIN_SIZE",
]
