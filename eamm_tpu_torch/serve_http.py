"""HTTP front for ``RenderServer`` (PyTorch port): stdlib only
(``http.server`` and an npz wire format).

Counterpart of ``eamm_tpu/serve_http.py``, byte for byte on the wire: a
client of either package's server talks to the other's.  This layer only
translates HTTP <-> numpy; its handler threads enqueue numpy arrays on the
``RenderServer`` and wait, and never touch a tensor (the server's worker
thread does all device work, ``prepare_emotion`` included).

Endpoints
---------
- ``POST /render``: request body is an ``.npz`` with arrays ``source``
  ([256,256,3] float32 in [0,1]), ``waveform`` ([N] float32 at 16 kHz),
  ``pose`` ([M,7]) and optionally ``transformed`` (emotion frames: the
  emotional render) or ``emotion_id`` (a clip registered with
  ``PUT /emotion``).  Response is an ``.npz``: ``frames`` (uint8 RGB), or
  ``y``/``u``/``v`` planes when the pipeline delivers yuv420.
- ``PUT /emotion``: register an emotion clip once: body ``.npz`` with
  ``emotion_id`` (string) and ``transformed`` frames.  The server uploads
  the clip to the device and computes its trunk features
  (``EammPipeline.prepare_emotion``); later renders that name the id skip
  the frames' payload and upload.  Response: JSON ``{"frames": U}``.
- ``POST /render_stream``: the same request; a chunked response of
  length-prefixed npz segments (``<8-byte big-endian length><npz>``, each
  with ``start`` and the payload arrays), sent while the card renders the
  rest.  A zero length ends the stream.
- ``GET /stats``: JSON latency and occupancy counters.
- ``GET /healthz``: liveness.

``encode_request`` / ``encode_emotion_registration`` / ``decode_response``
/ ``iter_stream`` are the client side of the wire format.
"""
from __future__ import annotations

import collections
import io
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


# ------------------------------------------------------------ wire format

def encode_request(source, waveform, pose, transformed=None,
                   emotion_id=None) -> bytes:
    buf = io.BytesIO()
    arrays = {"source": np.asarray(source, np.float32),
              "waveform": np.asarray(waveform, np.float32),
              "pose": np.asarray(pose, np.float32)}
    if transformed is not None:
        arrays["transformed"] = np.asarray(transformed, np.float32)
    if emotion_id is not None:
        arrays["emotion_id"] = np.asarray(str(emotion_id))
    np.savez(buf, **arrays)
    return buf.getvalue()


def encode_emotion_registration(emotion_id, transformed) -> bytes:
    """Body for ``PUT /emotion``: name + emotion frames."""
    return _encode_arrays(emotion_id=np.asarray(str(emotion_id)),
                          transformed=np.asarray(transformed, np.float32))


def _encode_arrays(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_response(body: bytes) -> dict:
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


def iter_stream(fileobj):
    """Parse a /render_stream chunked body: yields dicts with ``start``
    (int) plus the payload arrays, until the zero-length terminator."""
    while True:
        header = fileobj.read(8)
        if len(header) < 8:
            raise IOError("truncated stream header")
        n = struct.unpack(">Q", header)[0]
        if n == 0:
            return
        blob = fileobj.read(n)
        if len(blob) < n:
            raise IOError("truncated stream segment")
        seg = decode_response(blob)
        seg["start"] = int(seg["start"])
        yield seg


def _payload_arrays(payload) -> dict:
    if isinstance(payload, tuple):        # yuv420 planes
        return {"y": payload[0], "u": payload[1], "v": payload[2]}
    return {"frames": payload}


# ------------------------------------------------------------------ server

class HttpRenderFront:
    """Serve a ``RenderServer`` over HTTP.

    Uses ``ThreadingHTTPServer``: each connection blocks on its own
    Future while the one worker inside ``RenderServer`` keeps coalescing
    dispatches, so concurrency is bounded by the batcher, not by the HTTP
    layer.  ``port=0`` picks a free port (see ``.port``).
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):     # no stderr chatter per request
                pass

            def _send(self, code, body: bytes, ctype="application/octet-stream",
                      extra=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, b"ok", "text/plain")
                elif self.path == "/stats":
                    self._send(200, json.dumps(front.server.stats()).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def _read_request(self):
                n = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(n)
                with np.load(io.BytesIO(body)) as z:
                    transformed = (z["transformed"]
                                   if "transformed" in z.files else None)
                    if transformed is None and "emotion_id" in z.files:
                        eid = str(z["emotion_id"])
                        with front._emotions_lock:
                            transformed = front._emotions.get(eid)
                            if transformed is not None:
                                # refresh recency so eviction is true LRU
                                front._emotions.move_to_end(eid)
                        if transformed is None:
                            raise KeyError(
                                f"unknown emotion_id {eid!r} (register it "
                                f"via PUT /emotion first)")
                    return z["source"], z["waveform"], z["pose"], transformed

            def do_PUT(self):
                if self.path != "/emotion":
                    self._send(404, b"not found", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    with np.load(io.BytesIO(self.rfile.read(n))) as z:
                        eid = str(z["emotion_id"])
                        frames = z["transformed"]
                    handle = front.server.prepare_emotion(frames)
                    front._register_emotion(eid, handle)
                    self._send(200, json.dumps(
                        {"frames": int(handle.n_frames)}).encode(),
                        "application/json")
                except Exception as e:
                    self._send(400, f"bad request: {e}".encode(), "text/plain")

            def do_POST(self):
                try:
                    src, wav, pose, transformed = self._read_request()
                except Exception as e:
                    self._send(400, f"bad request: {e}".encode(), "text/plain")
                    return
                try:
                    if self.path == "/render":
                        result = front.server.render(src, wav, pose,
                                                     transformed)
                        self._send(200, _encode_arrays(
                            **_payload_arrays(result)))
                    elif self.path == "/render_stream":
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        for start, payload in front.server.submit_stream(
                                src, wav, pose, transformed):
                            blob = _encode_arrays(
                                start=np.int64(start),
                                **_payload_arrays(payload))
                            self._chunk(struct.pack(">Q", len(blob)) + blob)
                        self._chunk(struct.pack(">Q", 0))
                        self._chunk(b"")          # chunked terminator
                    else:
                        self._send(404, b"not found", "text/plain")
                except BrokenPipeError:
                    self.close_connection = True  # client went away mid-stream
                except Exception as e:
                    if self.path == "/render":
                        self._send(500, f"render failed: {e}".encode(),
                                   "text/plain")
                    else:
                        # mid-stream failure after the 200 headers: force
                        # the keep-alive socket closed so the client's next
                        # read fails fast (truncated-stream IOError) instead
                        # of blocking forever on an unterminated body
                        self.close_connection = True

            def _chunk(self, data: bytes):
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

        self.server = server
        # registered emotion clips: id -> EmotionHandle, LRU-bounded (each
        # holds device memory: U frames and a [Ub, 512] feature table)
        self._emotions: collections.OrderedDict = collections.OrderedDict()
        self._emotions_lock = threading.Lock()
        self._emotions_max = 16
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _register_emotion(self, eid: str, handle):
        with self._emotions_lock:
            self._emotions.pop(eid, None)
            while len(self._emotions) >= self._emotions_max:
                self._emotions.popitem(last=False)
            self._emotions[eid] = handle

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
