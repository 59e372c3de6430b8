"""Minimal HTTP front-end over :class:`~.batcher.DynamicBatcher`
(port of ``audio_diffusion_tpu/serving/server.py``).

Stdlib-only (``http.server``). Handler threads only parse JSON and block on
a future; all device work happens on the batcher's worker thread, so any
number of concurrent connections share full-tier batches.

API:

* ``GET  /healthz``  -> ``{"status": "ok", "sample_rate": ..., "tiers": [...], ...}``
  plus the batcher's ``latency_summary``.
* ``POST /generate`` -> body ``{"seed": int, "steps": int?, "eta": float?,
  "encoding": [[...]]?, "audio_pcm16_base64": str?, "start_step": int?,
  "format": "wav" | "json"}``. ``wav`` (default) responds ``audio/wav``;
  ``json`` responds the uint8 spectrogram (nested lists) and base64 16-bit
  PCM. 400 for a bad request, 429 with ``Retry-After`` when admission control
  sheds it, 500 when its batch failed, 503 while draining.

``AudioDiffusionServer.stop()`` drains and closes; a stopped server holds no
reference cycle, so dropping it frees its batcher and pipeline (with the
pipeline's CUDA graphs and graph pool) at once.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..ops.audio_io import wav_bytes
from .batcher import DynamicBatcher, QueueFull

logger = logging.getLogger("audio_diffusion_torch.serving")


class AudioDiffusionServer:
    """Owns a batcher and a ``ThreadingHTTPServer``; start/stop lifecycle.

    Nothing refers back to the server: the HTTP server holds the batcher and
    the settings its handlers read, and the handler class is one module-level
    class. So once the caller drops a stopped server, reference counting frees
    it, its batcher and its pipeline (with the pipeline's CUDA graphs and
    graph pool) at once, without waiting for the cycle collector."""

    def __init__(
        self,
        pipe,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_batch: int = 8,
        max_wait_ms: float = 25.0,
        batch_policy: str = "snap",
        steps: Optional[int] = None,
        eta: float = 0.0,
        allowed_steps=None,
        allowed_etas=None,
        allowed_start_steps=None,
        conditional_seq: int = 1,
        request_timeout_s: float = 600.0,
        max_queue: Optional[int] = None,
        max_group_queue: Optional[int] = None,
    ):
        self.batcher = DynamicBatcher(
            pipe, max_batch=max_batch, max_wait_ms=max_wait_ms,
            batch_policy=batch_policy, steps=steps,
            eta=eta, pcm16=True, allowed_steps=allowed_steps,
            allowed_etas=allowed_etas, allowed_start_steps=allowed_start_steps,
            conditional_seq=conditional_seq,
            max_queue=max_queue, max_group_queue=max_group_queue,
        )
        self.sample_rate = pipe.mel.get_sample_rate()
        self.request_timeout_s = request_timeout_s
        self.httpd = _HTTPServer((host, port), self.batcher, self.sample_rate, request_timeout_s)
        self._thread: Optional[threading.Thread] = None
        self._serving = False  # serve_forever was entered: shutdown() waits for it to return

    @property
    def address(self) -> tuple:
        return self.httpd.server_address

    def start(self) -> None:
        """Serve on a background thread (returns immediately)."""
        self._serving = True
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="adt-http", daemon=True)
        self._thread.start()
        logger.info("serving on http://%s:%d", *self.address[:2])

    def serve_forever(self) -> None:
        logger.info("serving on http://%s:%d", *self.address[:2])
        self._serving = True
        self.httpd.serve_forever()

    def stop(self) -> None:
        # Stop accepting -> drain the batcher (resolves every queued future so
        # blocked handlers can respond; late submits get 503) -> close, which
        # joins the non-daemon handler threads. A server never started has no
        # serve_forever to wait for: shutdown() would wait for ever.
        if self._serving:
            self.httpd.shutdown()
        self.batcher.close()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join()


class _HTTPServer(ThreadingHTTPServer):
    """The HTTP server with what its handlers read: the batcher, the sample
    rate, the request timeout. Non-daemon handler threads + a socket timeout
    on keep-alive reads: ``server_close()`` then waits for in-flight responses
    to be written (graceful drain), while idle keep-alive connections exit
    within the timeout instead of blocking shutdown."""

    daemon_threads = False

    def __init__(self, address, batcher: DynamicBatcher, sample_rate: int, request_timeout_s: float):
        self.batcher = batcher
        self.sample_rate = sample_rate
        self.request_timeout_s = request_timeout_s
        super().__init__(address, _Handler)


class _Handler(BaseHTTPRequestHandler):
    """One connection's requests; ``self.server`` is the :class:`_HTTPServer`."""

    protocol_version = "HTTP/1.1"
    timeout = 5  # idle keep-alive reads exit within this during shutdown

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.debug("%s " + fmt, self.client_address[0], *args)

    def _respond(self, code: int, body: bytes, content_type: str, headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _respond_json(self, code: int, obj, headers=()) -> None:
        self._respond(code, json.dumps(obj).encode(), "application/json", headers)

    def do_GET(self):
        if self.path == "/healthz":
            self._respond_json(200, {
                "status": "ok",
                "sample_rate": self.server.sample_rate,
                "tiers": list(self.server.batcher.tiers),
                "batches_run": self.server.batcher.batches_run,
                "requests_served": self.server.batcher.requests_served,
                **self.server.batcher.latency_summary(),
            })
        else:
            self._respond_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/generate":
            self._respond_json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            encoding = req.get("encoding")
            if encoding is not None:
                encoding = np.asarray(encoding, dtype=np.float32)
            audio = None
            if req.get("audio_pcm16_base64"):
                # Audio-to-audio: one 16-bit PCM clip at the model's
                # sample rate (clients resample; /healthz reports it).
                audio = np.frombuffer(
                    base64.b64decode(req["audio_pcm16_base64"]), dtype=np.int16
                ).astype(np.float32) / 32767.0
            fut = self.server.batcher.submit(
                seed=int(req.get("seed", 0)),
                steps=req.get("steps"),
                eta=req.get("eta"),
                encoding=encoding,
                audio=audio,
                start_step=int(req.get("start_step", 0)),
            )
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._respond_json(400, {"error": str(e)})
            return
        except QueueFull as e:  # admission control: shed, don't queue
            retry = max(1, int(round(e.retry_after_s)))
            self._respond_json(429, {"error": str(e), "retry_after_s": retry},
                               headers=[("Retry-After", str(retry))])
            return
        except RuntimeError as e:  # "batcher is closed" during drain
            self._respond_json(503, {"error": str(e)})
            return
        try:
            result = fut.result(timeout=self.server.request_timeout_s)
        except Exception as e:
            self._respond_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if req.get("format", "wav") == "json":
            self._respond_json(200, {
                "sample_rate": result.sample_rate,
                "image": result.image.tolist(),
                "pcm16_base64": base64.b64encode(
                    np.ascontiguousarray(result.audio, dtype=np.int16).tobytes()
                ).decode(),
            })
        else:
            self._respond(200, wav_bytes(result.audio, result.sample_rate), "audio/wav")


def make_server(
    model_dir: str,
    dtype: Optional[str] = None,
    fused_groupnorm: Optional[bool] = None,
    device: str = "cuda",
    mesh_data: Optional[int] = None,
    mesh_devices: Optional[list] = None,
    **kw,
) -> AudioDiffusionServer:
    """Load a pipeline directory in the diffusers layout
    (``AudioDiffusionPipeline.from_pretrained``) and wrap it in a server.
    ``dtype`` and ``fused_groupnorm`` override the loaded compute settings;
    ``fused_groupnorm=True`` routes the UNet's GroupNorm+SiLU through the
    CUDA kernel.

    ``mesh_data=N`` shards serving over N devices (``pipe.shard``): one
    replica each, every batch split along the mesh's 'data' axis, tiers
    multiples of N. The devices are the first N cards (on the CPU, N shares of
    the one CPU device), or ``mesh_devices`` when given (a device may repeat)."""
    from ..parallel.mesh import make_mesh
    from ..pipelines.pipeline import AudioDiffusionPipeline

    pipe = AudioDiffusionPipeline.from_pretrained(model_dir, dtype=dtype, fused_groupnorm=fused_groupnorm,
                                                  device=device)
    if mesh_data is not None or mesh_devices is not None:
        if mesh_devices is None:
            if torch.device(device).type == "cuda":
                if mesh_data > torch.cuda.device_count():
                    raise ValueError(f"mesh_data={mesh_data} needs {mesh_data} cards, this machine has "
                                     f"{torch.cuda.device_count()}")
                mesh_devices = [f"cuda:{i}" for i in range(mesh_data)]
            else:
                mesh_devices = [device] * mesh_data
        pipe.shard(make_mesh(num_data=mesh_data, devices=mesh_devices))
    return AudioDiffusionServer(pipe, **kw)
