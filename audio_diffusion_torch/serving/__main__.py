"""Serve a pipeline directory over HTTP with dynamic request batching.

    python -m audio_diffusion_torch.serving --model DIR --port 8080 --max_batch 32 \
        --dtype bfloat16 --fused_groupnorm

Then:  curl -d '{"seed": 7}' localhost:8080/generate -o out.wav

DIR is a pipeline in the diffusers layout (``AudioDiffusionPipeline.save_pretrained``
or the JAX package's ``save_pipeline_torch``).
"""

import argparse
import logging
import signal
import sys
import threading


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", type=str, required=True, help="pipeline directory in the diffusers layout")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_batch", type=int, default=8, help="largest batch tier")
    p.add_argument("--batch_policy", type=str, default="snap", choices=["snap", "pad"],
                   help="batch assembly once the wait window closes: snap = largest tier <= queue depth; "
                        "pad = take all queued, pad to the next tier")
    p.add_argument("--max_wait_ms", type=float, default=25.0,
                   help="how long a lone request waits for batch companions")
    p.add_argument("--steps", type=int, default=None, help="denoise steps (default: the scheduler's)")
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--allow_steps", type=int, nargs="*", default=None,
                   help="additional per-request step counts to serve (each is warmed up; undeclared values "
                        "get 400)")
    p.add_argument("--allow_etas", type=float, nargs="*", default=None,
                   help="additional per-request eta values to serve")
    p.add_argument("--allow_start_steps", type=int, nargs="*", default=None,
                   help="audio-to-audio start_step values to serve (requests send audio_pcm16_base64 + "
                        "start_step)")
    p.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="compute-dtype override for the UNet and VAE")
    p.add_argument("--fused_groupnorm", action=argparse.BooleanOptionalAction, default=None,
                   help="route the UNet's GroupNorm+SiLU through the CUDA kernel (the saved config does not "
                        "carry this)")
    p.add_argument("--device", type=str, default="cuda", help="torch device to serve on")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="shard serving over N devices (the first N cards; batches split along 'data'; tiers become "
                        "multiples of N)")
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction, default=True,
                   help="run every batch tier once before accepting traffic")
    p.add_argument("--max_queue", type=int, default=None,
                   help="admission control: global queued-request cap (default 8x max_batch); over-capacity "
                        "submits get a fast 429 + Retry-After")
    p.add_argument("--max_group_queue", type=int, default=None,
                   help="per-settings-group queued-request cap (default: the global cap)")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from audio_diffusion_torch.serving import make_server

    server = make_server(
        a.model, dtype=a.dtype, fused_groupnorm=a.fused_groupnorm, device=a.device, mesh_data=a.mesh_data,
        host=a.host, port=a.port,
        max_batch=a.max_batch, max_wait_ms=a.max_wait_ms, steps=a.steps, eta=a.eta,
        batch_policy=a.batch_policy, allowed_steps=a.allow_steps, allowed_etas=a.allow_etas,
        allowed_start_steps=a.allow_start_steps, max_queue=a.max_queue, max_group_queue=a.max_group_queue,
    )
    if a.warmup:
        logging.info("warming up batch tiers %s", server.batcher.tiers)
        server.batcher.warmup()

    # Graceful drain on SIGTERM: the handler only unblocks serve_forever
    # (shutdown() on the signal-handling main thread would wait on itself);
    # the drain then runs on the main thread below.
    def _term(signum, frame):
        logging.info("SIGTERM: draining in-flight requests and shutting down")
        threading.Thread(target=server.httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    server.stop()  # synchronous: drain batches, resolve futures, close sockets
    return 0


if __name__ == "__main__":
    sys.exit(main())
