"""Micro-batched HTTP serving of the torch predictor.

Reuses the JAX package's framework-free `MicroBatcher` and
`make_handler` (`multimodal_rare_disease_tpu/cli/serve.py`) as they
are: concurrent POST /predict requests are aggregated for `--window-ms`
and run as one `predict_batch`. Only GET /healthz is answered here,
because the shared handler reports a jax device there.

    python -m multimodal_rare_disease_tpu_torch.cli.serve --checkpoint D
"""

from __future__ import annotations

import argparse
from http.server import ThreadingHTTPServer
from typing import Optional

from multimodal_rare_disease_tpu.cli.serve import MicroBatcher, make_handler


def make_torch_handler(batcher: MicroBatcher, allow_paths: bool = False,
                       paths_root: Optional[str] = None):
    base = make_handler(batcher, allow_paths=allow_paths,
                        paths_root=paths_root)
    predictor = batcher.predictor

    class Handler(base):
        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, {"error": "unknown path"})
                return
            self._send(200, {"status": "ok", "mode": predictor.mode,
                             "device": str(predictor.device),
                             "batch_calls": batcher.batch_calls})

    return Handler


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Serve the torch predictor over HTTP")
    parser.add_argument("--checkpoint", required=True,
                        help="torch-package checkpoint directory")
    parser.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda, cuda:1 or cpu")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--mode", default=None)
    parser.add_argument("--window-ms", type=float, default=5.0,
                        help="micro-batch aggregation window")
    parser.add_argument("--max-batch", type=int, default=256)
    parser.add_argument("--allow-paths", action="store_true",
                        help="let requests reference local image paths")
    parser.add_argument("--paths-root", default=None,
                        help="confine --allow-paths to this directory")
    args = parser.parse_args(argv)

    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )

    predictor = load_predictor(args.checkpoint, args.device, mode=args.mode)
    batcher = MicroBatcher(predictor, window_ms=args.window_ms,
                           max_batch=args.max_batch)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_torch_handler(batcher, allow_paths=args.allow_paths,
                           paths_root=args.paths_root))
    print(f"serving {predictor.mode} predictor on {predictor.device} at "
          f"http://{args.host}:{args.port} (POST /predict, GET /healthz; "
          f"micro-batch window {args.window_ms} ms)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
