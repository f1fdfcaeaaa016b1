"""Micro-batched HTTP serving of the torch predictor.

    python -m multimodal_rare_disease_tpu_torch.cli.serve --checkpoint D
        [--mesh DPxTP [--backend nccl|gloo]]

  GET  /healthz   → {"status": "ok", "mode": ..., "device": <torch device>,
                     "batch_calls": ..., "mesh": {"data": .., "model": ..}
                     or null}
  POST /predict   → the predictor's JSON contract
       body: {"image": <base64 PNG/JPEG, or a path with --allow-paths>,
              "text": "...", "top_k": 5}

Concurrent requests are aggregated by a `MicroBatcher` for a few
milliseconds (`--window-ms`) and run as one `predict_batch`, so N
concurrent clients see about one batch latency. `MicroBatcher`,
`make_handler` and `_decode_image` are the port's own copies of the JAX
package's `cli/serve.py`. Request bodies are untrusted: filesystem paths
in "image" are rejected unless the operator passes --allow-paths
(optionally confined to --paths-root).

With `--mesh DPxTP` the command starts DP x TP ranks itself
(torch.multiprocessing): this process is rank 0, which holds the HTTP
server and the MicroBatcher and broadcasts each micro-batch to the other
ranks (`MeshLeader`); they run it with it (`follow`) and leave when it
shuts down. Rank 0 refuses malformed input before it broadcasts; a
batch that fails on any rank after that leaves the ranks out of step,
so the server stops and exits with 1. `--backend gloo` lets ranks share
one card.
"""

from __future__ import annotations

import argparse
import base64
import binascii
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional


def _decode_image(spec: str, allow_paths: bool = False,
                  paths_root: Optional[str] = None):
    """Request image spec → np.uint8 [S,S,3].

    Base64-encoded PNG/JPEG bytes by default. Filesystem paths are an
    operator opt-in (`allow_paths`), optionally confined under
    `paths_root` so a client can't read or probe arbitrary host files.
    """
    import numpy as np
    from PIL import Image

    from multimodal_rare_disease_tpu_torch.data.images import (
        load_image_uint8,
    )

    if allow_paths and len(spec) < 4096 and "\n" not in spec:
        path = os.path.realpath(spec)
        inside_root = paths_root is None or os.path.commonpath(
            [os.path.realpath(paths_root), path]
        ) == os.path.realpath(paths_root)
        if inside_root and os.path.exists(path):
            return load_image_uint8(path, 256)
    try:
        raw = base64.b64decode(spec, validate=True)
    except (binascii.Error, ValueError) as e:
        hint = ("an allowed path or " if allow_paths else "")
        raise ValueError(
            f"image is neither {hint}valid base64: {e}") from e
    with Image.open(io.BytesIO(raw)) as im:
        im = im.convert("RGB")
        if im.size != (256, 256):
            im = im.resize((256, 256), Image.BILINEAR)
        return np.asarray(im, np.uint8)


class _Item:
    __slots__ = ("image", "text", "top_k", "event", "result", "error")

    def __init__(self, image, text, top_k):
        self.image = image
        self.text = text
        self.top_k = top_k
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Aggregates concurrent predict requests into batched forwards.

    A worker thread owns the (non-reentrant) predict path. On the first
    queued request it waits up to `window_ms` for co-arriving requests
    (or until `max_batch` are queued), then runs them as one
    `predict_batch` call through the predictor's batch buckets. Under no
    concurrency the only cost against direct dispatch is the window
    wait; under load the card sees full batches.
    """

    def __init__(self, predictor, window_ms: float = 5.0,
                 max_batch: int = 256):
        self.predictor = predictor
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.batch_calls = 0  # observability: number of device forwards
        self._queue: List[_Item] = []
        self._cond = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    def submit(self, image, text, top_k: int = 5) -> dict:
        """Enqueue one request and block until its result is ready."""
        item = _Item(image, text, top_k)
        with self._cond:
            self._queue.append(item)
            self._cond.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self):
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._worker.join(timeout=5)

    # -- worker ------------------------------------------------------------

    def _drain(self) -> List[_Item]:
        """Block for the first request, then collect co-arrivals for up
        to window_s (or until max_batch)."""
        with self._cond:
            while not self._queue and not self._stop:
                self._cond.wait()
            if self._stop and not self._queue:
                return []
        deadline = time.monotonic() + self.window_s
        while True:
            with self._cond:
                if len(self._queue) >= self.max_batch or self._stop:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
        with self._cond:
            batch, self._queue = (self._queue[: self.max_batch],
                                  self._queue[self.max_batch:])
        return batch

    def _run(self):
        mode = self.predictor.mode
        while True:
            batch = self._drain()
            if not batch:
                if self._stop:
                    return
                continue
            try:
                images = ([it.image for it in batch]
                          if mode != "text_only" else None)
                texts = ([it.text for it in batch]
                         if mode != "image_only" else None)
                top_k = max(it.top_k for it in batch)
                self.batch_calls += 1
                results = self.predictor.predict_batch(
                    images=images, texts=texts, top_k=top_k)
                for it, res in zip(batch, results):
                    if it.top_k < top_k:
                        res = dict(res)
                        res["predictions"] = res["predictions"][: it.top_k]
                    it.result = res
                    it.event.set()
            except Exception as e:  # noqa: BLE001 — fail the whole batch
                for it in batch:
                    it.error = e
                    it.event.set()


def make_handler(batcher: MicroBatcher, allow_paths: bool = False,
                 paths_root: Optional[str] = None):
    predictor = batcher.predictor

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload, default=float).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                mesh = getattr(predictor, "mesh", None)
                self._send(200, {"status": "ok", "mode": predictor.mode,
                                 "device": str(predictor.device),
                                 "batch_calls": batcher.batch_calls,
                                 "mesh": mesh.shape if mesh else None})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                image = req.get("image")
                text = req.get("text", "")
                top_k = int(req.get("top_k", 5))
                img = (_decode_image(image, allow_paths, paths_root)
                       if image is not None else None)
                if predictor.mode != "text_only" and img is None:
                    raise ValueError(
                        f"mode {predictor.mode} requires an image")
                result = batcher.submit(img, text, top_k)
                self._send(200, result)
            except Exception as e:  # noqa: BLE001 — report, don't crash
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet access log
            pass

    return Handler


class MeshLeader:
    """Rank 0's face of a predictor on a rank mesh, for the MicroBatcher:
    each `predict_batch` is checked here, then broadcast to every rank,
    which runs it too (`follow`). While idle it broadcasts a ping every
    `ping_s` seconds, so the other ranks' wait stays inside the process
    group's timeout. A batch that fails after its broadcast leaves the
    ranks out of step: `failed` is set and the leader sends nothing
    more."""

    def __init__(self, predictor, ping_s: float = 60.0):
        from multimodal_rare_disease_tpu_torch.parallel.collectives import (
            object_device,
        )

        self.predictor = predictor
        self.mode = predictor.mode
        self.device = predictor.device
        self.mesh = predictor.mesh
        self.failed = threading.Event()
        self._axis = self.mesh.axis("world")
        self._where = object_device(self._axis, self.mesh.device)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._ping = threading.Thread(target=self._pinger, args=(ping_s,),
                                      daemon=True, name="mesh-ping")
        self._ping.start()

    def _send(self, msg: dict) -> None:
        from multimodal_rare_disease_tpu_torch.parallel.collectives import (
            broadcast_object,
        )

        broadcast_object(msg, self._axis, self._where)

    def _pinger(self, ping_s: float) -> None:
        while not self._stop.wait(ping_s):
            with self._lock:
                if self._stop.is_set():
                    return
                try:
                    self._send({"op": "ping"})
                except BaseException:
                    self.failed.set()
                    raise

    def predict_batch(self, images=None, texts=None, top_k: int = 5):
        import numpy as np

        # what every rank would refuse is refused here, before a rank
        # sees it: a rank's own slice is checked on that rank alone
        for img in images or ():
            if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
                    and img.ndim == 3 and img.shape[-1] == 3):
                raise ValueError("an image must be a decoded uint8 "
                                 "[H, W, 3] array")
        for text in texts or ():
            if not isinstance(text, str):
                raise ValueError(f"text must be a string, not "
                                 f"{type(text).__name__}")
        with self._lock:
            if self.failed.is_set():
                raise RuntimeError("the rank mesh is out of step")
            self._send({"op": "predict", "images": images, "texts": texts,
                        "top_k": int(top_k)})
            try:
                return self.predictor.predict_batch(
                    images=images, texts=texts, top_k=top_k)
            except BaseException:
                self.failed.set()
                self._stop.set()
                raise

    def close(self) -> None:
        """Stop every follower (not after a failure: they are not
        listening)."""
        with self._lock:
            self._stop.set()
            if not self.failed.is_set():
                self._send({"op": "stop"})


def follow(predictor) -> int:
    """A rank other than 0: run each micro-batch rank 0 broadcasts, until
    it stops; → the number of batches run. A batch that fails here is a
    fault of this rank (rank 0 refuses bad input before it broadcasts):
    it raises, the rank exits non-zero, and rank 0 stops serving."""
    from multimodal_rare_disease_tpu_torch.parallel.collectives import (
        broadcast_object,
        object_device,
    )

    axis = predictor.mesh.axis("world")
    where = object_device(axis, predictor.mesh.device)
    n = 0
    while True:
        msg = broadcast_object(None, axis, where)
        if msg["op"] == "stop":
            return n
        if msg["op"] == "predict":
            n += 1
            predictor.predict_batch(images=msg["images"], texts=msg["texts"],
                                    top_k=msg["top_k"])


def _watch_ranks(procs, leader: MeshLeader, server,
                 poll_s: float = 0.5) -> None:
    """Stop serving when a follower exits on a failure or the leader's
    batch failed after its broadcast: the mesh cannot answer again."""
    import sys

    while True:
        dead = [(r, p.exitcode) for r, p in enumerate(procs, 1)
                if p.exitcode not in (None, 0)]
        if dead or leader.failed.wait(poll_s):
            why = (f"rank {dead[0][0]} exited with code {dead[0][1]}"
                   if dead else "a batch failed on rank 0")
            print(f"serve: {why}; the rank mesh is out of step, stopping",
                  file=sys.stderr, flush=True)
            leader.failed.set()
            server.shutdown()
            return


def _mesh_predictor(args, data_axis: int, model_axis: int):
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.parallel.mesh import (
        create_mesh,
        rank_devices,
    )
    from multimodal_rare_disease_tpu_torch.parallel.distributed import (
        world_size,
    )

    mesh = create_mesh(data_axis=data_axis, model_axis=model_axis,
                       devices=rank_devices(world_size(), args.device))
    return load_predictor(args.checkpoint, args.device, mode=args.mode,
                          mesh=mesh)


def _follower(rank: int, world: int, args, data_axis: int,
              model_axis: int) -> int:
    import signal

    # the leader's shutdown stops this rank, not the terminal's ^C
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    return follow(_mesh_predictor(args, data_axis, model_axis))


def main(argv=None) -> int:
    from multimodal_rare_disease_tpu_torch.cli._common import (
        add_mesh_args,
        parse_mesh,
    )

    parser = argparse.ArgumentParser(
        description="Serve the torch predictor over HTTP")
    parser.add_argument("--checkpoint", required=True,
                        help="torch-package checkpoint directory")
    parser.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda, cuda:1 or cpu "
                        "(default: the card)")
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
    add_mesh_args(parser, "serve")
    args = parser.parse_args(argv)

    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )

    procs = []
    if args.mesh:
        import signal

        from multimodal_rare_disease_tpu_torch.parallel import distributed

        data_axis, model_axis = parse_mesh(parser, args.mesh)
        world = data_axis * model_axis
        init = distributed.file_init_method()
        procs = [distributed.spawn_rank(
            _follower, r, world, init, args.backend,
            args=(args, data_axis, model_axis)) for r in range(1, world)]

        def _terminate(*_):
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _terminate)
        distributed.maybe_initialize(init, world, 0, args.backend)
        predictor = MeshLeader(_mesh_predictor(args, data_axis, model_axis))
    else:
        predictor = load_predictor(args.checkpoint, args.device,
                                   mode=args.mode)
    batcher = MicroBatcher(predictor, window_ms=args.window_ms,
                           max_batch=args.max_batch)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(batcher, allow_paths=args.allow_paths,
                     paths_root=args.paths_root))
    if args.mesh:
        threading.Thread(target=_watch_ranks,
                         args=(procs, predictor, server), daemon=True,
                         name="mesh-watch").start()
    where = (f"{predictor.mesh.describe()} of {len(procs) + 1} ranks"
             if args.mesh else str(predictor.device))
    print(f"serving {predictor.mode} predictor on {where} at "
          f"http://{args.host}:{args.port} (POST /predict, GET /healthz; "
          f"micro-batch window {args.window_ms} ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()
        if args.mesh:
            from multimodal_rare_disease_tpu_torch.parallel import (
                distributed,
            )

            if predictor.failed.is_set():
                # a rank may be stuck in a collective: no more of them
                distributed.stop(procs, grace_s=0.0)
                return 1
            predictor.close()
            distributed.stop(procs, grace_s=30.0)
            distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
