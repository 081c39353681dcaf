"""``tpurun-serve-torch``: the HTTP serving daemon over the continuous
engine, the port of ``dlrover_tpu/launcher/serve.py``.

Restores the parameters from a checkpoint that the port's trainer wrote
(the train state's ``params``, read through ``CheckpointEngine.load``),
stands up the continuous-batching scheduler (``models/serving.py``) on the
GPU and answers over HTTP:

    POST /v1/completions        {"prompt": [ids...], "max_tokens": n?,
                                 "prefix_id": id?, "allowed_tokens": [ids]?,
                                 "stream": bool?}   -> a completion, or a
                                chunked NDJSON token stream ending with a
                                done line when "stream": true
    POST /v1/prefixes           {"tokens": [ids...]} -> {"prefix_id"}
    DELETE /v1/prefixes         {"prefix_id": id}    -> {"removed"}
    POST /v1/weights/reload     {"async": bool?}     -> hot swap from the
                                checkpoint directory
    GET  /healthz               -> the engine's stats: latency percentiles,
                                tokens_per_s, the phase split

One driver thread owns every device call; HTTP handler threads reach the
engine through an inbox of futures, so concurrent requests batch into the
engine's decode slots.

    python3 -m dlrover_tpu_torch.launcher.serve --ckpt-dir DIR --config JSON
    curl -d '{"prompt": [5, 9, 2]}' localhost:8311/v1/completions

It runs on the GPU, and on the CPU only with ``--cpu``; without a GPU and
without ``--cpu`` it raises. Once listening it prints one record line,
``serve {"port": ..., "step": ..., "device": ...}``; SIGTERM stops it.

Not ported (each raises ``not_ported``): ``--speculative-draft``,
``--cache-layout paged`` (``--kv-block-size`` and ``--kv-pool-blocks``
serve only it), ``--role prefill`` and ``/v1/prefill`` (a 501), and
``--replica-id`` under a fleet (the flag is kept and reported).
"""

import argparse
import json
import os
import queue
import signal
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import ThreadingHTTPServer

from ..common.log import logger, write_line
from ..common.platform import not_ported

__all__ = ["ServingDaemon", "main"]


class ServingDaemon:
    """Driver thread that owns a ContinuousBatchingEngine: requests and
    weight swaps arrive through a thread-safe inbox, completions resolve
    futures. With the overlapped engine round ``engine.pending`` stays true
    while a dispatched chunk's outputs are unread, so the loop keeps
    stepping until the tail drains; streaming ``partial()`` reads lag the
    device by one chunk."""

    def __init__(self, engine, rng_seed: int = 0):
        import torch

        self.eng = engine
        self._rng = torch.Generator(device=engine.device).manual_seed(rng_seed)
        self._inbox: "queue.Queue[tuple]" = queue.Queue()
        self._waiters = {}
        self._stream_uids = set()
        self._stream_done = {}
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self.served = 0
        self._thread = threading.Thread(target=self._loop, name="serving-driver", daemon=True)

    def start(self) -> "ServingDaemon":
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        self._fail_all(RuntimeError("serving daemon stopped"))

    # -- client surface (any thread) -----------------------------------

    def _submit_item(self, kind: str, payload, timeout: float, cancel_on_timeout: bool = False):
        if self._stop.is_set():
            raise RuntimeError("serving daemon stopped")
        fut: Future = Future()
        self._inbox.put((kind, payload, fut))
        try:
            return fut.result(timeout)
        except FutureTimeout:
            if cancel_on_timeout:
                self._inbox.put(("cancel_fut", fut, None))
            raise

    def complete(self, prompt, timeout: float = 300.0, max_new_tokens=None, prefix_id=None,
                 allowed_tokens=None):
        """Submit one prompt and block until its Completion arrives; on a
        timeout the request is cancelled on the engine."""
        return self._submit_item("req", (list(prompt), max_new_tokens, prefix_id,
                                         allowed_tokens), timeout, cancel_on_timeout=True)

    def submit_streaming(self, prompt, max_new_tokens=None, prefix_id=None,
                         allowed_tokens=None, timeout: float = 60.0) -> int:
        """Submit without blocking for the completion: the uid, to poll with
        :meth:`partial` and collect with :meth:`result`."""
        return self._submit_item("req_stream", (list(prompt), max_new_tokens, prefix_id,
                                                allowed_tokens), timeout, cancel_on_timeout=True)

    def partial(self, uid: int):
        """(tokens emitted so far, finished) for a streaming uid."""
        with self._mu:
            done = self._stream_done.get(uid)
        if isinstance(done, Exception):
            raise done
        if done is not None:
            return list(done.tokens), True
        toks = self.eng.partial(uid)
        if toks is not None:
            return toks, False
        return [], False  # still queued (or cancelled)

    def result(self, uid: int, timeout: float = 300.0):
        """Block for a streaming request's final Completion."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mu:
                c = self._stream_done.pop(uid, None)
            if isinstance(c, Exception):
                raise c
            if c is not None:
                return c
            if self._stop.is_set():
                raise RuntimeError("serving daemon stopped")
            time.sleep(0.02)
        self.cancel(uid)
        raise FutureTimeout(f"streaming uid {uid} timed out")

    def cancel(self, uid: int, timeout: float = 30.0) -> bool:
        """Abort a request by uid (a streaming client that disconnected)."""
        try:
            return self._submit_item("cancel_uid", uid, timeout)
        except Exception as e:  # noqa: BLE001 - the daemon is stopping
            logger.debug("cancel of uid=%s not delivered: %r", uid, e)
            return False

    def register_prefix(self, tokens, timeout: float = 60.0) -> int:
        return self._submit_item("prefix", list(tokens), timeout)

    def unregister_prefix(self, prefix_id: int, timeout: float = 60.0) -> bool:
        return self._submit_item("unprefix", int(prefix_id), timeout)

    def swap_params(self, params, timeout: float = 300.0) -> float:
        """Hand new params to the driver; the swap latency once adopted."""
        return self._submit_item("params", params, timeout)

    def swap_params_async(self, params, timeout: float = 300.0) -> bool:
        """Non-blocking swap: adopted at the first chunk boundary after the
        copies land (``last_swap_latency_s`` in the stats)."""
        return self._submit_item("params_async", params, timeout)

    # -- driver thread ---------------------------------------------------

    def _handle(self, kind, payload, fut) -> None:
        if kind in ("req", "req_stream"):
            prompt, cap, prefix_id, allowed = payload
            uid = self.eng.submit(prompt, max_new_tokens=cap, prefix_id=prefix_id,
                                  allowed_tokens=allowed)
            with self._mu:
                if kind == "req":
                    self._waiters[uid] = fut
                else:
                    self._stream_uids.add(uid)
            if kind == "req_stream":
                fut.set_result(uid)
        elif kind == "cancel_uid":
            with self._mu:
                self._waiters.pop(payload, None)
                self._stream_uids.discard(payload)
                self._stream_done.pop(payload, None)
            fut.set_result(self.eng.cancel(payload))
        elif kind == "cancel_fut":
            # payload is the abandoned future: a plain completion's is in
            # _waiters; a streaming submit's resolved with its uid
            with self._mu:
                uid = next((u for u, f in self._waiters.items() if f is payload), None)
                if uid is not None:
                    self._waiters.pop(uid, None)
            if uid is None and payload.done() and isinstance(payload.result(), int):
                uid = payload.result()
                with self._mu:
                    self._stream_uids.discard(uid)
                    self._stream_done.pop(uid, None)
            if uid is not None:
                self.eng.cancel(uid)
        elif kind == "prefix":
            fut.set_result(self.eng.register_prefix(payload))
        elif kind == "unprefix":
            self.eng.unregister_prefix(payload)
            fut.set_result(True)
        elif kind == "params":
            fut.set_result(self.eng.set_params(payload))
        elif kind == "params_async":
            self.eng.set_params_async(payload)
            fut.set_result(True)

    def _drain_inbox(self, block: bool):
        try:
            item = self._inbox.get(timeout=0.1 if block else 0.0)
        except queue.Empty:
            return
        while item is not None:
            kind, payload, fut = item
            try:
                self._handle(kind, payload, fut)
            except Exception as e:  # noqa: BLE001 - a per-request failure
                if fut is not None:  # cancel items carry no future
                    fut.set_exception(e)
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                item = None

    def _fail_all(self, exc: Exception) -> None:
        """Resolve every in-flight and queued future with ``exc``: a dead
        driver fails its clients fast."""
        with self._mu:
            waiters, self._waiters = self._waiters, {}
            for uid in self._stream_uids:
                self._stream_done[uid] = exc
            self._stream_uids.clear()
        for fut in waiters.values():
            if fut is not None and not fut.done():
                fut.set_exception(exc)
        while True:
            try:
                _, _, fut = self._inbox.get_nowait()
            except queue.Empty:
                break
            if fut is not None and not fut.done():
                fut.set_exception(exc)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._drain_inbox(block=not self.eng.pending)
                if self.eng.pending:
                    self.eng.step(self._rng)
                else:
                    # an idle engine never steps: adopt a landed async swap
                    self.eng.poll_pending_swap()
                for c in self.eng.drain_completions():
                    with self._mu:
                        fut = self._waiters.pop(c.uid, None)
                        streaming = c.uid in self._stream_uids
                        if streaming:
                            self._stream_uids.discard(c.uid)
                            self._stream_done[c.uid] = c
                    if fut is not None:
                        fut.set_result(c)
                        self.served += 1
                    elif streaming:
                        self.served += 1
            except Exception as e:  # noqa: BLE001 - the driver must not die silently
                logger.exception("serving driver error: %s", e)
                self._fail_all(RuntimeError(f"serving driver error: {e!r}"))


# -- checkpoint restore and model construction -----------------------------------


def _build_model(family: str, config: dict, device=None):
    """The model of ``family`` ("gpt" or "llama") for ``config`` (the
    config's keyword arguments) on ``device`` (the GPU by default)."""
    if family == "llama":
        from ..models.llama import Llama, LlamaConfig

        return Llama(LlamaConfig(**config), device=device)
    from ..models.gpt import GPT, GPTConfig

    return GPT(GPTConfig(**config), device=device)


_RESTORE_LOCK = threading.Lock()


def _restore_params(model, ckpt_dir: str):
    """The serving parameters from a checkpoint of the port's trainer:
    ``(step, {name: tensor})``, the train state's ``params`` on the model's
    device.

    - The template holds the params alone (fresh tensors shaped as the
      model's): no optimizer moments are allocated or copied.
    - It runs under a serve-private IPC namespace: the standalone engine's
      shm segment is named within a namespace, and a co-located trainer owns
      that name in the job's namespace; the unlink here must never destroy
      the trainer's. The lock serializes concurrent reloads."""
    import torch

    from ..checkpoint.engine import CheckpointEngine

    with _RESTORE_LOCK:
        template = {"params": {n: torch.empty_like(p) for n, p in model.named_parameters()}}
        prev_ns = os.environ.get("DLROVER_IPC_NAMESPACE")
        os.environ["DLROVER_IPC_NAMESPACE"] = f"tpurun_serve_{os.getpid()}"
        engine = None
        try:
            engine = CheckpointEngine(ckpt_dir, standalone=True, prefetch_restore=False)
            step, restored = engine.load(template)
            if restored is None:
                raise FileNotFoundError(f"no restorable checkpoint under {ckpt_dir}")
            return step, restored["params"]
        finally:
            if engine is not None:
                engine.shm.unlink()
                engine.close()
            if prev_ns is None:
                os.environ.pop("DLROVER_IPC_NAMESPACE", None)
            else:
                os.environ["DLROVER_IPC_NAMESPACE"] = prev_ns


# -- HTTP front end ------------------------------------------------------------------


def _completion_json(c) -> dict:
    return {"uid": c.uid, "tokens": c.tokens, "logprobs": c.logprobs,
            "queue_s": round(c.queue_s, 4), "ttft_s": round(c.ttft_s, 4),
            "total_s": round(c.total_s, 4)}


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _make_handler(daemon: ServingDaemon, reload_fn, replica_id=None, role="decode"):
    from ..common.http import JsonRequestHandler

    class Handler(JsonRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("serve: " + fmt, *args)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            stats = daemon.eng.stats()
            self._send(200, {
                "replica_id": replica_id,
                "role": role,
                "served": daemon.served,
                "pending": daemon.eng.pending,
                "slots": daemon.eng.B,
                "prompt_width": daemon.eng.Pw,
                "max_new_tokens": daemon.eng.s.max_new_tokens,
                "serving_host_frac": (stats.get("phase_split") or {}).get("serving_host_frac"),
                **stats,
            })

        def _stream_completion(self, prompt, max_tokens, prefix_id, allowed, timeout):
            """NDJSON chunked streaming: one {"tokens": [...]} line a poll
            with new tokens, then a final line with the whole completion. A
            socket failure cancels the request on the engine."""
            try:
                uid = daemon.submit_streaming(prompt, max_new_tokens=max_tokens,
                                              prefix_id=prefix_id, allowed_tokens=allowed)
            except ValueError as e:
                self._send(400, {"error": repr(e)[:200]})
                return
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": repr(e)[:200]})
                return

            def chunk(obj):
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            sent = 0
            deadline = time.monotonic() + timeout
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                while time.monotonic() < deadline:
                    toks, finished = daemon.partial(uid)
                    if len(toks) > sent:
                        chunk({"uid": uid, "tokens": toks[sent:]})
                        sent = len(toks)
                    if finished:
                        c = daemon.result(uid, timeout=5.0)
                        chunk({**_completion_json(c), "done": True})
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                        return
                    time.sleep(0.02)
                daemon.cancel(uid)
                chunk({"uid": uid, "error": "timeout"})
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                daemon.cancel(uid)  # the client hung up: free the slot
            except Exception as e:  # noqa: BLE001 - a driver-side failure
                daemon.cancel(uid)
                try:
                    chunk({"uid": uid, "error": repr(e)[:200]})
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

        def do_DELETE(self):
            try:
                body = self._body()
            except ValueError as e:
                self._send(400, {"error": f"bad json: {e}"})
                return
            if self.path != "/v1/prefixes":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            pid = body.get("prefix_id")
            if not _is_int(pid):
                self._send(400, {"error": "prefix_id must be int"})
                return
            try:
                daemon.unregister_prefix(pid)
            except KeyError:
                self._send(404, {"error": f"unknown prefix_id {pid}"})
                return
            except ValueError as e:  # still referenced by the queue
                self._send(409, {"error": repr(e)[:200]})
                return
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": repr(e)[:200]})
                return
            self._send(200, {"removed": pid})

        def _completions(self, body):
            if "prefilled" in body:
                self._send(501, {"error": str(not_ported("prefilled completions (prefill/"
                                                         "decode disaggregation)"))})
                return
            prompt = body.get("prompt")
            if not isinstance(prompt, list) or not all(_is_int(t) for t in prompt):
                self._send(400, {"error": "prompt must be a list of token ids"})
                return
            max_tokens = body.get("max_tokens")
            if max_tokens is not None and not _is_int(max_tokens):
                self._send(400, {"error": "max_tokens must be int"})
                return
            allowed = body.get("allowed_tokens")
            if allowed is not None and (not isinstance(allowed, list)
                                        or not all(_is_int(t) for t in allowed)):
                self._send(400, {"error": "allowed_tokens must be a list of ids"})
                return
            prefix_id = body.get("prefix_id")
            if prefix_id is not None and not _is_int(prefix_id):
                self._send(400, {"error": "prefix_id must be int"})
                return
            try:
                timeout = float(body.get("timeout", 300.0))
            except (TypeError, ValueError):
                self._send(400, {"error": "timeout must be a number"})
                return
            if body.get("stream", False):
                self._stream_completion(prompt, max_tokens, prefix_id, allowed, timeout)
                return
            try:
                c = daemon.complete(prompt, timeout=timeout, max_new_tokens=max_tokens,
                                    prefix_id=prefix_id, allowed_tokens=allowed)
            except ValueError as e:  # the client's: a bad prompt
                self._send(400, {"error": repr(e)[:200]})
                return
            except Exception as e:  # noqa: BLE001 - the server's
                self._send(500, {"error": repr(e)[:200]})
                return
            self._send(200, _completion_json(c))

        def _prefixes(self, body):
            tokens = body.get("tokens")
            if not isinstance(tokens, list) or not all(_is_int(t) for t in tokens):
                self._send(400, {"error": "tokens must be a list of token ids"})
                return
            try:
                pid = daemon.register_prefix(tokens)
            except ValueError as e:
                self._send(400, {"error": repr(e)[:200]})
                return
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": repr(e)[:200]})
                return
            self._send(200, {"prefix_id": pid})

        def _reload(self, body):
            if reload_fn is None:
                self._send(400, {"error": "no --ckpt-dir to reload from"})
                return
            swap_async = bool(body.get("async", False))
            try:
                step, params = reload_fn()
                if swap_async:
                    daemon.swap_params_async(params)
                else:
                    lat = daemon.swap_params(params)
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": repr(e)[:200]})
                return
            if swap_async:
                self._send(200, {"step": step, "accepted": True})
            else:
                self._send(200, {"step": step, "swap_latency_s": round(lat, 4)})

        def do_POST(self):
            try:
                body = self._body()
            except ValueError as e:
                self._send(400, {"error": f"bad json: {e}"})
                return
            routes = {"/v1/completions": self._completions, "/v1/prefixes": self._prefixes,
                      "/v1/weights/reload": self._reload}
            if self.path == "/v1/prefill":
                self._send(501, {"error": str(not_ported("/v1/prefill (prefill/decode "
                                                         "disaggregation)"))})
            elif self.path in routes:
                routes[self.path](body)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

    return Handler


def serve(daemon: ServingDaemon, port: int, reload_fn=None, replica_id=None, role="decode"):
    """Bind and return the HTTP server (the caller runs serve_forever)."""
    return ThreadingHTTPServer(("0.0.0.0", port), _make_handler(daemon, reload_fn,
                                                                replica_id=replica_id, role=role))


DEFAULT_CONFIG = dict(vocab_size=256, max_seq_len=512, num_layers=2, num_heads=4, head_dim=16,
                      embed_dim=64, use_remat=False)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpurun-serve-torch",
                                 description="serving daemon over the continuous engine")
    ap.add_argument("--family", choices=["gpt", "llama"], default="gpt")
    ap.add_argument("--config", default="",
                    help="model config as JSON (kwargs of GPTConfig/LlamaConfig); default is a "
                         "small smoke model")
    ap.add_argument("--ckpt-dir", default="", help="checkpoint of the port's trainer to restore")
    ap.add_argument("--port", type=int, default=8311, help="0 binds a free port")
    ap.add_argument("--replica-id", type=int, default=None,
                    help="fleet member id, reported on /healthz")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--prompt-width", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--speculative-draft", type=int, default=0, metavar="K",
                    help="the speculative scheduler (not ported: raises)")
    ap.add_argument("--sync-round", action="store_true",
                    help="the host-serial scheduler round (the A/B baseline); the default is "
                         "the overlapped round")
    ap.add_argument("--auto-chunk", action="store_true",
                    help="retune --decode-chunk from the measured serving_host_frac")
    ap.add_argument("--kv-int8", action="store_true", help="int8 decode KV cache")
    ap.add_argument("--cache-layout", choices=["frontier", "per_row", "paged"],
                    default="per_row",
                    help="per_row (default) or frontier; paged is not ported (raises)")
    ap.add_argument("--kv-block-size", type=int,
                    default=int(os.getenv("DLROVER_KV_BLOCK_SIZE") or 16),
                    help="paged layout only (not ported)")
    ap.add_argument("--kv-pool-blocks", type=int,
                    default=int(os.getenv("DLROVER_KV_POOL_BLOCKS") or 0),
                    help="paged layout only (not ported)")
    ap.add_argument("--role", choices=["prefill", "decode"], default="decode",
                    help="disaggregation role; prefill is not ported (raises)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def _check_ported(ns) -> None:
    if ns.speculative_draft > 0:
        raise not_ported("--speculative-draft (SpeculativeBatchingEngine)")
    if ns.cache_layout == "paged":
        raise not_ported("--cache-layout paged (models/kv_blocks.py)")
    if ns.role == "prefill":
        raise not_ported("--role prefill (prefill/decode disaggregation)")


def main(argv=None) -> int:
    ns = _parser().parse_args(argv)
    _check_ported(ns)

    from ..common.platform import resolve_device
    from ..models.generation import SamplingConfig
    from ..models.serving import ContinuousBatchingEngine

    device = resolve_device("cpu" if ns.cpu else None)
    config = dict(DEFAULT_CONFIG if not ns.config else json.loads(ns.config))
    if ns.kv_int8:
        config["kv_cache_int8"] = True
    model = _build_model(ns.family, config, device)
    reload_fn, step = None, None
    if ns.ckpt_dir:
        def reload_fn():
            return _restore_params(model, ns.ckpt_dir)

        step, params = reload_fn()
        logger.info("restored checkpoint step %s from %s", step, ns.ckpt_dir)
    else:
        params = None  # the model's own seed-0 weights
        logger.warning("no --ckpt-dir: serving RANDOM weights (smoke mode)")
    sampling = SamplingConfig(max_new_tokens=ns.max_new_tokens, temperature=ns.temperature,
                              top_k=ns.top_k, top_p=ns.top_p, eos_id=ns.eos_id)
    engine = ContinuousBatchingEngine(
        model, params, sampling, batch_size=ns.batch_size, prompt_width=ns.prompt_width,
        decode_chunk=ns.decode_chunk, cache_layout=ns.cache_layout, overlap=not ns.sync_round,
        auto_chunk=ns.auto_chunk, kv_block_size=ns.kv_block_size,
        kv_pool_blocks=ns.kv_pool_blocks)
    daemon = ServingDaemon(engine).start()
    httpd = serve(daemon, ns.port, reload_fn, replica_id=ns.replica_id, role=ns.role)

    def _on_term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _on_term)
    logger.info("tpurun-serve-torch on :%s: %s slots x %s new tokens, prompt width %s, %s",
                httpd.server_address[1], ns.batch_size, ns.max_new_tokens, ns.prompt_width,
                device)
    write_line("serve " + json.dumps({"port": httpd.server_address[1], "step": step,
                                      "device": str(device), "pid": os.getpid()}))
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        daemon.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
