"""The port's serving daemon (``dlrover_tpu_torch/launcher/serve.py``) on
the CPU: the driver thread and the HTTP handler on port 0, held to the
continuous engine run directly on the same weights; a reload from a
checkpoint that the port's ``CheckpointEngine`` wrote; the flags that are
not ported; and the CPU twin of ``chip_smoke.py``'s phase 14.
"""

import contextlib
import http.client
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import chip_smoke
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.examples import gpt_elastic
from dlrover_tpu_torch.launcher import serve
from dlrover_tpu_torch.models import generation, gpt, llama, serving

_CFG = dict(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, head_dim=8,
            embed_dim=16, use_remat=False)
_GREEDY = generation.SamplingConfig(max_new_tokens=6, temperature=0.0)
_PROMPTS = [[5, 9, 2], [7, 1, 4, 11], [3, 3], [8, 6, 1], [2], [9, 9, 9, 9, 1]]


def _engine(model, **kw):
    return serving.ContinuousBatchingEngine(model, None, _GREEDY, batch_size=2, prompt_width=16,
                                            decode_chunk=4, cache_layout="per_row", **kw)


def _request(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = raw if raw is not None else (None if body is None else json.dumps(body))
        conn.request(method, path, body=data)
        resp = conn.getresponse()
        text = resp.read().decode()
        if resp.getheader("Content-Type") == "application/x-ndjson":
            return resp.status, [json.loads(ln) for ln in text.splitlines() if ln.strip()]
        return resp.status, json.loads(text)
    finally:
        conn.close()


@contextlib.contextmanager
def _serving(model, reload_fn=None):
    """A daemon over ``model`` behind the HTTP handler on a free port:
    ``(port, daemon)``."""
    daemon = serve.ServingDaemon(_engine(model)).start()
    httpd = serve.serve(daemon, 0, reload_fn=reload_fn)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1], daemon
    finally:
        httpd.shutdown()
        httpd.server_close()
        daemon.stop()


@pytest.fixture
def server():
    """``(port, model, daemon)`` of a small GPT served on the CPU."""
    model = gpt.GPT(gpt.GPTConfig(**_CFG), device="cpu", seed=3)
    with _serving(model) as (port, daemon):
        yield port, model, daemon


def test_concurrent_completions_equal_the_engine(server):
    port, model, daemon = server
    with ThreadPoolExecutor(len(_PROMPTS)) as pool:
        answers = list(pool.map(
            lambda p: _request(port, "POST", "/v1/completions", {"prompt": p}), _PROMPTS))
    want = [c.tokens for c in _engine(model).run(_PROMPTS)]
    assert [code for code, _ in answers] == [200] * len(_PROMPTS)
    assert [a["tokens"] for _, a in answers] == want
    assert all(len(a["logprobs"]) == len(a["tokens"]) and a["ttft_s"] <= a["total_s"]
               for _, a in answers)
    code, capped = _request(port, "POST", "/v1/completions",
                            {"prompt": _PROMPTS[0], "max_tokens": 2})
    assert code == 200 and capped["tokens"] == want[0][:2]
    code, health = _request(port, "GET", "/healthz")
    assert code == 200 and health["completed_total"] == len(_PROMPTS) + 1
    assert health["served"] == len(_PROMPTS) + 1 and health["slots"] == 2
    assert health["tokens_per_s"] > 0 and health["latency_p50_s"] is not None
    assert health["phase_split"]["rounds"] > 0 and health["cache_layout"] == "per_row"


def test_streaming_sends_the_tokens_then_the_completion(server):
    port, model, _ = server
    code, lines = _request(port, "POST", "/v1/completions", {"prompt": _PROMPTS[1],
                                                             "stream": True})
    assert code == 200 and lines[-1]["done"]
    assert [t for ln in lines[:-1] for t in ln["tokens"]] == lines[-1]["tokens"]
    assert lines[-1]["tokens"] == _engine(model).run([_PROMPTS[1]])[0].tokens


def test_prefixes_and_constrained_requests_over_http(server):
    port, model, _ = server
    code, reg = _request(port, "POST", "/v1/prefixes", {"tokens": [11, 23, 5]})
    assert code == 200
    pid = reg["prefix_id"]
    code, got = _request(port, "POST", "/v1/completions", {"prompt": [7, 1], "prefix_id": pid})
    assert code == 200 and got["tokens"] == _engine(model).run([[11, 23, 5, 7, 1]])[0].tokens
    code, got = _request(port, "POST", "/v1/completions",
                         {"prompt": [7, 1], "allowed_tokens": [4, 40]})
    assert code == 200 and set(got["tokens"]) <= {4, 40}
    assert _request(port, "DELETE", "/v1/prefixes", {"prefix_id": pid}) == (200, {"removed": pid})
    assert _request(port, "DELETE", "/v1/prefixes", {"prefix_id": pid})[0] == 404


@pytest.mark.parametrize("body,code", [
    ({"prompt": "x"}, 400), ({"prompt": [1, "a"]}, 400), ({"prompt": [1], "max_tokens": True}, 400),
    ({"prompt": [1], "max_tokens": 99}, 400), ({"prompt": [1] * 17}, 400),
    ({"prompt": [1], "allowed_tokens": 3}, 400), ({"prompt": [1], "prefix_id": "a"}, 400),
    ({"prompt": [1], "prefix_id": 7}, 400), ({"prompt": [1], "timeout": "a"}, 400),
    ({"prefilled": {}}, 501),
])
def test_bad_requests_are_the_clients(server, body, code):
    port = server[0]
    got, payload = _request(port, "POST", "/v1/completions", body)
    assert got == code and "error" in payload


def test_unknown_paths_bad_json_and_what_is_not_ported(server):
    port = server[0]
    assert _request(port, "POST", "/v1/completions", raw="{nope")[0] == 400
    assert _request(port, "GET", "/nope")[0] == 404
    assert _request(port, "POST", "/nope", {})[0] == 404
    code, payload = _request(port, "POST", "/v1/prefill", {"tokens": [1]})
    assert code == 501 and "not ported" in payload["error"]


def _small_checkpoint(work, job, steps=2):
    """GPT's small example state after ``steps`` steps, persisted to
    ``work/ckpt`` by the port's CheckpointEngine: (the directory, {"step",
    "params_sha256"})."""
    ckpt = os.path.join(work, "ckpt")
    with chip_smoke._job_ipc(work, job):
        _, state, step_fn, batches = gpt_elastic.build(True, "cpu")
        for x, y in batches(0, steps):
            state, _ = step_fn(state, x, y)
        engine = CheckpointEngine(ckpt, standalone=True)
        try:
            assert engine.save_to_storage(steps, state)
            assert engine.wait_saving(120)
        finally:
            engine.shm.unlink()
            engine.close()
    return ckpt, {"step": steps, "params_sha256": chip_smoke.params_sha256(state.params)}


def test_reload_swaps_in_a_checkpoint_of_the_port_trainer(tmp_path):
    """``/v1/weights/reload`` restores the params of a checkpoint the port's
    CheckpointEngine wrote (a params-only template, hash-equal to the
    persisted ones) and swaps them in: the completions after it are the
    engine's on those weights. A checkpoint that does not fit the served
    model is the server's error, and the old weights keep serving."""
    ckpt, persisted = _small_checkpoint(str(tmp_path), f"serve_http_{os.getpid()}")
    model = gpt.GPT(gpt.GPTConfig(**chip_smoke._serve_config(True)), device="cpu", seed=5)
    step, params = serve._restore_params(model, ckpt)
    assert step == persisted["step"]
    assert chip_smoke.params_sha256(params) == persisted["params_sha256"]
    with _serving(model, lambda: serve._restore_params(model, ckpt)) as (port, _):
        code, reload = _request(port, "POST", "/v1/weights/reload", {})
        assert code == 200 and reload["step"] == persisted["step"]
        code, got = _request(port, "POST", "/v1/completions", {"prompt": _PROMPTS[0]})
        code, health = _request(port, "GET", "/healthz")
        assert health["last_swap_latency_s"] is not None
    twin = gpt.GPT(gpt.GPTConfig(**chip_smoke._serve_config(True)), device="cpu")
    twin.load_state_dict(params)
    assert got["tokens"] == _engine(twin).run([_PROMPTS[0]])[0].tokens
    other = gpt.GPT(gpt.GPTConfig(**_CFG), device="cpu", seed=3)
    with _serving(other, lambda: serve._restore_params(model, ckpt)) as (port, daemon):
        code, payload = _request(port, "POST", "/v1/weights/reload", {})
        assert code == 500 and "shape" in payload["error"]
        assert daemon.eng.stats()["swap_failures"] == 1
        assert _request(port, "POST", "/v1/completions", {"prompt": [1]})[0] == 200


def test_the_left_out_flags_raise_not_ported():
    for argv in (["--speculative-draft", "2"], ["--cache-layout", "paged"],
                 ["--role", "prefill"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            serve.main(argv + ["--cpu"])


def test_main_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--port", "0"])


def test_phase14_on_the_cpu(tmp_path):
    """The CPU twin of ``chip_smoke.py``'s phase 14 (``serve_phase(...,
    device="cpu", small=True)``): fp32 decode against the teacher-forced
    forward and the engine against one-shot generate in three layouts and
    rounds; the serving command as a child process restoring a checkpoint
    of the port's trainer, answering concurrent completions, a reload and a
    stream, stopped by SIGTERM with nothing left; the int8 cache; the
    Llama cache KVH-narrow."""
    work = str(tmp_path)
    job = f"phase14_{os.getpid()}"
    ckpt, persisted = _small_checkpoint(work, job)
    lm = llama.Llama(llama.LlamaConfig(**chip_smoke.LLAMA_SMALL), device="cpu", seed=0)
    llama_params = os.path.join(work, "llama.pt")
    torch.save({n: p.detach() for n, p in lm.named_parameters()}, llama_params)
    out = chip_smoke.serve_phase(work, job, {"ckpt_dir": ckpt, "persisted": persisted,
                                             "llama_params": llama_params},
                                 device="cpu", small=True)
    assert out["serve"]["restored_step"] == persisted["step"]
    assert out["serve"]["server_against_engine"][0] == 0
    assert out["fp32"]["logit_max_diff"] <= chip_smoke.SERVE_FP32_TOL
    assert out["decode_int8"]["min_cosine"] > chip_smoke.SERVE_INT8_COS
    assert out["cache_bytes"]["int8"] < out["cache_bytes"]["bf16"]
    assert out["llama"]["cache_shape"][2] == chip_smoke.LLAMA_SMALL["num_kv_heads"]
    assert out["decode_bf16"]["busy_share"] == "not measured"
