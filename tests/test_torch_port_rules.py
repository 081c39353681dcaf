"""Rules of the PyTorch port (dlrover_tpu_torch/ and chip_smoke.py).

The port imports torch and numpy, never JAX and nothing of dlrover_tpu;
its entry points run on the GPU unless the caller asks for the CPU, and
raise when there is no GPU; its kernels are built by nvcc from the sources
in the repository, and a failed build raises with nvcc's own messages.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from dlrover_tpu_torch.common import platform
from dlrover_tpu_torch.models import gpt
from dlrover_tpu_torch.ops import _build

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "dlrover_tpu_torch")
# msgpack and grpc: the GPU machine has neither (the JAX package frames its
# IPC with msgpack and serves its master over gRPC; the port uses JSON and
# HTTP from the standard library)
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dlrover_tpu", "msgpack", "grpc"}
_POISON = (
    "import sys\n"
    f"for name in {sorted(_FORBIDDEN)!r}:\n"
    "    sys.modules[name] = None  # any import of them now fails\n"
)


_SCRIPTS = [os.path.join(_REPO, "chip_smoke.py")] + [
    os.path.join(_REPO, "scripts", name)
    for name in ("torch_step_profile.py", "kernel_ab.py", "ckpt_overhead.py",
                 "first_step_split.py", "serve_phase.py")
]


def _port_files():
    files = list(_SCRIPTS)
    for root, _, names in os.walk(_PORT):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _module_names():
    names = []
    for path in _port_files()[len(_SCRIPTS):]:
        rel = os.path.relpath(path, _REPO)[: -len(".py")].replace(os.sep, ".")
        names.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return names


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    found = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [(path, m) for m in mods if m.split(".")[0] in _FORBIDDEN]
    assert not found, found


_CONTROL_PLANE = (
    "common/serialize", "common/comm", "common/node", "rpc/server", "rpc/client",
    "master/kv_store", "master/rdzv/manager", "master/diagnosis/action", "master/job_context",
    "master/node/job_manager", "master/monitor/perf_monitor", "master/servicer",
    "master/local_master", "master/args", "master/main", "agent/config", "agent/worker",
    "agent/rendezvous", "agent/diagnosis_agent", "agent/training_agent", "agent/warm_worker",
    "diagnosis/inference_chain", "diagnosis/operators", "diagnosis/diagnostician",
    "launcher/elastic_run", "launcher/main",
    "master/shard/dataset_splitter", "master/shard/task_manager", "agent/sharding",
)


_DURABLE = ("layout", "commit", "gc", "writer", "restore")


def test_the_scans_cover_the_checkpoint_and_loop_modules():
    names = set(_module_names())
    for module in ("common.multi_process", "common.config", "common.constants", "common.log",
                   "checkpoint.meta", "checkpoint.shm_handler", "checkpoint.storage",
                   "checkpoint.saver", "checkpoint.engine", "checkpoint.checkpointer",
                   "trainer.elastic", "trainer.dataloader", "trainer.loop", "parallel.mesh",
                   "parallel.sharding", "parallel.collectives", "parallel.train_step",
                   "checkpoint.replica", "checkpoint.durable") + tuple(
                       f"checkpoint.durable.{m}" for m in _DURABLE):
        assert f"dlrover_tpu_torch.{module}" in names
    # phases 10 and 11 of chip_smoke.py are in the scanned script
    assert "def restore_chain_phase" in open(_SCRIPTS[0]).read()
    assert "def layouts_phase" in open(_SCRIPTS[0]).read()


def test_the_scans_cover_the_control_plane_agent_and_launcher():
    names = set(_module_names())
    for module in _CONTROL_PLANE + ("examples/gpt_elastic",):
        assert "dlrover_tpu_torch." + module.replace("/", ".") in names
    for package in ("rpc", "master", "master.shard", "agent", "diagnosis", "launcher",
                    "examples"):
        assert f"dlrover_tpu_torch.{package}" in names
    # phase 6 of chip_smoke.py is in the scanned script
    assert "def tpurun_phase" in open(_SCRIPTS[0]).read()


def test_the_scans_cover_the_llama_slice():
    names = set(_module_names())
    for module in ("models.llama", "models.params", "examples.llama_moe"):
        assert f"dlrover_tpu_torch.{module}" in names
    # phase 9 of chip_smoke.py is in the scanned script
    assert "def llama_phase" in open(_SCRIPTS[0]).read()


def test_the_scans_cover_the_second_layouts_slice():
    names = set(_module_names())
    for module in ("parallel.mesh", "parallel.sharding", "parallel.collectives",
                   "parallel.train_step", "models.llama", "models.params", "examples.llama_moe",
                   "checkpoint.durable.restore", "checkpoint.durable"):
        assert f"dlrover_tpu_torch.{module}" in names
    # phase 12 of chip_smoke.py and the MoE example's world are in the scanned script
    script = open(_SCRIPTS[0]).read()
    assert "def llama_layouts_phase" in script and "def llama_moe_world" in script


def test_the_scans_cover_the_pipeline_slice():
    names = set(_module_names())
    for module in ("parallel.pipeline", "parallel.replan", "models.gpt_pipeline",
                   "models.params", "parallel.collectives", "checkpoint.engine",
                   "common.config"):
        assert f"dlrover_tpu_torch.{module}" in names
    # phase 13 of chip_smoke.py is in the scanned script
    script = open(_SCRIPTS[0]).read()
    assert "def pipeline_phase" in script and "def pipeline_trainer" in script


def test_the_scans_cover_the_sp_slice():
    names = set(_module_names())
    for module in ("ops.ring_attention", "parallel.mesh", "parallel.sharding",
                   "parallel.train_step", "models.gpt", "models.llama"):
        assert f"dlrover_tpu_torch.{module}" in names
    # phases 11 and 12 of chip_smoke.py run the sp worlds
    script = open(_SCRIPTS[0]).read()
    assert '"sp2_tp2"' in script and '"llama_sp2"' in script


def test_the_scans_cover_the_serving_slice():
    names = set(_module_names())
    for module in ("common.http", "attribution", "attribution.phases", "models.generation",
                   "models.serving", "launcher.serve"):
        assert f"dlrover_tpu_torch.{module}" in names
    # phase 14 of chip_smoke.py is in the scanned script
    assert "def serve_phase" in open(_SCRIPTS[0]).read()


def test_the_serving_command_answers_with_jax_poisoned(tmp_path):
    """``tpurun-serve-torch --cpu`` in a process where JAX, the JAX package,
    msgpack and grpc cannot be imported: it listens, answers a completion
    and stops on SIGTERM with exit 0."""
    import http.client
    import signal
    import time

    out = tmp_path / "serve.out"
    code = (_POISON + "from dlrover_tpu_torch.launcher import serve\n"
            "sys.exit(serve.main(['--cpu', '--port', '0', '--batch-size', '2', "
            "'--prompt-width', '8', '--max-new-tokens', '4', '--temperature', '0']))\n")
    env = {**os.environ, "PYTHONPATH": _REPO}
    with open(out, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=_REPO, stdout=f,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.monotonic() + 120
        while "serve {" not in out.read_text() and proc.poll() is None:
            assert time.monotonic() < deadline, "the server did not come up"
            time.sleep(0.1)
        port = json.loads(out.read_text().split("serve ", 1)[1].splitlines()[0])["port"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/completions", body=json.dumps({"prompt": [5, 9, 2]}))
        answer = json.loads(conn.getresponse().read())
        conn.close()
        assert len(answer["tokens"]) == 4
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err


def test_the_llama_example_runs_with_jax_poisoned():
    """The MoE example trains its 30 tiny steps on the CPU in a process
    where JAX and the JAX package cannot be imported."""
    code = (_POISON + "import runpy\n"
            "sys.argv = ['llama_moe', '--device', 'cpu']\n"
            "runpy.run_module('dlrover_tpu_torch.examples.llama_moe', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": _REPO})
    assert proc.returncode == 0, proc.stderr
    assert "step 25: loss" in proc.stdout


def test_every_module_imports_with_jax_and_dlrover_tpu_poisoned():
    code = (
        _POISON + "import importlib\n"
        f"for name in {_module_names()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_launcher_master_and_example_run_with_jax_grpc_and_msgpack_poisoned(tmp_path):
    """The flagship entry points, each in a process where JAX, the JAX
    package, msgpack and grpc cannot be imported: the launcher parses its
    flags, the master serves and ends a job, the example trains on the CPU."""
    env = {**os.environ, "PYTHONPATH": _REPO, "DLROVER_JOB_NAME": f"rules_fl_{os.getpid()}",
           "DLROVER_IPC_DIR": str(tmp_path / "sockets"), "CKPT_DIR": str(tmp_path / "ckpt"),
           "TOTAL_STEPS": "2"}
    env.pop("DLROVER_IPC_NAMESPACE", None)
    code = (
        _POISON + "import runpy\n"
        "from dlrover_tpu_torch.launcher import elastic_run\n"
        "elastic_run.config_from_args(elastic_run.parse_args(['-m', 'x']))\n"
        "from dlrover_tpu_torch.master.local_master import LocalJobMaster\n"
        "from dlrover_tpu_torch.rpc.client import MasterClient\n"
        "m = LocalJobMaster(); m.prepare()\n"
        "c = MasterClient(m.addr, node_id=0)\n"
        "assert c.join_rendezvous(0, 1, 'training') == 0\n"
        "m.stop()\n"
        "sys.argv = ['gpt_elastic', '--device', 'cpu', '--small']\n"
        "runpy.run_module('dlrover_tpu_torch.examples.gpt_elastic', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert '"event": "done"' in proc.stdout
    for name in os.listdir("/dev/shm"):
        if name.startswith(f"dlrover_{env['DLROVER_JOB_NAME']}"):
            os.unlink(os.path.join("/dev/shm", name))


def test_chip_smoke_trainer_runs_with_jax_and_msgpack_poisoned(tmp_path):
    """A trainer process of the checkpoint phase (``chip_smoke.py --trainer``)
    on the CPU at the small size: engine, saver, IPC and loop with JAX, the
    JAX package and msgpack unimportable."""
    code = (
        _POISON + "import chip_smoke\n"
        f"sys.exit(chip_smoke.main(['--trainer', 'restore', '--device', 'cpu', '--small', "
        f"'--ckpt', {str(tmp_path / 'ckpt')!r}]))\n"
    )
    env = {**os.environ, "PYTHONPATH": _REPO, "DLROVER_JOB_NAME": f"rules_{os.getpid()}",
           "DLROVER_IPC_DIR": str(tmp_path / "sockets")}
    env.pop("DLROVER_IPC_NAMESPACE", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert '"step": -1' in proc.stdout and '"hash"' in proc.stdout


def test_the_warm_spare_preloads_and_hands_off_with_jax_grpc_and_msgpack_poisoned(tmp_path):
    """The spare's own preloads (torch and the training modules) import
    nothing forbidden, and the script it becomes runs."""
    script = tmp_path / "ok.py"
    script.write_text("import sys\nprint('handed', sys.argv[1:], flush=True)\n")
    contract = {"env": {"DLROVER_RESTART_COUNT": "1"}, "entrypoint": str(script), "args": ["a"]}
    code = (_POISON + "from dlrover_tpu_torch.agent import warm_worker\n"
            "sys.exit(warm_worker.main())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=300, input=json.dumps(contract) + "\n",
                          env={**os.environ, "PYTHONPATH": _REPO})
    assert proc.returncode == 0, proc.stderr
    assert "handed ['a']" in proc.stdout and "cannot preload" not in proc.stderr


@pytest.mark.parametrize(
    "module,counterpart",
    [
        ("common/platform.py", "dlrover_tpu/common/platform.py"),
        ("ops/flash_attention.py", "dlrover_tpu/ops/flash_attention.py"),
        ("ops/ring_attention.py", "dlrover_tpu/ops/ring_attention.py"),
        ("models/gpt.py", "dlrover_tpu/models/gpt.py"),
        ("models/llama.py", "dlrover_tpu/models/llama.py"),
        ("parallel/train_step.py", "dlrover_tpu/parallel/train_step.py"),
        ("parallel/mesh.py", "dlrover_tpu/parallel/mesh.py"),
        ("parallel/pipeline.py", "dlrover_tpu/parallel/pipeline.py"),
        ("parallel/replan.py", "dlrover_tpu/parallel/replan.py"),
        ("models/gpt_pipeline.py", "dlrover_tpu/models/gpt_pipeline.py"),
        ("common/http.py", "dlrover_tpu/common/http.py"),
        ("attribution/phases.py", "dlrover_tpu/attribution/phases.py"),
        ("models/generation.py", "dlrover_tpu/models/generation.py"),
        ("models/serving.py", "dlrover_tpu/models/serving.py"),
        ("launcher/serve.py", "dlrover_tpu/launcher/serve.py"),
    ] + [
        (f"{m}.py", f"dlrover_tpu/{m}.py")
        for m in ("common/log", "common/constants", "common/config", "common/multi_process",
                  "checkpoint/meta", "checkpoint/shm_handler", "checkpoint/storage",
                  "checkpoint/saver", "checkpoint/engine", "checkpoint/checkpointer",
                  "checkpoint/replica", "checkpoint/durable/__init__",
                  "trainer/elastic", "trainer/dataloader", "trainer/loop") + _CONTROL_PLANE
        + tuple(f"checkpoint/durable/{m}" for m in _DURABLE)
    ] + [("examples/gpt_elastic.py", "examples/gpt_elastic.py"),
         ("examples/llama_moe.py", "examples/llama_moe.py")],
)
def test_each_ported_module_names_its_counterpart(module, counterpart):
    path = os.path.join(_PORT, module)
    doc = ast.get_docstring(ast.parse(open(path).read()))
    assert counterpart in doc
    assert os.path.exists(os.path.join(_REPO, counterpart))


def test_resolve_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        platform.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.resolve_device("cuda")
    assert platform.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        gpt.GPT(gpt.GPTConfig.tiny())


def test_resolve_device_picks_the_first_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert platform.resolve_device() == torch.device("cuda", 0)
    assert platform.resolve_device("cuda") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="unsupported device"):
        platform.resolve_device("meta")


def test_strict_fp32_turns_tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        platform.strict_fp32()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_chip_smoke_fails_without_a_gpu(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the rest of the repository, the
    script cannot reach the port and exits non-zero with no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(_REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_bounds_match_the_main_path_arithmetic():
    import chip_smoke

    b = chip_smoke.bounds(B=8, T=1024, H=12, D=64, causal=True)
    tensor = 8 * 1024 * 12 * 64 * 2
    pairs = 8 * 12 * 1024 * 1025 // 2
    assert b["fwd"] == (4 * tensor + 8 * 12 * 1024 * 4, 4 * 64 * pairs)
    ms, by = chip_smoke.bound_ms(*b["bwd_dkdv"])
    assert by == "operations" and ms == pytest.approx(8 * 64 * pairs / 989e12 * 1e3)
    assert chip_smoke.causal_pairs(3, 5, True) == 3 + 4 + 5


def _fake_nvcc(tmp_path, ok):
    path = tmp_path / "nvcc"
    body = (
        "import sys\n"
        "args = sys.argv[1:]\n"
        "print('ptxas info : Used 64 registers', file=sys.stderr)\n"
        + ("open(args[args.index('-o') + 1], 'w').write('lib')\n" if ok
           else "print('kernel.cu(3): error: bad kernel', file=sys.stderr)\nsys.exit(1)\n")
    )
    path.write_text(f"#!{sys.executable}\n{body}")
    path.chmod(0o755)
    return str(path)


@pytest.fixture()
def fake_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kernel.cu").write_text("// a kernel\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return csrc


def test_build_raises_with_nvccs_messages(tmp_path, monkeypatch, fake_sources):
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, ok=False))
    with pytest.raises(RuntimeError, match="error: bad kernel"):
        _build.build(["kernel"])
    assert not [n for n in os.listdir(_build.BUILD_DIR) if n.endswith(".so")]


def test_build_is_keyed_by_the_sources(tmp_path, monkeypatch, fake_sources):
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, ok=True))
    (first,) = _build.build(["kernel"])
    assert os.path.exists(first)
    assert "Used 64 registers" in open(first[: -len(".so")] + ".log").read()
    monkeypatch.setattr(_build, "nvcc", lambda: pytest.fail("rebuilt unchanged sources"))
    assert _build.build(["kernel"]) == [first]
    (fake_sources / "kernel.cu").write_text("// an edited kernel\n")
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, ok=True))
    (second,) = _build.build(["kernel"])
    assert second != first and os.path.exists(second)


def test_build_flags_target_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
