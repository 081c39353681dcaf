"""Rules of the PyTorch port (dlrover_tpu_torch/ and chip_smoke.py).

The port imports torch and numpy, never JAX and nothing of dlrover_tpu;
its entry points run on the GPU unless the caller asks for the CPU, and
raise when there is no GPU; its kernels are built by nvcc from the sources
in the repository, and a failed build raises with nvcc's own messages.
"""

import ast
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
# msgpack: the GPU machine does not have it (the JAX package frames its IPC
# with it; the port frames with the standard library)
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dlrover_tpu", "msgpack"}
_POISON = (
    "import sys\n"
    f"for name in {sorted(_FORBIDDEN)!r}:\n"
    "    sys.modules[name] = None  # any import of them now fails\n"
)


_SCRIPTS = [os.path.join(_REPO, "chip_smoke.py")] + [
    os.path.join(_REPO, "scripts", name)
    for name in ("torch_step_profile.py", "kernel_ab.py", "ckpt_overhead.py")
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


def test_the_scans_cover_the_checkpoint_and_loop_modules():
    names = set(_module_names())
    for module in ("common.multi_process", "common.config", "common.constants", "common.log",
                   "checkpoint.meta", "checkpoint.shm_handler", "checkpoint.storage",
                   "checkpoint.saver", "checkpoint.engine", "checkpoint.checkpointer",
                   "trainer.elastic", "trainer.dataloader", "trainer.loop"):
        assert f"dlrover_tpu_torch.{module}" in names


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


@pytest.mark.parametrize(
    "module,counterpart",
    [
        ("common/platform.py", "dlrover_tpu/common/platform.py"),
        ("ops/flash_attention.py", "dlrover_tpu/ops/flash_attention.py"),
        ("models/gpt.py", "dlrover_tpu/models/gpt.py"),
        ("parallel/train_step.py", "dlrover_tpu/parallel/train_step.py"),
    ] + [
        (f"{m}.py", f"dlrover_tpu/{m}.py")
        for m in ("common/log", "common/constants", "common/config", "common/multi_process",
                  "checkpoint/meta", "checkpoint/shm_handler", "checkpoint/storage",
                  "checkpoint/saver", "checkpoint/engine", "checkpoint/checkpointer",
                  "trainer/elastic", "trainer/dataloader", "trainer/loop")
    ],
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
