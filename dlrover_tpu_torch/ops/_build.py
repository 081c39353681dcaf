"""Builds the port's CUDA kernels at first use and loads them with ctypes.

The JAX package has no counterpart: its kernels are Pallas, compiled by XLA.
Here each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, ``_build/<name>-<hash>.so``.
The hash covers every source under ``csrc/`` and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. ``nvcc`` also
reports each kernel's registers, shared memory and spills (``-Xptxas -v``);
that report is kept beside the library as ``<name>-<hash>.log``.

Nothing here runs at import: the tests import every module on machines
without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Iterable, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest()}.so")


def build(names: Iterable[str]) -> List[str]:
    """Compile ``csrc/<name>.cu`` for each name not built yet, one ``nvcc``
    per source, all started together. Returns the library paths. Raises
    with ``nvcc``'s own messages if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, jobs = [], []
    for name in names:
        out = library_path(name)
        paths.append(out)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        with open(out[: -len(".so")] + ".log", "w") as log:
            log.write(stdout + stderr)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it first if needed."""
    (path,) = build([name])
    return ctypes.CDLL(path)
