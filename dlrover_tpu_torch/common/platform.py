"""Device selection: the port's counterpart of ``dlrover_tpu/common/platform.py``.

The JAX module pins JAX to virtual CPU devices for tests. The port's rule is
simpler and stricter: entry points run on the GPU, run on the CPU only when
the caller asks for it (the tests do), and raise when neither is possible,
so that no run on a machine without a GPU passes itself off as a GPU run.

torch is imported where it is used: the standalone master imports this
module for ``not_ported`` and needs no torch (its import costs seconds).
"""

from typing import Optional, Union


def resolve_device(device: Optional[Union[str, "torch.device"]] = None) -> "torch.device":  # noqa: F821
    """``cuda:0`` when a GPU is present and ``device`` is None; the given
    device otherwise. Raises if a CUDA device is asked for (or implied) and
    there is none."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but no CUDA device is present")
        if device.index is None:
            device = torch.device("cuda", 0)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def strict_fp32() -> None:
    """Keep fp32 matmuls and convolutions in full fp32 on the GPU: PyTorch
    otherwise runs cuDNN convolutions in TF32, which keeps about three
    decimal digits."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def not_ported(what: str) -> NotImplementedError:
    """The error for a feature of the JAX package the port does not have
    yet: asked for, it raises instead of being silently ignored."""
    return NotImplementedError(f"{what} is not ported to dlrover_tpu_torch yet")


def _interface_addrs() -> list:
    """IPv4 addresses of this machine's network interfaces, read with the
    ``SIOCGIFADDR`` ioctl (Linux), loopback excluded."""
    import fcntl
    import socket
    import struct

    out = []
    try:
        names = [name for _, name in socket.if_nameindex()]
    except OSError:
        return out
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for name in names:
            try:
                req = struct.pack("256s", name.encode()[:15])
                ip = socket.inet_ntoa(fcntl.ioctl(s.fileno(), 0x8915, req)[20:24])
            except OSError:
                continue  # no IPv4 address on this interface
            if not ip.startswith("127."):
                out.append(ip)
    return out


def routable_host(override_env: str = "") -> str:
    """Best non-loopback IPv4 address of this machine, for addresses handed
    to other hosts: the port's copy of ``routable_host`` in
    ``dlrover_tpu/common/platform.py``.

    ``gethostbyname(gethostname())`` resolves to 127.0.1.1 on stock
    Debian/Ubuntu hosts files, which breaks any service whose address other
    hosts dial. Order: the ``override_env`` variable when the caller names
    one (for per-deployment addresses only: a per-node endpoint must not
    honour a job-wide override, or every node advertises one address); the
    hostname's first A record when it is not a loopback; the first address
    of a network interface; loopback as the last resort (a machine alone).
    The JAX function finds the outbound interface by connecting a UDP socket
    to a public address; this one reads the interfaces and dials nothing.
    """
    import os
    import socket

    if override_env:
        override = os.getenv(override_env, "")
        if override:
            return override
    try:
        infos = socket.getaddrinfo(socket.gethostname(), None, socket.AF_INET)
        if infos and not infos[0][4][0].startswith("127."):
            return infos[0][4][0]
    except OSError:
        pass
    addrs = _interface_addrs()
    return addrs[0] if addrs else "127.0.0.1"
