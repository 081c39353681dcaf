"""Device selection: the port's counterpart of ``dlrover_tpu/common/platform.py``.

The JAX module pins JAX to virtual CPU devices for tests. The port's rule is
simpler and stricter: entry points run on the GPU, run on the CPU only when
the caller asks for it (the tests do), and raise when neither is possible,
so that no run on a machine without a GPU passes itself off as a GPU run.
"""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda:0`` when a GPU is present and ``device`` is None; the given
    device otherwise. Raises if a CUDA device is asked for (or implied) and
    there is none."""
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def not_ported(what: str) -> NotImplementedError:
    """The error for a feature of the JAX package the port does not have
    yet: asked for, it raises instead of being silently ignored."""
    return NotImplementedError(f"{what} is not ported to dlrover_tpu_torch yet")
