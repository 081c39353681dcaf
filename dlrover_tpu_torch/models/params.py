"""Weights across the two packages: the JAX GPT's parameter tree to the
port's state dict and back.

The JAX model (``dlrover_tpu/models/gpt.py``) names its parameters the flax
way, ``block_{i}/CausalSelfAttention_0/wqkv`` and so on; the port uses
PyTorch module names. The shapes are the same, so the mapping is a rename
and the round trip is lossless. Trees are nested dicts of numpy arrays (or
anything ``np.asarray`` takes); state dicts hold tensors.
"""

from typing import Dict, Mapping

import numpy as np
import torch

# port name inside a block -> (flax submodule, flax leaf)
_BLOCK = {
    "ln_1.scale": ("LayerNorm_0", "scale"),
    "ln_1.bias": ("LayerNorm_0", "bias"),
    "attn.wqkv": ("CausalSelfAttention_0", "wqkv"),
    "attn.wo": ("CausalSelfAttention_0", "wo"),
    "ln_2.scale": ("LayerNorm_1", "scale"),
    "ln_2.bias": ("LayerNorm_1", "bias"),
    "mlp.w1": ("Mlp_0", "w1"),
    "mlp.b1": ("Mlp_0", "b1"),
    "mlp.w2": ("Mlp_0", "w2"),
    "mlp.b2": ("Mlp_0", "b2"),
}
_TOP = {
    "wte": ("wte",),
    "wpe": ("wpe",),
    "ln_f.scale": ("ln_f", "scale"),
    "ln_f.bias": ("ln_f", "bias"),
    "lm_head": ("lm_head",),
}


def _flax_paths(tree: Mapping):
    """(port name, flax path) for every parameter the tree holds."""
    for name, path in _TOP.items():
        if path[0] in tree:
            yield name, path
    i = 0
    while f"block_{i}" in tree:
        for name, path in _BLOCK.items():
            yield f"blocks.{i}.{name}", (f"block_{i}",) + path
        i += 1


def params_from_flax(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The port's state dict for a flax GPT parameter tree. Arrays are
    copied; ``device`` defaults to the CPU."""
    state = {}
    for name, path in _flax_paths(tree):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        state[name] = torch.from_numpy(np.array(leaf)).to(device)
    return state


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The flax parameter tree (nested dicts of numpy arrays) for a port
    state dict."""
    tree: Dict = {}
    for name, tensor in state_dict.items():
        if name in _TOP:
            path = _TOP[name]
        else:
            _, i, rest = name.split(".", 2)
            path = (f"block_{i}",) + _BLOCK[rest]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = tensor.detach().cpu().numpy()
    return tree
