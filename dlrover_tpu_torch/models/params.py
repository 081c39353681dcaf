"""Weights across the two packages: the JAX models' parameter trees to the
port's state dicts and back.

The JAX models (``dlrover_tpu/models/gpt.py`` and ``llama.py``) name their
parameters the flax way, ``block_{i}/CausalSelfAttention_0/wqkv``,
``block_{i}/MoeMlp_0/w_router`` and so on (the same with ``nn.remat`` on);
the port uses PyTorch module names. The shapes are the same, so the mapping
is a rename and the round trip is lossless. The family is read off the
names (a Llama tree has ``norm_f``, a GPT tree ``ln_f``), and a Llama
block's MLP is the MoE one when it holds a router. Trees are nested dicts
of numpy arrays (or anything ``np.asarray`` takes); state dicts hold
tensors.
"""

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

# port name inside a block -> (flax submodule, flax leaf)
_GPT_BLOCK = {
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
_GPT_TOP = {
    "wte": ("wte",),
    "wpe": ("wpe",),
    "ln_f.scale": ("ln_f", "scale"),
    "ln_f.bias": ("ln_f", "bias"),
    "lm_head": ("lm_head",),
}
_LLAMA_BLOCK = {
    "norm_1.scale": ("RMSNorm_0", "scale"),
    **{f"attn.{w}": ("LlamaAttention_0", w) for w in ("wq", "wk", "wv", "wo")},
    "norm_2.scale": ("RMSNorm_1", "scale"),
}
_SWIGLU = {f"mlp.{w}": ("SwiGluMlp_0", w) for w in ("w_gate", "w_up", "w_down")}
_MOE = {f"mlp.{w}": ("MoeMlp_0", w) for w in ("w_router", "w_gate", "w_up", "w_down")}
_LLAMA_TOP = {
    "wte": ("wte",),
    "norm_f.scale": ("norm_f", "scale"),
    "lm_head": ("lm_head",),
}


def _block(llama: bool, moe: bool) -> Dict[str, Tuple[str, str]]:
    if not llama:
        return _GPT_BLOCK
    return {**_LLAMA_BLOCK, **(_MOE if moe else _SWIGLU)}


def _flax_paths(tree: Mapping) -> Iterable[Tuple[str, Tuple[str, ...]]]:
    """(port name, flax path) for every parameter the tree holds."""
    llama = "norm_f" in tree
    for name, path in (_LLAMA_TOP if llama else _GPT_TOP).items():
        if path[0] in tree:
            yield name, path
    i = 0
    while f"block_{i}" in tree:
        for name, path in _block(llama, "MoeMlp_0" in tree[f"block_{i}"]).items():
            yield f"blocks.{i}.{name}", (f"block_{i}",) + path
        i += 1


def _port_paths(names: Iterable[str]) -> Iterable[Tuple[str, Tuple[str, ...]]]:
    """(port name, flax path) for every name of a port state dict."""
    names = list(names)
    llama = "norm_f.scale" in names
    top = _LLAMA_TOP if llama else _GPT_TOP
    for name in names:
        if name in top:
            yield name, top[name]
        else:
            _, i, rest = name.split(".", 2)
            block = _block(llama, f"blocks.{i}.mlp.w_router" in names)
            yield name, (f"block_{i}",) + block[rest]


def params_from_flax(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The port's state dict for a flax GPT or Llama parameter tree.
    Arrays are copied; ``device`` defaults to the CPU."""
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
    for name, path in _port_paths(state_dict):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = state_dict[name].detach().cpu().numpy()
    return tree
