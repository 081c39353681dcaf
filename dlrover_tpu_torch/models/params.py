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

With a ``mesh`` (``parallel/mesh.py``) a GPT or Llama tree becomes this
process's blocks, each at its mesh coordinate as the JAX
``state_shardings`` splits the leaf (``parallel/sharding.py``), and this
process's blocks become the whole tree again by gathering every process's
(a collective).

:func:`cache_from_flax` and :func:`cache_to_flax` carry a decode cache
across: the JAX models' ``"cache"`` collection and the port's explicit
cache (``models/gpt.py``).
"""

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from ..parallel.sharding import gather_full, layout_for, param_spec, set_layout
from . import gpt, llama

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


def _logical_axes(name: str, names) -> Tuple:
    """The logical axes of the port's parameter ``name`` among ``names``
    (the tree's; a Llama block's MLP is the MoE one when it holds a
    router)."""
    if "norm_f.scale" not in names:
        return gpt.logical_axes(name)
    block = name.split(".", 2)[1] if name.startswith("blocks.") else None
    return llama.logical_axes(name, moe=f"blocks.{block}.mlp.w_router" in names)


def params_from_flax(tree: Mapping, device=None, mesh=None) -> Dict[str, torch.Tensor]:
    """The port's state dict for a flax GPT or Llama parameter tree.
    Arrays are copied; ``device`` defaults to the CPU. With a ``mesh``, the
    blocks at the mesh's ``coord`` (this process's), each carrying its
    layout."""
    state = {}
    paths = list(_flax_paths(tree))
    names = {name for name, _ in paths}
    for name, path in paths:
        leaf = tree
        for key in path:
            leaf = leaf[key]
        arr = np.array(leaf)
        if mesh is None:
            state[name] = torch.from_numpy(arr).to(device)
            continue
        spec = param_spec(_logical_axes(name, names), arr.shape, mesh.shape)
        layout = layout_for(spec, arr.shape, mesh.shape, mesh.coord)
        state[name] = set_layout(torch.from_numpy(arr[layout.slices()].copy()).to(device), layout)
    return state


def params_to_flax(state_dict: Mapping[str, torch.Tensor], mesh=None) -> Dict:
    """The flax parameter tree (nested dicts of numpy arrays) for a port
    state dict. With a ``mesh``, ``state_dict`` holds this process's blocks
    and every process of the mesh calls this: each leaf is gathered whole
    (``sharding.gather_full``) first."""
    tree: Dict = {}
    for name, path in _port_paths(state_dict):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        t = state_dict[name] if mesh is None else gather_full(state_dict[name], mesh)
        node[path[-1]] = t.detach().cpu().numpy()
    return tree


# -- the pipelined GPT (models/gpt_pipeline.py) ---------------------------------


def pipeline_params_from_jax(tree: Mapping, device=None, mesh=None) -> Dict[str, torch.Tensor]:
    """The port's flat parameters (``"embed/wte"``, ``"stages/wqkv"``, ...)
    for the JAX pipelined GPT's tree (``init_gpt_pipeline_params``: nested
    dicts of numpy arrays, or anything ``np.asarray`` takes). The paths are
    the JAX tree's, so the mapping is a flattening. With a ``mesh``, this
    process's blocks (the stages split over pp), each carrying its layout;
    the other leaves whole."""
    from .gpt_pipeline import flatten_params, gpt_pipeline_shardings

    flat = {k: np.array(v) for k, v in flatten_params(dict(tree)).items()}
    layouts = gpt_pipeline_shardings(flat, mesh) if mesh is not None else {}
    out = {}
    for k, arr in flat.items():
        layout = layouts.get(k)
        block = arr if layout is None else arr[layout.slices()].copy()
        out[k] = set_layout(torch.from_numpy(block).to(device), layout)
    return out


def pipeline_params_to_jax(params: Mapping[str, torch.Tensor], mesh=None) -> Dict:
    """The JAX pipelined GPT's tree (nested dicts of numpy arrays) for the
    port's flat parameters. With a ``mesh``, ``params`` holds this process's
    blocks and every process of the mesh calls this: the stages are
    gathered whole over pp (a collective)."""
    from .gpt_pipeline import unflatten_params

    flat = {k: (t if mesh is None else gather_full(t, mesh)).detach().cpu().numpy()
            for k, t in params.items()}
    return unflatten_params(flat)


# -- the decode cache -----------------------------------------------------------

_CACHE_ATTN = {"gpt": "CausalSelfAttention_0", "llama": "LlamaAttention_0"}


def cache_from_flax(tree: Mapping, device=None) -> Dict:
    """The port's decode cache (``gpt.empty_cache``'s structure) for the JAX
    ``"cache"`` collection (nested dicts of numpy arrays, or anything
    ``np.asarray`` takes): ``block_{i}/<attention>/{k, v[, k_scale,
    v_scale], index}``. The port keeps one write index; it is layer 0's.
    Arrays are copied; ``device`` defaults to the CPU."""
    layers, i = [], 0
    while f"block_{i}" in tree:
        block = tree[f"block_{i}"]
        attn = block[next(name for name in _CACHE_ATTN.values() if name in block)]
        layers.append({k: torch.from_numpy(np.array(v)).to(device)
                       for k, v in attn.items() if k != "index"})
        i += 1
    index = int(np.asarray(tree["block_0"][next(n for n in _CACHE_ATTN.values()
                                                if n in tree["block_0"])]["index"]))
    return {"index": index, "layers": layers}


def cache_to_flax(cache: Mapping, family: str = "gpt") -> Dict:
    """The JAX ``"cache"`` collection (nested dicts of numpy arrays) of the
    port's decode cache, for the ``family`` ("gpt" or "llama") whose
    attention module names it; every layer carries the shared index."""
    attn = _CACHE_ATTN[family]
    return {f"block_{i}": {attn: {**{k: t.detach().cpu().numpy() for k, t in layer.items()},
                                  "index": np.asarray(cache["index"], np.int32)}}
            for i, layer in enumerate(cache["layers"])}
