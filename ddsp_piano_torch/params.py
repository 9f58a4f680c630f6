"""Weights bridge between the port's modules and a JAX params pytree.

The pytree is nested dicts and lists of numpy arrays (for example
``jax.tree.map(np.asarray, PianoModel.init(key))`` on the JAX side). Its
paths flatten to the dotted names of the port's ``named_parameters()``:
dict keys and list indices become name parts, and empty subtrees (the
JAX package's stateless modules) carry no leaves. ``load_jax_params``
fills the port's parameters from such a tree (any missing, extra or
mis-shaped leaf raises); ``export_jax_params`` builds one from them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Any, prefix: str = '') -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from flatten_tree(value, f'{prefix}{key}.')
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from flatten_tree(value, f'{prefix}{i}.')
    else:
        yield prefix[:-1], tree


def load_jax_params(model: nn.Module, tree: Any) -> nn.Module:
    leaves: Dict[str, Any] = dict(flatten_tree(tree))
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"JAX params do not match the model: missing "
                         f"{missing}, extra {extra}")
    with torch.no_grad():
        for name, param in params.items():
            value = np.array(leaves[name], dtype=np.float32)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: JAX shape {value.shape} != port "
                                 f"shape {tuple(param.shape)}")
            param.copy_(torch.from_numpy(value))
    return model


def _module_tree(module: nn.Module) -> Any:
    """A module's parameters as the JAX package's tree: a Sequential or
    ModuleList is a list with one entry per layer ({} for a layer without
    parameters, as JAX's Activation); any other module a dict of its own
    parameters and of its children that hold parameters."""
    if isinstance(module, (nn.Sequential, nn.ModuleList)):
        return [_module_tree(child) for child in module]
    tree = {name: p.detach().cpu().numpy().astype(np.float32, copy=True)
            for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if any(True for _ in child.parameters()):
            tree[name] = _module_tree(child)
    return tree


def export_jax_params(model: nn.Module) -> Dict[str, Any]:
    """The PianoModel's parameters as a JAX params tree of float32 numpy
    arrays, with the structure of the JAX ``PianoModel.init`` tree: one
    entry per slot, and ``processor_group`` holding a tree for each
    distinct processor name of the group's DAG (for the folded-voice group,
    the DAG it stands for: additive, noise, their 'add' and the reverb),
    empty for a processor without parameters. The structure comes from the
    port's modules alone; no JAX template is needed. ``load_jax_params``
    takes it back."""
    from ddsp_piano_torch.models.dag import VectorizedPolyphonicProcessorGroup

    tree = {slot: _module_tree(module)
            for slot, module in model._module_slots()}
    group = model.processor_group
    if isinstance(group, VectorizedPolyphonicProcessorGroup):
        group = group.as_sequential_group()
    tree['processor_group'] = {proc.name: _module_tree(proc)
                               for proc in group.processors}
    return tree
