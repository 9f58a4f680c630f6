"""Named dict I/O for modules (the reference's DictLayer protocol), and
the streaming application of a layer list.

Counterpart of ddsp_piano_tpu/nn/module.py: DictModule, and Sequential's
apply_with_state / apply_stream (:60-110) as plain functions over a
``torch.nn.Sequential``. Parameters live in torch.nn.Module attributes,
so the JAX package's Module/Sequential init/apply pair has no counterpart
here beyond torch.nn itself.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn


class DictModule(nn.Module):
    """Subclasses declare ``input_keys`` and ``output_keys``;
    :meth:`apply_features` reads inputs from a features dict and returns
    the named outputs. A key ending in '?' is optional: a missing feature
    is passed as None (module.py:132-153)."""

    input_keys: Tuple[str, ...] = ()
    output_keys: Tuple[str, ...] = ()

    def apply_features(self, features: Dict[str, Any]) -> Dict[str, Any]:
        names = [k.rstrip('?') for k in self.input_keys]
        missing = [n for k, n in zip(self.input_keys, names)
                   if not k.endswith('?') and features.get(n) is None]
        if missing:
            raise KeyError(f"{type(self).__name__} requires features "
                           f"{missing}; available: {sorted(features)}")
        outs = self(*(features.get(n) for n in names))
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(self.output_keys):
            raise ValueError(
                f"{type(self).__name__} returned {len(outs)} outputs for "
                f"output_keys {self.output_keys}")
        return dict(zip(self.output_keys, outs))


def apply_stream(sequential: nn.Sequential, x: torch.Tensor,
                 states: Optional[List[Any]] = None,
                 norm_stats: Optional[Dict[int, Tuple[Any, Any]]] = None,
                 stop_after: Optional[int] = None):
    """Apply a layer list in streaming mode: returns (x, new_states,
    prenorm).

    GRU layers start from ``states[i]`` (None or a missing list: zeros)
    and leave their final hidden state in ``new_states[i]`` (None for the
    other layers). A Normalize layer listed in ``norm_stats`` ({index:
    (mean, var)}) normalizes with those whole-file statistics; the input
    of every other Normalize is kept in ``prenorm[index]``, and
    ``stop_after`` (an index) ends the chain right after that capture, the
    later states None (the statistics sweep needs nothing further)."""
    from ddsp_piano_torch.nn.layers import GRU, Normalize

    norm_stats = norm_stats or {}
    layers = list(sequential)
    new_states: List[Any] = []
    prenorm: Dict[int, torch.Tensor] = {}
    for i, layer in enumerate(layers):
        if isinstance(layer, Normalize) and i not in norm_stats:
            prenorm[i] = x
            if stop_after == i:
                new_states.extend([None] * (len(layers) - len(new_states)))
                return x, new_states, prenorm
        if isinstance(layer, GRU):
            state = states[i] if states is not None else None
            x, h = layer(x, initial_state=state, return_state=True)
            new_states.append(h)
            continue
        if isinstance(layer, Normalize) and i in norm_stats:
            x = layer.apply_with_stats(x, *norm_stats[i])
        else:
            x = layer(x)
        new_states.append(None)
    return x, new_states, prenorm


def apply_with_state(sequential: nn.Sequential, x: torch.Tensor,
                     states: Optional[List[Any]] = None,
                     norm_stats: Optional[Dict[int, Tuple[Any, Any]]] = None):
    """:func:`apply_stream` without the captures: (x, new_states)."""
    x, new_states, _ = apply_stream(sequential, x, states=states,
                                    norm_stats=norm_stats)
    return x, new_states
