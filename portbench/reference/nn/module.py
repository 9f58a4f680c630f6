"""Named dict I/O for modules (the reference's DictLayer protocol).

Counterpart of ddsp_piano_tpu/nn/module.py's DictModule. Parameters live
in torch.nn.Module attributes, so the JAX package's Module/Sequential
init/apply pair has no counterpart here beyond torch.nn itself.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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
