"""Processor protocol (get_controls then get_signal).

Counterpart of ddsp_piano_tpu/processors/base.py's Processor (:27-47). The
piano model's folded-voice group is in models/dag.py. A processor with
``draws_noise`` takes ``noise=`` (its draw, injected) and ``generator=``
in get_signal.
"""

from __future__ import annotations

from typing import Optional

from torch import nn


class Processor(nn.Module):
    """get_controls/get_signal protocol: a subclass defines
    ``get_controls(*inputs) -> dict`` and ``get_signal(**controls)``.
    ``name`` keys the processor's outputs and its parameters in the JAX
    tree."""

    name = 'processor'
    draws_noise = False

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        if name is not None:
            self.name = name
