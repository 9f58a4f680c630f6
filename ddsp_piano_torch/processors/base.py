"""Processor protocol (get_controls then get_signal), the adders and the
ProcessorGroup DAG interpreter.

Counterpart of ddsp_piano_tpu/processors/base.py: Processor (:27-47), Add
(:50-60), MultiAdd (:63-76), nested_lookup (:79-88) and ProcessorGroup
(:94-144). The piano model's folded-voice group is in models/dag.py; a
ProcessorGroup runs the reference's sequential per-voice DAG, and any
other DAG a ``.gin`` file spells out.

Randomness: a processor with ``draws_noise`` takes ``noise=`` (its draw,
injected) and ``generator=`` in get_signal. The group hands each such node
its own draw: ``noise`` is None (each node draws from ``generator``), a
list with one entry per noise node in DAG order, a tensor whose first axis
splits evenly over those nodes (the folded-voice layout, voice-major), or
one value every node takes (NoiseBandNetSynth's loop shift).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


class Processor(nn.Module):
    """get_controls/get_signal protocol: a subclass defines
    ``get_controls(*inputs) -> dict`` and ``get_signal(**controls)``.
    ``name`` keys the processor's outputs in a DAG ('<name>/signal') and
    its parameters in the JAX tree."""

    name = 'processor'
    draws_noise = False

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        if name is not None:
            self.name = name

    def forward(self, *args, noise=None,
                generator: Optional[torch.Generator] = None,
                **kwargs) -> torch.Tensor:
        controls = self.get_controls(*args, **kwargs)
        if self.draws_noise:
            return self.get_signal(**controls, noise=noise,
                                   generator=generator)
        return self.get_signal(**controls)


class Add(Processor):
    """Sum of two signals."""

    def __init__(self, name: str = 'add'):
        super().__init__(name=name)

    def get_controls(self, signal_one, signal_two):
        return {'signal_one': signal_one, 'signal_two': signal_two}

    def get_signal(self, signal_one, signal_two):
        return signal_one + signal_two


class MultiAdd(Processor):
    """Sum of any number of signals, left to right in argument order."""

    def __init__(self, name: str = 'add'):
        super().__init__(name=name)

    def get_controls(self, *signals):
        return {f'signal_{i}': s for i, s in enumerate(signals)}

    def get_signal(self, **signals):
        total = None
        for k in sorted(signals, key=lambda s: int(s.split('_')[-1])):
            total = signals[k] if total is None else total + signals[k]
        return total


def nested_lookup(key: str, outputs: Dict[str, Any]):
    """Resolve an 'a/b/c' path in a nested dict."""
    node = outputs
    for part in key.split('/'):
        try:
            node = node[part]
        except (KeyError, TypeError) as e:
            raise KeyError(f"Key {key!r} not found while resolving DAG input "
                           f"(failed at {part!r}).") from e
    return node


DAG = Sequence[Tuple[Processor, Sequence[str]]]


class ProcessorGroup(nn.Module):
    """Evaluate a DAG of (processor, input keys) nodes over a features
    dict. An input key names a feature or an earlier node's output
    ('<name>/signal', '<name>/controls/<key>'). A processor used by
    several nodes is one module: its parameters are shared, under its
    name. Returns {'signal': the last node's signal, 'controls': the
    features plus each processor's {'signal', 'controls'} (its last
    node's) and 'out'}."""

    def __init__(self, dag: DAG, name: str = 'processor_group'):
        super().__init__()
        self.dag = [(proc, list(keys)) for proc, keys in dag]
        self.name = name
        for proc, _ in self.dag:
            if proc.name in self._modules:
                if self._modules[proc.name] is not proc:
                    raise ValueError(f"Two processors named {proc.name!r} "
                                     "in one DAG")
                continue
            self._modules[proc.name] = proc

    @property
    def processors(self) -> List[Processor]:
        return [proc for proc, _ in self.dag]

    def _node_noise(self, noise) -> List[Any]:
        nodes = [i for i, (p, _) in enumerate(self.dag) if p.draws_noise]
        if noise is None:
            return [None] * len(nodes)
        if isinstance(noise, (list, tuple)):
            if len(noise) != len(nodes):
                raise ValueError(f"{len(noise)} noise draws for "
                                 f"{len(nodes)} noise nodes")
            return list(noise)
        if isinstance(noise, torch.Tensor) and noise.dim() > 0:
            if noise.shape[0] % max(len(nodes), 1):
                raise ValueError(f"noise rows {noise.shape[0]} do not split "
                                 f"over {len(nodes)} noise nodes")
            return list(torch.chunk(noise, len(nodes), dim=0))
        return [noise] * len(nodes)

    def forward(self, features: Dict[str, Any], noise=None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        outputs = dict(features)
        draws = iter(self._node_noise(noise))
        signal = None
        for processor, input_keys in self.dag:
            args = [nested_lookup(k, outputs) for k in input_keys]
            controls = processor.get_controls(*args)
            if processor.draws_noise:
                signal = processor.get_signal(**controls, noise=next(draws),
                                              generator=generator)
            else:
                signal = processor.get_signal(**controls)
            outputs[processor.name] = {'signal': signal,
                                       'controls': controls}
        outputs['out'] = {'signal': signal}
        return {'signal': signal, 'controls': outputs}
