"""The two model configurations the benchmark runs, built from the frozen
copy, with Keras-style initial weights from a seed."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

import torch

_CONSTRUCTORS: Dict[str, Callable] = {}


def register(name: str):
    def decorator(fn: Callable):
        _CONSTRUCTORS[name] = fn
        return fn
    return decorator


def get_model(registry_name: str, inference: bool, duration: float,
              seed: int, device, **build) -> torch.nn.Module:
    """The model of ``registry_name`` ('maestro_v2' or 'dafx22') with the
    constructor's keyword arguments ``build``, its weights drawn from ``seed``
    by the copy's own initialisers, on ``device``, in eval mode."""
    importlib.import_module(f'portbench.reference.configs.{registry_name}')
    from portbench.reference.nn import init_weights

    model = _CONSTRUCTORS[registry_name](inference=inference, duration=duration,
                                     **build)
    init_weights(model, seed)
    return model.to(device).eval()
