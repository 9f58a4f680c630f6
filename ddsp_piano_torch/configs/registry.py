"""Model config registry and the ``get_model`` entry point.

Counterpart of ddsp_piano_tpu/configs/registry.py, with its eight names:
the 24 kHz dafx22 and the regularized v2 are registered from their base
configs' modules. A path ending in ``.gin`` is built by
configs.gin_compat (registry.py:55-59). Other names raise with the list of
what exists.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from ddsp_piano_torch.device import DeviceLike, resolve_device

_CONFIGS: Dict[str, Callable] = {}
_CONFIG_MODULES = ('ddsp_piano_torch.configs.dafx22',
                   'ddsp_piano_torch.configs.maestro_v2',
                   'ddsp_piano_torch.configs.enstdkcl_32khz',
                   'ddsp_piano_torch.configs.enstdkcl_8khz',
                   'ddsp_piano_torch.configs.multi_instruments',
                   'ddsp_piano_torch.configs.surrogate')


def register(name: str):
    def decorator(fn: Callable):
        _CONFIGS[name] = fn
        return fn
    return decorator


def available_configs():
    for mod in _CONFIG_MODULES:
        importlib.import_module(mod)
    return sorted(_CONFIGS)


def _build(config: str, inference: bool, duration: float, **overrides):
    """A registered (or ``.gin``) model on the CPU, its weights not
    initialised."""
    if config.endswith('.gin'):
        from ddsp_piano_torch.configs import gin_compat
        return gin_compat.build_from_gin(config, inference=inference,
                                         duration=duration, **overrides)
    name = config.replace('-', '_')
    if name not in available_configs():
        raise KeyError(f"Unknown config {config!r}; available: "
                       f"{available_configs()}")
    return _CONFIGS[name](inference=inference, duration=duration,
                          **overrides)


def config_rates(config: str = 'maestro_v2') -> Dict[str, int]:
    """A config's sample rate, frame rate and polyphony (n_synths), read
    without building weights on a device."""
    model = _build(config, inference=True, duration=1.0)
    return {'sample_rate': model.sample_rate, 'frame_rate': model.frame_rate,
            'n_synths': model.n_synths}


def get_model(config: str = 'maestro_v2', inference: bool = False,
              duration: float = 3.0, device: DeviceLike = None,
              seed: int = 0, **overrides):
    """Build a registered model (or a ``.gin`` file's), give it
    Keras-style initial weights from
    ``seed`` and move it to ``device`` (default ``cuda``; raises when CUDA
    is missing, unless device='cpu'). ``overrides`` go to the config's
    builder, e.g. ``oscillator='full'`` for the all-partials oscillator."""
    from ddsp_piano_torch.nn import init_weights

    device = resolve_device(device)
    model = _build(config, inference=inference, duration=duration,
                   **overrides)
    init_weights(model, seed)
    return model.to(device).eval()
