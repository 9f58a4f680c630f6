"""The train CLI's profiling and NaN-trapping hooks.

Counterparts of ddsp_piano_tpu/utils/jax_setup.py's profile_trace and
enable_debug_nans:

- :func:`profile_trace` records the steps run under it with torch.profiler
  (host operators, and the device's kernels and copies on a card), with
  the program's spans on (ddsp_piano_torch.tracing: ``train.step``,
  ``train.stage``, ``model.forward`` ...), and writes a Chrome trace,
  ``trace.json``, into its directory. The trace opens in Perfetto or
  chrome://tracing, the spans over the kernels; no TensorBoard plugin is
  needed.
- :func:`enable_debug_nans` traps a non-finite value where it is made: a
  forward hook on every submodule raises FloatingPointError naming the
  first module (the innermost, as hooks run when a module returns) whose
  output holds a NaN or an infinity, and autograd's anomaly mode raises on
  a backward function that returns one. The hooks only read, so a finite
  run's numbers are unchanged; each check waits for the device, so the
  steps are slower (as with jax_debug_nans).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, List

import torch

from ddsp_piano_torch import tracing

TRACE_NAME = 'trace.json'


@contextlib.contextmanager
def profile_trace(logdir: str, device: torch.device) -> Iterator[str]:
    """Profile the block, with tracing on, into ``<logdir>/trace.json``;
    yields the trace's path. Records the device's activity when ``device``
    is a card."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_NAME)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        tracing.enable()
        try:
            yield path
            if torch.device(device).type == 'cuda':
                torch.cuda.synchronize(device)
        finally:
            tracing.disable()
    prof.export_chrome_trace(path)


def _tensors(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def _check_finite(name: str):
    def hook(module, inputs, output):
        for t in _tensors(output):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"non-finite value in the output of module {name!r} "
                    f"({type(module).__name__})")
    return hook


def enable_debug_nans(model: torch.nn.Module
                      ) -> List[torch.utils.hooks.RemovableHandle]:
    """Trap non-finite values in ``model``'s forward (a hook on every
    module, the model itself last) and in every backward (anomaly mode).
    Returns the hooks' handles, for disable_debug_nans."""
    torch.autograd.set_detect_anomaly(True)
    return [module.register_forward_hook(_check_finite(name or 'model'))
            for name, module in model.named_modules()]


def disable_debug_nans(handles) -> None:
    """Undo enable_debug_nans: remove its hooks, end anomaly mode."""
    for handle in handles:
        handle.remove()
    torch.autograd.set_detect_anomaly(False)
