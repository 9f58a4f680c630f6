"""The benchmark's only door into the program under test, ddsp_piano_torch:
its model constructor, its serving entry, its Trainer, its launch counters and
the card. Each is looked up when it is called."""

from __future__ import annotations

import hashlib
from typing import Dict

import torch


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit torch seed for one named stream of a run's seed."""
    digest = hashlib.sha256(f'{int(seed)}:{stream}'.encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 1


def model(config: Dict, weights: Dict[str, torch.Tensor], inference: bool,
          duration: float, device):
    """The port's model of a configuration file's dict, on ``device``,
    holding ``weights`` (the benchmark's)."""
    from ddsp_piano_torch import configs

    net = configs.get_model(config['registry_name'], inference=inference,
                            duration=duration, device=device, seed=0,
                            **config['build'])
    net.load_state_dict(weights)
    return net


def serving_fn(net, seed: int):
    from ddsp_piano_torch.models import serving

    return serving.make_serving_fn(net, seed=torch_seed(seed, 'serve'))


def trainer(net, mix: Dict, seed: int, record_timeline: bool):
    from ddsp_piano_torch.training import trainer

    return trainer.Trainer(net, learning_rate=float(mix['learning_rate']),
                           grad_clip_norm=float(mix['grad_clip_norm']),
                           first_phase=True,
                           seed=torch_seed(seed, 'trainer') >> 32,
                           record_timeline=record_timeline)


def launches() -> Dict[str, int]:
    """The port's kernel launch counters."""
    from ddsp_piano_torch.kernels import build

    return dict(build.LAUNCHES)


def synchronize(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def release(device) -> None:
    """Return freed blocks to the card, after the program's state is
    dropped."""
    import gc

    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def profiler(device):
    """A torch.profiler over the host and, on a card, the device; its
    events stay in memory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, record_shapes=False)
