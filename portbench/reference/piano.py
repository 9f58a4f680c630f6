"""The reference's entry points: a served render and Adam training steps,
in plain float32 PyTorch (TF32 off unless a caller asks for the control's
TF32), from inputs the benchmark hands both sides.

The reference works out again what the port derives from those inputs:
the binarised roll's voice allocation (``allocator``), the controls, the
synthesis, the losses, the gradients, the clip and the Adam update.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import allocator, configs


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 matmuls and convolutions with TF32 off (the configurations'
    precision), or on (the control's)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def build(config: Dict, inference: bool, duration: float, seed: int,
          device) -> torch.nn.Module:
    """The reference model of a configuration file's dict, its weights
    from ``seed``."""
    return configs.get_model(config['registry_name'], inference, duration,
                             seed, device, **config['build'])


def conditioning(roll: np.ndarray, n_synths: int) -> np.ndarray:
    """(b, T, 88, 2) roll -> (b, T, n_synths, 2) conditioning: the active
    channel binarised, each row allocated from a fresh state."""
    roll = np.asarray(roll, np.float32)
    binary = np.stack([(roll[..., 0] > 0).astype(np.float32), roll[..., 1]],
                      axis=-1)
    return np.stack([allocator.roll_to_conditioning(r, n_synths)[0]
                     for r in binary])


def render(model, cond: np.ndarray, pedal: np.ndarray,
           piano_model: np.ndarray, noise: torch.Tensor) -> torch.Tensor:
    """The audio (b, n_samples) of a batch of conditioning."""
    device = next(model.parameters()).device
    features = {
        'conditioning': torch.from_numpy(np.asarray(cond, np.float32)).to(
            device),
        'pedal': torch.from_numpy(np.asarray(pedal, np.float32)).to(device),
        'piano_model': torch.from_numpy(np.asarray(piano_model)).to(device),
    }
    with torch.no_grad():
        return model(features, noise=noise.to(device))['audio_synth']


def leaf_norms(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    """float64 norm of each tensor."""
    return np.array([float(torch.linalg.vector_norm(t.double()))
                     for t in tensors])


class Adam:
    """Adam over a list of tensors, written out in the operation order of
    torch.optim.Adam's update (so that two runs of equal gradients agree
    to the bit): the moments by lerp and addcmul, then p -= lr / c1 * m /
    (sqrt(v) / sqrt(c2) + eps), c1 and c2 the bias corrections."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = (params, lr, b1,
                                                            b2, eps)
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.lerp_(g, 1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g / norm * max_norm when norm >=
    max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if float(norm) < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


def train_steps(model, batches: Sequence[Dict[str, np.ndarray]],
                noises: Sequence[torch.Tensor], lr: float,
                grad_clip_norm: float, blocks: int = 1) -> Dict:
    """Adam steps of the first training phase, one a batch, each batch's
    loss and gradient the mean over ``blocks`` equal blocks of its rows
    (the global batch of several ranks, each rank's rows in one block).
    Returns the total losses, each trainable leaf's name, the norm of the
    first step's clipped gradient and the norm of the parameters' change
    over all the steps, and on the host the first clipped gradient, the
    first step's change and the change over all the steps, leaf by leaf."""
    device = next(model.parameters()).device
    model.set_trainable(True)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    start = [p.detach().clone() for p in params]
    adam = Adam(params, lr)
    losses, first_grad, first_step = [], None, None
    for batch, noise in zip(batches, noises):
        b = batch['audio'].shape[0]
        rows = b // blocks
        grads = [torch.zeros_like(p) for p in params]
        total = 0.0
        for k in range(blocks):
            sl = slice(k * rows, (k + 1) * rows)
            features = {key: torch.from_numpy(np.ascontiguousarray(
                batch[key][sl])).to(device) for key in batch}
            draw = noise.reshape(model.n_synths, b, -1)[:, sl].reshape(
                model.n_synths * rows, -1).to(device)
            out = model(features, noise=draw, training=True)
            loss = out['losses']['total_loss']
            block = torch.autograd.grad(loss, params, allow_unused=True)
            for acc, g in zip(grads, block):
                if g is not None:
                    acc.add_(g.detach() / blocks)
            total += float(loss.detach()) / blocks
        grads = clip_by_global_norm(grads, grad_clip_norm)
        if first_grad is None:
            first_grad = [g.detach().cpu() for g in grads]
        adam.step(grads)
        if first_step is None:
            first_step = [(p.detach() - s).cpu()
                          for p, s in zip(params, start)]
        losses.append(total)
    change = [(p.detach() - s).cpu() for p, s in zip(params, start)]
    return {'losses': losses, 'names': [n for n, _ in named],
            'grad_norms': leaf_norms(first_grad),
            'change_norms': leaf_norms(change), 'first_grad': first_grad,
            'first_step': first_step, 'change': change}
