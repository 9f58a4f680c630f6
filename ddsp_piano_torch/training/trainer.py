"""Trainer: one optimization step of a PianoModel on the card.

Counterpart of ddsp_piano_tpu/training/trainer.py (the single-step path,
:300-324 and :405-458):

- the step is autograd of ``total_loss``, then Adam over the trainable
  parameters only (PianoModel.set_trainable: frozen parameters get no
  gradient, no update and no moments, as optax.set_to_zero gives them).
  A phase that trains no parameter (maestro_v2's even phases: its joint
  tuning is pretrained and stays frozen) has no optimizer: its step
  computes the losses, runs no backward and changes no parameter, as the
  JAX trainer's all-``set_to_zero`` step does;
- the gradient is clipped to a global norm of 3 as optax's
  clip_by_global_norm does: g * max_norm / norm when norm >= max_norm,
  with the norm over the trainable parameters only (not clip_grad_norm_,
  which adds 1e-6 to the norm);
- the noise synth draws from an explicit per-step torch.Generator;
- host batches go to the device as one pinned buffer and one non-blocking
  copy each, staged one batch ahead (:meth:`Trainer.device_prefetch`);
- the NaN guard is checked with a delay: the host never waits for the
  step it has just queued. Parameters update in place here, so a bounded
  ring of device snapshots (parameters and Adam moments, a few MB for v2)
  keeps the state from before each unchecked step, and NanLossError
  carries the one from before the first non-finite step;
- checkpoints are the port's own format: torch.save of the model's and
  the optimizer's state dicts, the step and a meta dict.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ddsp_piano_torch.training.checkpoints import (CKPT_NAME,
                                                   import_tf_weights,
                                                   load_ckpt)

log = logging.getLogger(__name__)

_STAGED_DTYPES = {np.dtype(np.float32): torch.float32,
                  np.dtype(np.int32): torch.int32}


class NanLossError(RuntimeError):
    """A training loss became non-finite. ``state`` is the training state
    (the checkpoint dict of Trainer.state_dict) from just before the first
    non-finite step."""

    def __init__(self, message: str, state=None):
        super().__init__(message)
        self.state = state


class BatchStager:
    """Host batch dict -> device tensors with one non-blocking copy.

    The batch's arrays (float32 or int32) are packed, key by key, into one
    pinned byte buffer, copied once, and viewed back on the device with
    their own dtypes and shapes. The layout is taken from each batch
    itself, so a batch of other shapes is staged correctly too. Two pinned
    buffers alternate; before one is refilled, the copy that last read it
    is waited for.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._buffers = [None, None]
        self._events = [None, None]
        self._turn = 0

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        keys = sorted(k for k in batch if k != 'filename')
        arrays = [np.ascontiguousarray(batch[k]) for k in keys]
        for k, a in zip(keys, arrays):
            if a.dtype not in _STAGED_DTYPES:
                raise TypeError(f"batch[{k!r}] has dtype {a.dtype}; the "
                                "trainer stages float32 and int32 arrays")
        if self.device.type != 'cuda':
            return {k: torch.from_numpy(a).to(self.device)
                    for k, a in zip(keys, arrays)}
        total = sum(a.nbytes for a in arrays)
        i = self._turn
        self._turn ^= 1
        if self._buffers[i] is None or self._buffers[i].numel() < total:
            self._buffers[i] = torch.empty(total, dtype=torch.uint8,
                                           pin_memory=True)
        elif self._events[i] is not None:
            self._events[i].synchronize()
        host = self._buffers[i].numpy()
        offsets, off = [], 0
        for a in arrays:
            host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
            offsets.append(off)
            off += a.nbytes
        dev = self._buffers[i][:total].to(self.device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record()
        return {k: dev[o:o + a.nbytes].view(_STAGED_DTYPES[a.dtype]
                                            ).reshape(a.shape)
                for k, a, o in zip(keys, arrays, offsets)}


class Trainer:
    """Adam trainer for a PianoModel whose parameters live on its device."""

    def __init__(self, model, learning_rate: float = 1e-3,
                 grad_clip_norm: Optional[float] = 3.0,
                 first_phase: Optional[bool] = None,
                 nan_check_interval: int = 16, seed: int = 0,
                 record_timeline: bool = False):
        self.model = model
        self.device = model.device
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self.first_phase = first_phase
        self.seed = int(seed)
        self.mask = model.set_trainable(first_phase)
        self.named_params = [(n, p) for n, p in model.named_parameters()
                             if p.requires_grad]
        self.params = [p for _, p in self.named_params]
        self.optimizer = self._make_optimizer()
        self.step = 0
        self.stage = BatchStager(self.device)
        # Delayed NaN guard: (step, losses, ring slot) per unchecked step,
        # drained when nan_check_interval steps are pending (and by save
        # and validation_step). The ring holds one more snapshot than that.
        self.nan_check_interval = max(1, int(nan_check_interval))
        self._pending = []
        self._ring = [None] * (self.nan_check_interval + 1)
        # CUDA events (start, after forward, after backward, after the
        # update) of every step, when asked for: device-side phase times.
        self.timeline = [] if record_timeline else None

    def _make_optimizer(self) -> Optional[torch.optim.Adam]:
        """Adam over the trainable parameters; None when there is none."""
        if not self.params:
            return None
        return torch.optim.Adam(self.params, lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    # -- steps --------------------------------------------------------------

    def noise_generator(self, step: int) -> torch.Generator:
        """The noise synth's generator for one step, on the device."""
        return torch.Generator(device=self.device).manual_seed(
            (self.seed << 32) + 17 * (1 << 24) + int(step))

    def _as_device_batch(self, batch):
        if all(isinstance(v, torch.Tensor) for k, v in batch.items()
               if k != 'filename'):
            return {k: v.to(self.device) for k, v in batch.items()
                    if k != 'filename'}
        return self.stage(batch)

    def forward_backward(self, batch, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         events=None) -> Dict[str, torch.Tensor]:
        """Losses of one batch, with the gradient of total_loss in each
        trainable parameter's .grad (no backward when none is trainable).
        ``noise`` injects the noise synth's uniform draw (tests hand both
        sides the same draw)."""
        batch = self._as_device_batch(batch)
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)
        outputs = self.model(batch, noise=noise, generator=generator,
                             training=True)
        losses = outputs['losses']
        if events is not None:
            events[1].record()
        if self.optimizer is not None:
            losses['total_loss'].backward()
        if events is not None:
            events[2].record()
        return {k: v.detach() for k, v in losses.items()}

    def clip_gradients(self) -> None:
        """optax.clip_by_global_norm over the trainable parameters."""
        if not self.grad_clip_norm:
            return
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.grad_clip_norm
        divisor = torch.where(keep, torch.ones_like(norm), norm)
        factor = torch.where(keep, torch.ones_like(norm),
                             torch.full_like(norm, self.grad_clip_norm))
        for g in grads:
            g.div_(divisor).mul_(factor)

    def apply_gradients(self) -> None:
        if self.optimizer is None:
            return
        self.clip_gradients()
        self.optimizer.step()

    def train_step(self, batch, noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimization step; returns the losses as device scalars
        (reading one waits for the step)."""
        step = self.step
        slot = step % len(self._ring)
        self._snapshot(slot)
        events = None
        if self.timeline is not None and self.device.type == 'cuda':
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(4)]
            events[0].record()
        losses = self.forward_backward(batch, noise=noise,
                                       generator=self.noise_generator(step),
                                       events=events)
        self.apply_gradients()
        if events is not None:
            events[3].record()
            self.timeline.append(events)
        self.step += 1
        if len(self._pending) >= self.nan_check_interval:
            # The drained steps were queued before this one, so the host
            # waits for no step it has just queued.
            self.check_pending()
        self._pending.append((step, losses, slot))
        return losses

    def check_pending(self) -> None:
        """Read the losses of every unchecked step (one wait for all) and
        raise NanLossError, carrying the state from just before the first
        non-finite step, if there is one."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        values = torch.stack([torch.stack([v.reshape(()).float()
                                           for v in losses.values()])
                              for _, losses, _ in pending]).cpu()
        finite = torch.isfinite(values)
        for row, (step, losses, slot) in enumerate(pending):
            if not bool(finite[row].all()):
                key = list(losses)[int((~finite[row]).nonzero()[0])]
                raise NanLossError(f"Nan loss at step {step} with loss "
                                   f"{key}", state=self._snapshot_state(slot))

    def validation_step(self, batch, noise: Optional[torch.Tensor] = None):
        """(losses as floats, synthesized audio as numpy) without an
        update; the noise draw comes from a fixed generator."""
        self.check_pending()
        batch = self._as_device_batch(batch)
        with torch.no_grad():
            outputs = self.model(batch, noise=noise,
                                 generator=torch.Generator(
                                     device=self.device).manual_seed(0),
                                 training=True)
        losses = {k: float(v) for k, v in outputs['losses'].items()}
        return losses, outputs['audio_synth'].cpu().numpy()

    def device_prefetch(self, iterator: Iterable) -> Iterator[dict]:
        """Yield device batches, staging batch N + 1 right after the
        consumer has queued its step on batch N."""
        it = iter(iterator)
        try:
            staged = self.stage(next(it))
        except StopIteration:
            return
        while True:
            current = staged
            yield current
            try:
                staged = self.stage(next(it))
            except StopIteration:
                return

    def step_times(self):
        """[(total, forward, backward, update) ms] of every recorded step,
        from its CUDA events."""
        if not self.timeline:
            return []
        self.timeline[-1][3].synchronize()
        return [(e[0].elapsed_time(e[3]), e[0].elapsed_time(e[1]),
                 e[1].elapsed_time(e[2]), e[2].elapsed_time(e[3]))
                for e in self.timeline]

    # -- snapshots and checkpoints --------------------------------------------

    def _state_tensors(self):
        """The mutable training state as one flat list of tensors:
        trainable parameters, then each one's Adam moments."""
        tensors = [p.detach() for p in self.params]
        for p in self.params:
            state = self.optimizer.state.get(p)
            if state:
                tensors += [state['exp_avg'], state['exp_avg_sq']]
        return tensors

    def _snapshot(self, slot: int) -> None:
        tensors = self._state_tensors()
        held = self._ring[slot]
        if held is None or len(held[1]) != len(tensors):
            self._ring[slot] = (self.step,
                                [t.detach().clone() for t in tensors])
            return
        for dst, src in zip(held[1], tensors):
            dst.copy_(src, non_blocking=True)
        self._ring[slot] = (self.step, held[1])

    def _snapshot_state(self, slot: int) -> Dict[str, Any]:
        step, tensors = self._ring[slot]
        n = len(self.params)
        model = {k: v.detach().clone()
                 for k, v in self.model.state_dict().items()}
        for (name, _), value in zip(self.named_params, tensors[:n]):
            model[name] = value.clone()
        if self.optimizer is None:
            return {'model': model, 'optimizer': None, 'step': step}
        optimizer = self.optimizer.state_dict()
        opt_state = {}
        if len(tensors) > n:
            for i in range(n):
                opt_state[i] = {
                    # Adam counts its own steps; the snapshot's is `step`.
                    'step': torch.tensor(float(step)),
                    'exp_avg': tensors[n + 2 * i].clone(),
                    'exp_avg_sq': tensors[n + 2 * i + 1].clone()}
        optimizer['state'] = opt_state
        return {'model': model, 'optimizer': optimizer, 'step': step}

    def state_dict(self) -> Dict[str, Any]:
        return {'model': self.model.state_dict(),
                'optimizer': (None if self.optimizer is None
                              else self.optimizer.state_dict()),
                'step': self.step}

    def save(self, directory: str, meta: Optional[dict] = None,
             state: Optional[Dict[str, Any]] = None) -> str:
        """Write ``<directory>/ckpt.pt``: the current state after the NaN
        guard has checked it (raises NanLossError first otherwise), or the
        given ``state`` (NanLossError.state)."""
        if state is None:
            self.check_pending()
            state = self.state_dict()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, CKPT_NAME)
        tmp = path + '.tmp'
        torch.save(dict(state, meta=dict(meta or {})), tmp)
        os.replace(tmp, path)
        return path

    def restore(self, path: str) -> Dict[str, Any]:
        """Load a checkpoint written by :meth:`save` (a directory or the
        file); returns its meta dict. A checkpoint of another phase has
        another optimizer structure (or none, from a phase that trained no
        parameter): the moments then start afresh."""
        ckpt = load_ckpt(path, self.device)
        self.model.load_state_dict(ckpt['model'])
        if self.optimizer is not None:
            try:
                if ckpt['optimizer'] is None:
                    raise ValueError("the checkpoint has no optimizer state")
                self.optimizer.load_state_dict(ckpt['optimizer'])
            except ValueError:
                log.warning("Optimizer state structure changed (training-"
                            "phase switch?) - reinitializing optimizer "
                            "moments.")
                self.optimizer = self._make_optimizer()
        self.step = int(ckpt['step'])
        self._pending = []
        return dict(ckpt.get('meta', {}))

    def restore_tf(self, ckpt_path: str) -> Dict[str, list]:
        """Load a TF checkpoint's weights into the model (in place, so the
        optimizer keeps its parameters); the optimizer's moments and the
        step stay as they are, as in the JAX trainer. Returns
        import_tf_weights' report."""
        report = import_tf_weights(self.model, ckpt_path)
        self._pending = []
        return report
