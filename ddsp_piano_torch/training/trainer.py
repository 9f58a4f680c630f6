"""Trainer: one optimization step of a PianoModel on the card.

Counterpart of ddsp_piano_tpu/training/trainer.py (:160-260 and
:300-458):

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
- host batches go to the device staged one batch (or one K-step block)
  ahead (:meth:`Trainer.device_prefetch`, :meth:`Trainer.block_prefetch`):
  packed (training/staging.py BatchPacker: one pinned copy of 16-bit
  lanes a batch, decoded on the device bit-exactly) or as a dict (one
  pinned copy a key);
- :meth:`Trainer.train_steps` runs K steps on one staged ``(K, b, width)``
  block, each with the noise draw of its own step, so that its losses and
  parameters equal those of K calls of :meth:`Trainer.train_step`;
- the NaN guard is checked with a delay: the host never waits for the
  step it has just queued. Parameters update in place here, so a bounded
  ring of device snapshots (parameters and Adam moments, a few MB for v2)
  keeps the state from before each unchecked step (each unchecked block
  for train_steps), and NanLossError carries the one from before the
  first non-finite step (block);
- checkpoints are the port's own format: torch.save of the model's and
  the optimizer's state dicts, the step and a meta dict;
- in a process group (parallel/mesh.py; :152-158, :262-298 and :460-488
  there), each rank steps on its rows of the global batch. The Trainer
  broadcasts rank 0's state when it is made and restored
  (:meth:`Trainer.distribute_state`); after backward, one all-reduce a
  step sums a flat float32 buffer of the trainable gradients and the
  losses, divided by the ranks, so that every rank clips and applies the
  gradient of the global batch's mean loss and reads the global losses
  (the NaN guard then raises in every rank at the same step). The noise
  draw is a rank's rows of the global batch's (parallel.mesh.RankDraw),
  and an injected ``noise=`` is the global batch's draw, of which the
  Trainer keeps the rank's rows. validation_step gathers the audio rows
  to every rank. With one rank in a group, the reduce is a sum over one
  rank divided by 1: the single-process step bit for bit.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ddsp_piano_torch.parallel import mesh
from ddsp_piano_torch.training.checkpoints import (CKPT_NAME,
                                                   import_tf_weights,
                                                   load_ckpt)
from ddsp_piano_torch.training.staging import BatchPacker

log = logging.getLogger(__name__)

_STAGED_DTYPES = {np.dtype(np.float32): torch.float32,
                  np.dtype(np.int32): torch.int32,
                  np.dtype(np.int16): torch.int16}


class NanLossError(RuntimeError):
    """A training loss became non-finite. ``state`` is the training state
    (the checkpoint dict of Trainer.state_dict) from just before the first
    non-finite step (block, for Trainer.train_steps)."""

    def __init__(self, message: str, state=None):
        super().__init__(message)
        self.state = state


class BatchStager:
    """Host arrays -> device tensors, one pinned buffer and one
    non-blocking copy each.

    Called with a dict of float32, int32 or int16 arrays (a batch's keys;
    'filename' is dropped), it returns the dict of device tensors. Each key
    has two pinned buffers that alternate; before one is refilled, the copy
    that last read it is waited for.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._buffers = {}
        self._events = {}
        self._turn = {}

    def _one(self, key: str, a: np.ndarray) -> torch.Tensor:
        if self.device.type != 'cuda':
            return torch.from_numpy(a).to(self.device)
        i = self._turn.get(key, 0)
        self._turn[key] = i ^ 1
        slot = (key, i)
        buffer = self._buffers.get(slot)
        if buffer is None or buffer.numel() < a.nbytes:
            buffer = self._buffers[slot] = torch.empty(
                a.nbytes, dtype=torch.uint8, pin_memory=True)
        elif slot in self._events:
            self._events[slot].synchronize()
        buffer.numpy()[:a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = buffer[:a.nbytes].to(self.device, non_blocking=True)
        self._events[slot] = torch.cuda.Event()
        self._events[slot].record()
        return dev.view(_STAGED_DTYPES[a.dtype]).reshape(a.shape)

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        arrays = {k: np.ascontiguousarray(batch[k]) for k in sorted(batch)
                  if k != 'filename'}
        for k, a in arrays.items():
            if a.dtype not in _STAGED_DTYPES:
                raise TypeError(f"batch[{k!r}] has dtype {a.dtype}; the "
                                "trainer stages float32 and int32 arrays "
                                "(int16 lanes for a packed batch)")
        return {k: self._one(k, a) for k, a in arrays.items()}


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
        # The packed wire format, built from the first packed batch;
        # pack_wire False forces the exact two-lane encodings (packed32).
        self.pack_wire = True
        self._packer = None
        # Delayed NaN guard: (step, losses, ring slot) per unchecked step
        # or block, drained when nan_check_interval entries are pending
        # (and by save and validation_step). The ring holds one more
        # snapshot than that.
        self.nan_check_interval = max(1, int(nan_check_interval))
        self._pending = []
        self._ring = [None] * (self.nan_check_interval + 1)
        # CUDA events (start, after forward, after backward, after the
        # update) of every step, when asked for: device-side phase times;
        # in a process group also each reduce's (start, end).
        self.timeline = [] if record_timeline else None
        self.reduce_timeline = [] if record_timeline else None
        # In a process group: the ranks, and the bytes each step's reduce
        # sums.
        self.distributed = mesh.in_group()
        self.world = mesh.world_size()
        self.reduce_bytes = 0
        self.distribute_state()

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
        """A host batch dict, a dict of tensors or a packed ``(b, width)``
        lane tensor (pack_batch) -> the batch dict on the device."""
        if isinstance(batch, torch.Tensor):
            if self._packer is None:
                raise ValueError("Got a packed batch but no BatchPacker - "
                                 "stage batches with pack_batch or "
                                 "pack_block.")
            return self._packer.unpack(batch.to(self.device))
        if all(isinstance(v, torch.Tensor) for k, v in batch.items()
               if k != 'filename'):
            return {k: v.to(self.device) for k, v in batch.items()
                    if k != 'filename'}
        return self.stage(batch)

    def _rank_noise(self, batch, noise, generator):
        """In a process group: this rank's rows of an injected global draw
        (a tensor of k x global batch rows, or a list of them; a scalar
        loop shift stays), and a RankDraw around the generator."""
        if not self.distributed:
            return noise, generator
        global_batch = next(iter(batch.values())).shape[0] * self.world
        if isinstance(noise, (list, tuple)):
            noise = [self._rank_noise(batch, n, None)[0] for n in noise]
        elif isinstance(noise, torch.Tensor) and noise.dim() > 0:
            noise = mesh.take_rows(noise, global_batch)
        if generator is not None:
            generator = mesh.RankDraw(generator, global_batch)
        return noise, generator

    def forward_backward(self, batch, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         events=None) -> Dict[str, torch.Tensor]:
        """Losses of one batch, with the gradient of total_loss in each
        trainable parameter's .grad (no backward when none is trainable).
        ``noise`` injects the noise synth's uniform draw (tests hand both
        sides the same draw). In a process group, the gradients and the
        losses are those of the global batch (one all-reduce)."""
        batch = self._as_device_batch(batch)
        noise, generator = self._rank_noise(batch, noise, generator)
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
        losses = {k: v.detach() for k, v in losses.items()}
        if self.distributed:
            losses = self.all_reduce_step(losses)
        return losses

    def all_reduce_step(self, losses: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Average the trainable gradients and the losses over the ranks:
        one float32 buffer, summed by one all-reduce and divided by the
        ranks; each .grad becomes a view of it. Returns the averaged
        losses."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        keys = list(losses)
        buffer = torch.cat([g.reshape(-1) for g in grads]
                           + [losses[k].reshape(1).float() for k in keys])
        self.reduce_bytes = buffer.numel() * buffer.element_size()
        events = None
        if self.reduce_timeline is not None and self.device.type == 'cuda':
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        dist.all_reduce(buffer)
        buffer.div_(self.world)
        if events is not None:
            events[1].record()
            self.reduce_timeline.append(events)
        offset = 0
        for p in self.params:
            p.grad = buffer[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return {k: buffer[offset + i] for i, k in enumerate(keys)}

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

    def _step(self, batch, noise: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """One optimization step with the noise draw of step self.step,
        without the NaN guard."""
        events = None
        if self.timeline is not None and self.device.type == 'cuda':
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(4)]
            events[0].record()
        losses = self.forward_backward(
            batch, noise=noise, generator=self.noise_generator(self.step),
            events=events)
        self.apply_gradients()
        if events is not None:
            events[3].record()
            self.timeline.append(events)
        self.step += 1
        return losses

    def _guard(self, step: int, losses: Dict[str, torch.Tensor],
               slot: int) -> None:
        if len(self._pending) >= self.nan_check_interval:
            # The drained entries were queued before this one, so the host
            # waits for no step it has just queued.
            self.check_pending()
        self._pending.append((step, losses, slot))

    def train_step(self, batch, noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimization step; returns the losses as device scalars
        (reading one waits for the step)."""
        step = self.step
        slot = step % len(self._ring)
        self._snapshot(slot)
        losses = self._step(batch, noise=noise)
        self._guard(step, losses, slot)
        return losses

    def train_steps(self, batches) -> Dict[str, torch.Tensor]:
        """``K`` optimization steps on one block: a list of host batches,
        a packed ``(K, b, width)`` lane tensor (pack_block) or a dict of
        ``(K, ...)`` tensors (stack_batches). Step i draws its noise from
        noise_generator(step + i), as K calls of train_step would, so the
        losses and parameters are those of K single steps. Returns each
        loss as a ``(K,)`` device tensor. The NaN guard takes the block as
        one entry: a non-finite loss anywhere in it raises NanLossError
        with the state from before the block."""
        if isinstance(batches, (list, tuple)):
            items = list(batches)
        elif isinstance(batches, torch.Tensor):
            items = list(batches.unbind(0))
        else:
            items = [{k: v[i] for k, v in batches.items()}
                     for i in range(len(next(iter(batches.values()))))]
        step = self.step
        slot = step % len(self._ring)
        self._snapshot(slot)
        per_step = [self._step(item) for item in items]
        losses = {k: torch.stack([s[k] for s in per_step])
                  for k in per_step[0]}
        self._guard(step, losses, slot)
        return losses

    def check_pending(self) -> None:
        """Read the losses of every unchecked step or block (one wait for
        all) and raise NanLossError, carrying the state from just before
        the first non-finite one, if there is one."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        finite = torch.stack([torch.stack([torch.isfinite(v).all()
                                           for v in losses.values()])
                              for _, losses, _ in pending]).cpu()
        for row, (step, losses, slot) in enumerate(pending):
            if not bool(finite[row].all()):
                key = list(losses)[int((~finite[row]).nonzero()[0])]
                raise NanLossError(f"Nan loss at step {step} with loss "
                                   f"{key}", state=self._snapshot_state(slot))

    def validation_step(self, batch, noise: Optional[torch.Tensor] = None):
        """(losses as floats, synthesized audio as numpy) without an
        update; the noise draw comes from a fixed generator. In a process
        group ``batch`` is this rank's rows (slice_local_batch): the
        losses are the global batch's and the audio holds every rank's
        rows, in the global batch's order."""
        self.check_pending()
        batch = self._as_device_batch(batch)
        noise, generator = self._rank_noise(
            batch, noise, torch.Generator(device=self.device).manual_seed(0))
        with torch.no_grad():
            outputs = self.model(batch, noise=noise, generator=generator,
                                 training=True)
        losses, audio = outputs['losses'], outputs['audio_synth']
        if self.distributed:
            keys = list(losses)
            values = torch.stack([losses[k].float() for k in keys])
            dist.all_reduce(values)
            values.div_(self.world)
            losses = dict(zip(keys, values.unbind(0)))
            parts = [torch.empty_like(audio) for _ in range(self.world)]
            dist.all_gather(parts, audio.contiguous())
            audio = torch.cat(parts)
        return ({k: float(v) for k, v in losses.items()},
                audio.cpu().numpy())

    # -- distribution ---------------------------------------------------------

    def distribute_state(self) -> None:
        """Broadcast rank 0's training state to every rank of the process
        group: the model's parameters and buffers, the optimizer's moments
        and step counts and the step (the ranks never rely on seeds alone
        to agree). No-op outside a group."""
        if not self.distributed:
            return
        for value in self.model.state_dict().values():
            if value.device == self.device:
                dist.broadcast(value, 0)
            else:
                staged = value.to(self.device)
                dist.broadcast(staged, 0)
                value.copy_(staged)
        counts = []
        if self.optimizer is not None:
            for p in self.params:
                state = self.optimizer.state.get(p, {})
                for key in sorted(state):
                    value = state[key]
                    if not isinstance(value, torch.Tensor):
                        continue
                    if value.device == self.device:
                        dist.broadcast(value, 0)
                    else:
                        counts.append(value)
        scalars = torch.tensor([float(self.step)]
                               + [float(c) for c in counts],
                               dtype=torch.float64, device=self.device)
        dist.broadcast(scalars, 0)
        self.step = int(scalars[0])
        for count, value in zip(counts, scalars[1:].tolist()):
            count.fill_(value)

    def distribute_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of a batch that every rank holds in full, on
        the device."""
        return self._as_device_batch(mesh.slice_local_batch(batch))

    def distribute_dataset(self, dataset) -> Iterator:
        """This rank's rows of each batch of its host's stream (host
        arrays; stage them with device_prefetch or block_prefetch)."""
        for batch in dataset:
            yield mesh.slice_local_batch(batch, within_host=True)

    def psum(self, value):
        """The sum of each leaf of a tree (dict, list, tuple), over its
        elements and over the ranks (the ddsp Trainer's psum: JAX sums a
        global array). In a multi-rank run a leaf must be a tensor: the
        local sum of host numpy would silently drop the other ranks'
        rows."""
        if isinstance(value, dict):
            return {k: self.psum(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(self.psum(v) for v in value)
        if self.world > 1 and not isinstance(value, torch.Tensor):
            raise TypeError(
                "Trainer.psum in a multi-rank run requires tensors (a "
                f"rank's rows); got {type(value).__name__}, whose local sum "
                "would silently be wrong.")
        total = torch.as_tensor(value).sum()
        if self.distributed:
            total = total.to(self.device)
            dist.all_reduce(total)
        return total

    def _packer_for(self, batch) -> BatchPacker:
        if self._packer is None:
            self._packer = BatchPacker(batch, wire=self.pack_wire)
        return self._packer

    def pack_batch(self, batch) -> torch.Tensor:
        """Stage one host batch as one packed ``(b, width)`` int16 lane
        tensor on the device: one pinned copy (train_step decodes it)."""
        lanes = self._packer_for(batch).pack(batch).view(np.int16)
        return self.stage({'packed': lanes})['packed']

    def pack_block(self, batches) -> torch.Tensor:
        """Stage K host batches as one packed ``(K, b, width)`` lane tensor:
        one pinned copy a block (train_steps decodes it)."""
        lanes = self._packer_for(batches[0]).pack_block(batches)
        return self.stage({'packed': lanes.view(np.int16)})['packed']

    def stack_batches(self, batches) -> Dict[str, torch.Tensor]:
        """K host batches as one dict of ``(K, ...)`` device tensors: one
        pinned copy a key."""
        return self.stage({k: np.stack([np.asarray(b[k]) for b in batches])
                           for k in batches[0] if k != 'filename'})

    def device_prefetch(self, iterator: Iterable, packed: bool = False
                        ) -> Iterator:
        """Yield device batches (packed lane tensors with ``packed``, else
        dicts), staging batch N + 1 right after the consumer has queued its
        step on batch N."""
        stage = self.pack_batch if packed else self.stage
        it = iter(iterator)
        try:
            staged = stage(next(it))
        except StopIteration:
            return
        while True:
            current = staged
            yield current
            try:
                staged = stage(next(it))
            except StopIteration:
                return

    def block_prefetch(self, iterator: Iterable, k: int,
                       packed: bool = False) -> Iterator:
        """Yield K-step blocks for train_steps, each staged as one packed
        ``(K, b, width)`` copy (``packed``) or one copy a key, the next
        block staged after the consumer has queued its steps on this one.
        A trailing partial block (< k batches) is dropped."""
        stage = self.pack_block if packed else self.stack_batches
        it = iter(iterator)
        while True:
            block = list(itertools.islice(it, k))
            if len(block) < k:
                return
            yield stage(block)

    def step_times(self):
        """[(total, forward, backward, update) ms] of every recorded step,
        from its CUDA events."""
        if not self.timeline:
            return []
        self.timeline[-1][3].synchronize()
        return [(e[0].elapsed_time(e[3]), e[0].elapsed_time(e[1]),
                 e[1].elapsed_time(e[2]), e[2].elapsed_time(e[3]))
                for e in self.timeline]

    def reduce_times(self):
        """ms of every recorded step's all-reduce (a process group on a
        card), from its CUDA events."""
        if not self.reduce_timeline:
            return []
        self.reduce_timeline[-1][1].synchronize()
        return [e[0].elapsed_time(e[1]) for e in self.reduce_timeline]

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
        self.distribute_state()
        return dict(ckpt.get('meta', {}))

    def restore_tf(self, ckpt_path: str) -> Dict[str, list]:
        """Load a TF checkpoint's weights into the model (in place, so the
        optimizer keeps its parameters); the optimizer's moments and the
        step stay as they are, as in the JAX trainer. Returns
        import_tf_weights' report."""
        report = import_tf_weights(self.model, ckpt_path)
        self._pending = []
        self.distribute_state()
        return report
