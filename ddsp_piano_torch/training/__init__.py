"""Training (counterpart of ddsp_piano_tpu/training): the single-step
Adam trainer with its delayed NaN guard and checkpoints."""

from ddsp_piano_torch.training.trainer import NanLossError, Trainer

__all__ = ['NanLossError', 'Trainer']
