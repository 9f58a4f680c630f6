"""Keras-compatible layers (counterpart of ddsp_piano_tpu/nn)."""

from ddsp_piano_torch.nn.layers import (GRU, Activation, Dense, Embedding, Fc,
                                        FcStack, LayerNormalization,
                                        Normalize, init_weights,
                                        split_to_dict)
from ddsp_piano_torch.nn.module import (DictModule, apply_stream,
                                        apply_with_state)

__all__ = ['DictModule', 'apply_stream', 'apply_with_state', 'GRU',
           'Activation', 'Dense', 'Embedding', 'Fc', 'FcStack',
           'LayerNormalization', 'Normalize', 'init_weights',
           'split_to_dict']
