"""Keras-compatible layers (counterpart of ddsp_piano_tpu/nn)."""

from portbench.reference.nn.layers import (GRU, Activation, Dense, Embedding, Fc,
                                        FcStack, LayerNormalization,
                                        Normalize, init_weights,
                                        split_to_dict)
from portbench.reference.nn.module import DictModule

__all__ = ['DictModule', 'GRU',
           'Activation', 'Dense', 'Embedding', 'Fc', 'FcStack',
           'LayerNormalization', 'Normalize', 'init_weights',
           'split_to_dict']
