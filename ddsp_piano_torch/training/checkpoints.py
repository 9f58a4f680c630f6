"""Checkpoints: the port's own ``ckpt.pt`` and TF object checkpoints.

Counterpart of ddsp_piano_tpu/training/checkpoints.py (the TF half,
:179-425) and of the JAX CLI's ``restore_params``
(synthesize_midi_file.py:61-84). The reference ships TF object-based
checkpoints whose variables sit under Keras object paths, e.g.
``model/monophonic_network/model/layer_with_weights-1/cell/kernel``.
:func:`tf_name_map` walks the port's modules and names each parameter's
TF variable by the JAX package's rules: a Sequential counts only its
weighted layers, a GRU's weights nest under ``cell``, an Embedding's under
``embeddings``. The port's parameters have the JAX package's names and
shapes, so both packages give the same map.

TensorFlow is imported lazily, on the host, and only to read or write a
TF checkpoint: nothing else in the port needs it.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn as tnn

from ddsp_piano_torch import nn
from ddsp_piano_torch.models import sub_modules as sm

log = logging.getLogger(__name__)

CKPT_NAME = 'ckpt.pt'
_TF_SUFFIX = '/.ATTRIBUTES/VARIABLE_VALUE'


# -- the port's own checkpoints -----------------------------------------------


def latest_checkpoint(directory: str) -> Optional[str]:
    """``<directory>/ckpt.pt`` if it exists, else None."""
    path = os.path.join(directory, CKPT_NAME)
    return path if os.path.isfile(path) else None


def _ckpt_file(path: str) -> str:
    return os.path.join(path, CKPT_NAME) if os.path.isdir(path) else path


def load_ckpt(path: str, device=None) -> Dict[str, Any]:
    """The dict that Trainer.save wrote (a directory or the file), on
    ``device``; on the CPU (the default) memory-mapped, so what the caller
    does not touch (the optimizer's moments) is never read."""
    device = torch.device(device or 'cpu')
    return torch.load(_ckpt_file(path), map_location=device,
                      weights_only=True, mmap=device.type == 'cpu')


def read_meta(path: str) -> Dict[str, Any]:
    return dict(load_ckpt(path).get('meta', {}))


# -- TF checkpoints -----------------------------------------------------------


def _tensorflow():
    try:
        import tensorflow as tf  # host-side reader and writer only
    except ImportError as e:
        raise ImportError(
            "TensorFlow is needed only to read or write TF checkpoints, and "
            f"it is not installed here ({e}). The port's own checkpoints "
            "(ckpt.pt) need no TensorFlow.") from e
    return tf


def _tf_prefix(tf, ckpt_path: str) -> str:
    """A TF checkpoint prefix from a prefix or a directory. A directory
    without TF's ``checkpoint`` index file (export_tf_weights writes none,
    as the JAX package's does not) is read when it holds one prefix."""
    if not os.path.isdir(ckpt_path):
        return ckpt_path
    resolved = tf.train.latest_checkpoint(ckpt_path)
    if resolved is not None:
        return resolved
    prefixes = sorted(name[:-len('.index')] for name in os.listdir(ckpt_path)
                      if name.endswith('.index'))
    if len(prefixes) != 1:
        raise FileNotFoundError(
            f"No TF checkpoint index in {ckpt_path!r}, and {len(prefixes)} "
            f"checkpoint prefixes: {prefixes}")
    return os.path.join(ckpt_path, prefixes[0])


def read_tf_checkpoint(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every model variable of a TF object checkpoint, as numpy, by its
    name under ``model/`` without the attribute suffix."""
    tf = _tensorflow()
    reader = tf.train.load_checkpoint(_tf_prefix(tf, ckpt_path))
    out = {}
    for name in reader.get_variable_to_shape_map():
        if not name.endswith(_TF_SUFFIX):
            continue
        clean = name[:-len(_TF_SUFFIX)]
        if clean.startswith('model/'):
            out[clean[len('model/'):]] = reader.get_tensor(name)
    return out


def is_tf_checkpoint(path: Optional[str]) -> bool:
    """A TF object checkpoint has .index files (prefix or directory)."""
    if path is None:
        return False
    if os.path.isfile(path + '.index'):
        return True
    return os.path.isdir(path) and any(name.endswith('.index')
                                       for name in os.listdir(path))


Pairs = List[Tuple[str, str]]


def _seq_paths(seq: tnn.Module) -> Pairs:
    """A Keras Sequential counts only its weighted layers."""
    out, weighted = [], 0
    for i, layer in enumerate(seq):
        sub = _module_paths(layer)
        if not sub:
            continue
        out += [(f'{i}.{rel}', f'layer_with_weights-{weighted}/{tf_rel}')
                for rel, tf_rel in sub]
        weighted += 1
    return out


def _module_paths(module: tnn.Module) -> Pairs:
    """(parameter name within the module, TF name within it) pairs."""
    if isinstance(module, nn.GRU):
        return [(w, f'cell/{w}')
                for w in ('kernel', 'recurrent_kernel', 'bias')]
    if isinstance(module, nn.Dense):
        return [('kernel', 'kernel'), ('bias', 'bias')]
    if isinstance(module, nn.LayerNormalization):
        return [('gamma', 'gamma'), ('beta', 'beta')]
    if isinstance(module, nn.Normalize):
        return [('scale', 'scale'), ('shift', 'shift')]
    if isinstance(module, nn.Embedding):
        return [('embeddings', 'embeddings')]
    if isinstance(module, tnn.Sequential):   # includes Fc and FcStack
        return _seq_paths(module)
    if isinstance(module, nn.Activation):
        return []
    raise NotImplementedError(
        f"No TF path rule for module {type(module).__name__}")


def _children(module: tnn.Module) -> List[Tuple[str, str]]:
    """A sub-module's weighted children: (attribute, TF name prefix)."""
    if isinstance(module, (sm.ContextNetwork, sm.SimpleContextNet,
                           sm.MonophonicNetwork)):
        return [('model', 'model'), ('dense_out', 'dense_out')]
    if isinstance(module, sm.MonophonicDeepNetwork):
        # The reference wraps this GRU in nn.Rnn, a container holding the
        # Keras GRU under 'rnn' (v2 ckpt: model/layer_with_weights-0/rnn/..).
        return ([(f'input_stacks.{i}', f'input_stacks/{i}')
                 for i in range(len(module.input_stacks))]
                + [('model', 'model/layer_with_weights-0/rnn'),
                   ('out_stack', 'out_stack'), ('dense_out', 'dense_out')])
    if isinstance(module, sm.FiLMContextNetwork):
        attrs = ('conditioning_head', 'pedal_head', 'piano_id_head',
                 'main_model', 'film_input_reshape', 'output_layer')
    elif isinstance(module, sm.OneHotZEncoder):
        attrs = ('embedding', 'inharm_embedding', 'detune_embedding')
    elif isinstance(module, sm.BackgroundNoiseFilter):
        attrs = ('embedding',)
    elif isinstance(module, sm.DeepInharmonicity):
        attrs = ('hidden_layers', 'scale_layer', 'out_layer')
    elif isinstance(module, sm.PartialMasking):
        attrs = ()
    elif isinstance(module, sm.MultiInstrumentReverb):
        return [('reverb_dict', 'reverb_dict/layer_with_weights-0')]
    elif isinstance(module, sm.MultiInstrumentFeedbackDelayReverb):
        attrs = module._EMBEDDINGS
    elif isinstance(module, sm.JointParametricInharmTuning):
        attrs = module.WEIGHT_NAMES
    elif isinstance(module, (sm.Detuner, sm.DictDetuner,
                             sm.DictInharmonicityModel)):
        attrs = ('layer',)
    elif isinstance(module, sm.DeepDetuner):
        attrs = ('hidden_layers', 'out_layer')
    elif isinstance(module, sm.SurrogateModule):
        attrs = ('amp_model',)
    else:
        raise NotImplementedError(
            f"No TF mapping for sub-module {type(module).__name__}")
    return [(a, a) for a in attrs]


def _submodule_paths(module: tnn.Module) -> Pairs:
    """(parameter name within a slot, TF name within model/<slot>)."""
    if isinstance(module, sm.InharmonicityNetwork):
        return [(leaf, leaf) for leaf in (
            'model_specific_weight', 'slopes', 'offsets', 'slopes_modifier',
            'offsets_modifier')]
    if isinstance(module, sm.NoteRelease):
        return [('cell.release_duration', 'layer/cell/release_duration')]
    return [(f'{attr}.{rel}', f'{tf_prefix}/{tf_rel}')
            for attr, tf_prefix in _children(module)
            for rel, tf_rel in _module_paths(module.get_submodule(attr))]


def tf_name_map(model) -> Dict[str, str]:
    """TF variable name (under ``model/``) -> the port's parameter name."""
    return {f'{slot}/{tf_rel}': f'{slot}.{rel}'
            for slot, module in model._module_slots()
            for rel, tf_rel in _submodule_paths(module)}


def export_tf_weights(model, ckpt_path: str) -> str:
    """Write the model's parameters as a TF object checkpoint under the
    Keras object paths of the reference's ``tf.train.Checkpoint(model=
    model)``, as the JAX package's export_tf_weights does. Returns the
    written prefix."""
    tf = _tensorflow()
    params = dict(model.named_parameters())
    root = tf.train.Checkpoint()
    nodes = {(): root}

    def node(parts: Tuple[str, ...]):
        if parts not in nodes:
            child = tf.train.Checkpoint()
            setattr(node(parts[:-1]), parts[-1], child)
            nodes[parts] = child
        return nodes[parts]

    for tf_name, name in tf_name_map(model).items():
        parts = tuple(tf_name.split('/'))
        value = params[name].detach().cpu().numpy()
        setattr(node(parts[:-1]), parts[-1], tf.Variable(value))
    os.makedirs(os.path.dirname(os.path.abspath(ckpt_path)), exist_ok=True)
    return tf.train.Checkpoint(model=root).write(ckpt_path)


def import_tf_weights(model, ckpt_path: str, strict: bool = True
                      ) -> Dict[str, list]:
    """Copy a TF checkpoint's variables into the model's parameters, bit
    for bit. Returns the JAX package's report (matched / missing /
    mismatched / unused names). With ``strict``, a missing or mis-shaped
    variable raises before any parameter changes."""
    tf_vars = read_tf_checkpoint(ckpt_path)
    params = dict(model.named_parameters())
    values, missing, mismatched = {}, [], []
    for tf_name, name in tf_name_map(model).items():
        if tf_name not in tf_vars:
            missing.append(tf_name)
            continue
        value = np.asarray(tf_vars[tf_name], dtype=np.float32)
        if tuple(value.shape) != tuple(params[name].shape):
            mismatched.append((tf_name, value.shape,
                               tuple(params[name].shape)))
            continue
        values[name] = (tf_name, value)
    if strict and (missing or mismatched):
        raise ValueError(f"TF checkpoint import incomplete: missing="
                         f"{missing} mismatched={mismatched}")
    with torch.no_grad():
        for name, (_, value) in values.items():
            params[name].copy_(torch.from_numpy(value))
    matched = sorted(tf_name for tf_name, _ in values.values())
    return {'matched': matched, 'missing': sorted(missing),
            'mismatched': mismatched,
            'unused': sorted(set(tf_vars) - set(matched))}


def restore_params(model, ckpt: Optional[str]):
    """Load a checkpoint's weights into ``model`` (in place; returns it).

    A TF prefix or a directory holding ``.index`` files goes through
    import_tf_weights; a ``ckpt.pt`` file, or a directory holding one, has
    its ``model`` state loaded strictly. None keeps the initial weights.
    Anything else raises FileNotFoundError.
    """
    if ckpt is None:
        log.warning("No checkpoint: synthesizing with initial weights.")
        return model
    if is_tf_checkpoint(ckpt):
        log.info("Restoring TF checkpoint from %s", ckpt)
        report = import_tf_weights(model, ckpt)
        log.info("Imported %d variables.", len(report['matched']))
        return model
    if not os.path.isfile(_ckpt_file(ckpt)):
        raise FileNotFoundError(
            f"{ckpt!r} holds no checkpoint: neither a TF checkpoint (.index "
            f"files) nor the port's {CKPT_NAME}.")
    log.info("Restoring checkpoint from %s", _ckpt_file(ckpt))
    # Read on the host; load_state_dict copies the weights to the model's
    # device (one copy a parameter, none for the optimizer's moments).
    model.load_state_dict(load_ckpt(ckpt)['model'])
    return model
