"""gin-config compatibility: build a model from a ``.gin`` file.

Counterpart of ddsp_piano_tpu/configs/gin_compat.py: the parser of the gin
subset the reference's configs use (:26-272; macros, scoped
``@module.Class()`` references, ``Class.param = value`` lines, indented
``Class:`` blocks, lists, tuples, dicts and ``%macro`` substitution) and
the builder (:276-577) that maps the reference's selector names onto the
port's classes, so

    get_model('path/to/maestro-v2.gin', inference=True, duration=10.0)

builds the model the JAX package builds from the same file, with the
same parameter names and shapes. Layer input widths, which gin files never
state (Keras infers them when it builds), are threaded through each layer
chain from the conditioning layout, as the JAX builder does. The port's
modules take no ``name``: a gin ``name`` of a sub-module or layer is
dropped (processors and losses keep theirs). ``polyphonic_dag`` maps to
the folded-voice group (as in the JAX builder); its sequential DAG is
``PianoModel(..., use_sequential_dag=True)`` or
``models.default_model.build_polyphonic_processor_group(vectorized=False)``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from ddsp_piano_torch.ops import core as ops_core


# -----------------------------------------------------------------------------
# Parsing
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class MacroRef:
    name: str


@dataclasses.dataclass
class Ref:
    selector: str          # e.g. 'sub_modules.OneHotZEncoder'
    scope: str = ''        # e.g. 'context_net' or 'mono_net/dense1'
    called: bool = False   # @Class() vs @fn


@dataclasses.dataclass
class GinConfig:
    macros: Dict[str, Any]
    # bindings[class_name][scope][param] = value AST
    bindings: Dict[str, Dict[str, Dict[str, Any]]]

    def get(self, selector: str, scope: str = '',
            default: Optional[dict] = None) -> Dict[str, Any]:
        """Collect params for a selector: unscoped then scope-specific."""
        name = selector.rsplit('.', 1)[-1]
        by_scope = self.bindings.get(name, {})
        out = dict(by_scope.get('', {}))
        if scope:
            # Gin precedence: a LONGER (more specific) matching scope
            # suffix overrides a shorter one, so apply suffixes from
            # shortest to longest (the full scope last).
            parts = scope.split('/')
            for i in range(len(parts) - 1, -1, -1):
                key = '/'.join(parts[i:])
                out.update(by_scope.get(key, {}))
        return out if out or default is None else dict(default)


class _ValueParser:
    """Recursive-descent parser for the gin value grammar."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos] in ' \t\n':
            self.pos += 1

    def parse(self):
        value = self._value()
        self._skip_ws()
        if self.pos != len(self.text):
            raise ValueError(f"Trailing input in gin value: "
                             f"{self.text[self.pos:]!r}")
        return value

    def _value(self):
        self._skip_ws()
        c = self.text[self.pos]
        if c == '%':
            return self._macro()
        if c == '@':
            return self._ref()
        if c in '\'"':
            return self._string(c)
        if c == '[':
            return self._seq(']', list)
        if c == '(':
            return self._seq(')', tuple)
        if c == '{':
            return self._dict()
        return self._scalar()

    def _macro(self):
        m = re.match(r'%([A-Za-z_][\w.]*)', self.text[self.pos:])
        self.pos += m.end()
        return MacroRef(m.group(1))

    def _ref(self):
        m = re.match(r'@([\w./]+)(\(\))?', self.text[self.pos:])
        self.pos += m.end()
        path = m.group(1)
        called = m.group(2) is not None
        if '/' in path:
            scope, selector = path.rsplit('/', 1)
        else:
            scope, selector = '', path
        return Ref(selector=selector, scope=scope, called=called)

    def _string(self, quote):
        end = self.pos + 1
        while self.text[end] != quote:
            end += 1 + (self.text[end] == '\\')
        value = self.text[self.pos + 1:end]
        self.pos = end + 1
        return value

    def _seq(self, close, ctor):
        self.pos += 1
        items = []
        while True:
            self._skip_ws()
            if self.text[self.pos] == close:
                self.pos += 1
                return ctor(items)
            items.append(self._value())
            self._skip_ws()
            if self.text[self.pos] == ',':
                self.pos += 1

    def _dict(self):
        self.pos += 1
        out = {}
        while True:
            self._skip_ws()
            if self.text[self.pos] == '}':
                self.pos += 1
                return out
            key = self._value()
            self._skip_ws()
            assert self.text[self.pos] == ':', "expected ':' in dict"
            self.pos += 1
            out[key] = self._value()
            self._skip_ws()
            if self.text[self.pos] == ',':
                self.pos += 1

    def _scalar(self):
        m = re.match(r'[^\s,\]\)\}:]+', self.text[self.pos:])
        token = m.group(0)
        self.pos += m.end()
        if token == 'True':
            return True
        if token == 'False':
            return False
        if token == 'None':
            return None
        try:
            return int(token)
        except ValueError:
            pass
        try:
            return float(token)
        except ValueError:
            pass
        return token


def _strip_comment(line: str) -> str:
    out = []
    in_str = None
    for ch in line:
        if in_str:
            if ch == in_str:
                in_str = None
        elif ch in '\'"':
            in_str = ch
        elif ch == '#':
            break
        out.append(ch)
    return ''.join(out).rstrip()


def parse_gin_string(text: str) -> GinConfig:
    macros: Dict[str, Any] = {}
    bindings: Dict[str, Dict[str, Dict[str, Any]]] = {}

    def bind(selector_path: str, param: str, value_text: str):
        value = _ValueParser(value_text.strip()).parse()
        if '/' in selector_path:
            scope, selector = selector_path.rsplit('/', 1)
        else:
            scope, selector = '', selector_path
        name = selector.rsplit('.', 1)[-1]
        bindings.setdefault(name, {}).setdefault(scope, {})[param] = value

    # Join physical lines into statements by bracket balance.
    statements: List[Tuple[int, str]] = []  # (indent, text)
    pending = ''
    pending_indent = 0
    for raw in text.splitlines():
        line = _strip_comment(raw.replace('\t', '    '))
        if not line.strip():
            continue
        if pending:
            pending += ' ' + line.strip()
        else:
            pending = line.rstrip()
            pending_indent = len(line) - len(line.lstrip())
            pending = pending.strip()
        balance = (pending.count('[') - pending.count(']')
                   + pending.count('(') - pending.count(')')
                   + pending.count('{') - pending.count('}'))
        if balance == 0:
            statements.append((pending_indent, pending))
            pending = ''
    if pending:
        statements.append((pending_indent, pending))

    current_block: Optional[str] = None
    for indent, stmt in statements:
        if stmt.startswith('import '):
            current_block = None
            continue
        if indent == 0:
            current_block = None
        if stmt.endswith(':') and '=' not in stmt:
            current_block = stmt[:-1].strip()
            continue
        if '=' not in stmt:
            raise ValueError(f"Cannot parse gin statement: {stmt!r}")
        lhs, rhs = stmt.split('=', 1)
        lhs = lhs.strip()
        if indent > 0 and current_block is not None:
            bind(current_block, lhs, rhs)
        elif '.' in lhs:
            selector_path, param = lhs.rsplit('.', 1)
            bind(selector_path, param, rhs)
        else:
            macros[lhs] = _ValueParser(rhs.strip()).parse()
    return GinConfig(macros=macros, bindings=bindings)


def parse_gin_file(path: str) -> GinConfig:
    with open(path) as f:
        return parse_gin_string(f.read())


# -----------------------------------------------------------------------------
# Building models from parsed configs
# -----------------------------------------------------------------------------

_SCALE_FNS = {
    'exp_tanh': ops_core.exp_tanh,
    'exp_sigmoid': ops_core.exp_sigmoid,
    'core.exp_tanh': ops_core.exp_tanh,
    'core.exp_sigmoid': ops_core.exp_sigmoid,
    'inharm_synth.exp_tanh': ops_core.exp_tanh,
}

_ACTIVATIONS = {
    'tf.nn.leaky_relu': 'leaky_relu',
    'tf.nn.relu': 'relu',
    'tf.nn.tanh': 'tanh',
}


def _sub_module(cls, kwargs):
    kwargs = dict(kwargs)
    kwargs.pop('name', None)
    return cls(**kwargs)


class GinModelBuilder:
    """Assemble a PianoModel from a parsed reference gin config."""

    def __init__(self, config: GinConfig, inference: bool = False,
                 duration: Optional[float] = None,
                 first_phase: bool = True, **macro_overrides):
        self.config = config
        self.macros = dict(config.macros)
        self.macros['inference'] = inference
        if duration is not None:
            self.macros['duration'] = duration
        self.macros.update(macro_overrides)
        self.first_phase = first_phase
        self.inference = inference

    # -- resolution ---------------------------------------------------------

    def resolve(self, value):
        if isinstance(value, MacroRef):
            return self.resolve(self.macros[value.name])
        if isinstance(value, Ref):
            return self.resolve_ref(value)
        if isinstance(value, list):
            return [self.resolve(v) for v in value]
        if isinstance(value, tuple):
            return tuple(self.resolve(v) for v in value)
        if isinstance(value, dict):
            return {k: self.resolve(v) for k, v in value.items()}
        return value

    def params_for(self, ref: Ref, skip=()) -> Dict[str, Any]:
        raw = self.config.get(ref.selector, ref.scope)
        return {k: self.resolve(v) for k, v in raw.items() if k not in skip}

    def raw_param(self, ref: Ref, key: str):
        return self.config.get(ref.selector, ref.scope).get(key)

    def resolve_ref(self, ref: Ref):
        name = ref.selector.rsplit('.', 1)[-1]
        if not ref.called:
            if name in _SCALE_FNS:
                return _SCALE_FNS[name]
            if ref.selector in _ACTIVATIONS:
                return _ACTIVATIONS[ref.selector]
            raise KeyError(f"Unknown gin function reference @{ref.selector}")
        builder = getattr(self, f'build_{name}', None)
        if builder is None:
            raise KeyError(f"No adapter for gin reference "
                           f"@{ref.scope + '/' if ref.scope else ''}"
                           f"{ref.selector}()")
        return builder(ref)

    # -- layer chains -------------------------------------------------------

    def _layer_chain(self, specs: List[Ref], in_features: int):
        """Layers from @layers.* refs, each input width the previous
        layer's output width."""
        from ddsp_piano_torch import nn
        layers = []
        dim = in_features
        for ref in specs:
            name = ref.selector.rsplit('.', 1)[-1]
            kwargs = self.params_for(ref)
            if name == 'Dense':
                units = kwargs['units']
                layers.append(nn.Dense(units, dim,
                                       activation=kwargs.get('activation')))
                dim = units
            elif name == 'GRU':
                units = kwargs['units']
                layers.append(nn.GRU(units, dim))
                dim = units
            elif name == 'Normalize':
                layers.append(nn.Normalize(dim))
            elif name == 'LayerNormalization':
                layers.append(nn.LayerNormalization(dim))
            else:
                raise KeyError(f"Unknown layer type in gin config: {name}")
        return layers, dim

    # -- component adapters (named build_<ClassName>) -----------------------

    def build_PianoModel(self, ref: Ref):
        from ddsp_piano_torch.models import PianoModel
        raw = self.config.get('PianoModel')
        slots = {}
        # The z-encoder first: downstream widths depend on z_dim.
        order = ['z_encoder', 'note_release', 'parallelizer',
                 'inharm_model', 'detuner', 'surrogate_module',
                 'background_noise_model', 'reverb_model',
                 'context_network', 'monophonic_network', 'harmonic_masking',
                 'processor_group', 'losses']
        for slot in order:
            if slot in raw:
                slots[slot] = self.resolve(raw[slot])
        return PianoModel(**slots)

    def build_OneHotZEncoder(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        kwargs = self.params_for(ref)
        self._z_dim = kwargs.get('z_dim', 16)
        return _sub_module(sm.OneHotZEncoder, kwargs)

    def build_NoteRelease(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.NoteRelease, self.params_for(ref))

    def build_Parallelizer(self, ref: Ref):
        from ddsp_piano_torch.models import Parallelizer
        return _sub_module(Parallelizer, self.params_for(ref))

    def build_ContextNetwork(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        kwargs = self.params_for(ref, skip=('layers',))
        n_synths = self.resolve(MacroRef('n_synths'))
        z_dim = getattr(self, '_z_dim', 16)
        layers, dim = self._layer_chain(self.raw_param(ref, 'layers'),
                                        n_synths * 2 + 4 + z_dim)
        ctx = _sub_module(sm.ContextNetwork,
                          dict(kwargs, layers=layers, out_features=dim))
        self._context_dim = ctx.output_splits[0][1]
        return ctx

    def build_SimpleContextNet(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        kwargs = self.params_for(ref, skip=('layers',))
        layers, dim = self._layer_chain(self.raw_param(ref, 'layers'), 4)
        ctx = _sub_module(sm.SimpleContextNet,
                          dict(kwargs, layers=layers, out_features=dim))
        self._context_dim = ctx.output_splits[0][1]
        return ctx

    def build_FiLMContextNetwork(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        kwargs = self.params_for(ref)
        kwargs.setdefault('n_synths', self.resolve(MacroRef('n_synths')))
        self._context_dim = kwargs.get('context_dim', 32)
        return _sub_module(sm.FiLMContextNetwork, kwargs)

    def build_MonophonicNetwork(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        kwargs = self.params_for(ref, skip=('layers',))
        context_dim = getattr(self, '_context_dim', 32)
        layers, dim = self._layer_chain(self.raw_param(ref, 'layers'),
                                        1 + 2 + context_dim)
        return _sub_module(sm.MonophonicNetwork,
                           dict(kwargs, layers=layers, out_features=dim))

    def build_MonophonicDeepNetwork(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        kwargs = self.params_for(ref)
        kwargs.setdefault('context_dim', getattr(self, '_context_dim', 32))
        return _sub_module(sm.MonophonicDeepNetwork, kwargs)

    def build_InharmonicityNetwork(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return sm.InharmonicityNetwork()

    def build_ParametricTuning(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return sm.ParametricTuning()

    def build_JointParametricInharmTuning(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.JointParametricInharmTuning,
                           self.params_for(ref))

    def build_DeepInharmonicity(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.DeepInharmonicity, self.params_for(ref))

    def build_DictInharmonicityModel(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.DictInharmonicityModel, self.params_for(ref))

    def build_DictDetuner(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.DictDetuner, self.params_for(ref))

    def _detuner_kwargs(self, ref):
        kwargs = self.params_for(ref)
        kwargs.setdefault('use_detune',
                          True if self.inference else not self.first_phase)
        return kwargs

    def build_Detuner(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.Detuner, self._detuner_kwargs(ref))

    def build_DeepDetuner(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.DeepDetuner, self._detuner_kwargs(ref))

    def build_SurrogateModule(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.SurrogateModule, self.params_for(ref))

    def build_PartialMasking(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.PartialMasking, self.params_for(ref))

    def build_BackgroundNoiseFilter(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.BackgroundNoiseFilter, self.params_for(ref))

    def build_MultiInstrumentReverb(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        kwargs = self.params_for(ref)
        kwargs.setdefault('inference', self.inference)
        return _sub_module(sm.MultiInstrumentReverb, kwargs)

    def build_MultiInstrumentFeedbackDelayReverb(self, ref: Ref):
        from ddsp_piano_torch.models import sub_modules as sm
        return _sub_module(sm.MultiInstrumentFeedbackDelayReverb,
                           self.params_for(ref))

    # processors ------------------------------------------------------------

    def build_MultiInharmonic(self, ref: Ref):
        from ddsp_piano_torch import processors
        kwargs = self.params_for(ref)
        # The port's choice of oscillator front door, a build override
        # (synthesize_midi_file --oscillator).
        kwargs.setdefault('oscillator', self.macros.get('oscillator', 'skip'))
        return processors.MultiInharmonic(**kwargs)

    def build_InHarmonic(self, ref: Ref):
        from ddsp_piano_torch import processors
        return processors.InHarmonic(**self.params_for(ref))

    def build_SurrogateAdditive(self, ref: Ref):
        from ddsp_piano_torch import processors
        return processors.SurrogateAdditive(**self.params_for(ref))

    def build_DynamicSizeFilteredNoise(self, ref: Ref):
        from ddsp_piano_torch import processors
        return processors.DynamicSizeFilteredNoise(**self.params_for(ref))

    def build_NoiseBandNetSynth(self, ref: Ref):
        from ddsp_piano_torch import processors
        return processors.NoiseBandNetSynth(**self.params_for(ref))

    def build_Reverb(self, ref: Ref):
        from ddsp_piano_torch import processors
        return processors.Reverb(**self.params_for(ref))

    def build_FeedbackDelayNetwork(self, ref: Ref):
        from ddsp_piano_torch import processors
        return processors.FeedbackDelayNetwork(**self.params_for(ref))

    def build_ProcessorGroup(self, ref: Ref):
        dag_ref = self.config.get('ProcessorGroup').get('dag')
        if isinstance(dag_ref, Ref) and dag_ref.selector.endswith(
                'polyphonic_dag'):
            return self.build_polyphonic_dag(dag_ref)
        from ddsp_piano_torch.processors import ProcessorGroup
        return ProcessorGroup(self.resolve(dag_ref))

    def build_polyphonic_dag(self, ref: Ref):
        from ddsp_piano_torch.models import VectorizedPolyphonicProcessorGroup
        kwargs = self.params_for(ref)
        return VectorizedPolyphonicProcessorGroup(
            additive=kwargs['additive'],
            noise=kwargs['noise'],
            reverb=kwargs.get('reverb'),
            additive_controls=tuple(kwargs.get(
                'additive_controls',
                ('amplitudes', 'harmonic_distribution', 'f0_hz'))),
            noise_controls=tuple(kwargs.get('noise_controls',
                                            ('noise_magnitudes',))),
            reverb_controls=tuple(kwargs.get('reverb_controls', ())),
            n_synths=kwargs.get('n_synths', 16),
        )

    # losses ----------------------------------------------------------------

    def build_SpectralLoss(self, ref: Ref):
        from ddsp_piano_torch.models import losses as losses_lib
        kwargs = self.params_for(ref)
        kwargs.setdefault('sample_rate',
                          self.resolve(MacroRef('sample_rate')))
        return losses_lib.SpectralLoss(**kwargs)

    def build_ReverbRegularizer(self, ref: Ref):
        from ddsp_piano_torch.models import losses as losses_lib
        return losses_lib.ReverbRegularizer(**self.params_for(ref))

    def build_InharmonicityLoss(self, ref: Ref):
        from ddsp_piano_torch.models import losses as losses_lib
        return losses_lib.InharmonicityLoss(**self.params_for(ref))

    def build_LoudnessLoss(self, ref: Ref):
        from ddsp_piano_torch.models import losses as losses_lib
        return losses_lib.LoudnessLoss(**self.params_for(ref))

    # -- entry --------------------------------------------------------------

    def build(self):
        model_ref = self.config.get('get_model').get('model')
        if model_ref is None:
            raise ValueError("gin config does not bind get_model.model")
        return self.resolve(model_ref)


def build_from_gin(path: str, inference: bool = False,
                   duration: Optional[float] = None,
                   first_phase: bool = True, **overrides):
    """The PianoModel of a ``.gin`` file, its weights not initialised
    (configs.get_model gives them and a device)."""
    builder = GinModelBuilder(parse_gin_file(path), inference=inference,
                              duration=duration, first_phase=first_phase,
                              **overrides)
    return builder.build()
