"""Keras-compatible layers as torch.nn.Modules.

Counterpart of ddsp_piano_tpu/nn/layers.py. Parameter names and shapes are
the JAX package's (Dense kernel (in, out), GRU bias (2, 3u), ...) and a
Sequential's children are numbered like the JAX params list, so a JAX
params pytree maps onto ``named_parameters()`` one to one (params.py).

Every module with parameters has ``reset_parameters(generator)``: the Keras
initializers (glorot_uniform, orthogonal, zeros, uniform/normal
embeddings) drawn from an explicit torch.Generator.

``enable_bf16_control()`` switches the control networks' matmuls (Dense,
the GRU's input projection and its recurrence) to bfloat16 operands, as
the JAX package's switch of the same name does; off by default.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_piano_torch.kernels.gru import gru_scan
from ddsp_piano_torch.ops import core


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """tf.nn.leaky_relu default (alpha = 0.2)."""
    return torch.where(x >= 0, x, alpha * x)


ACTIVATIONS = {
    None: lambda x: x,
    'leaky_relu': leaky_relu,
    'relu': torch.relu,
    # Rounded once from float64: the DeepDetuner's output layer feeds the
    # frequency path.
    'tanh': functools.partial(core.rounded, torch.tanh),
}


def _resolve_activation(activation):
    if callable(activation):
        return activation
    try:
        return ACTIVATIONS[activation]
    except KeyError:
        raise ValueError(f"Unknown activation {activation!r}") from None


def glorot_uniform_(tensor: torch.Tensor, generator: torch.Generator):
    fan_in, fan_out = tensor.shape[-2], tensor.shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        draw = torch.rand(tensor.shape, generator=generator,
                          dtype=torch.float32)
        tensor.copy_((2.0 * draw - 1.0) * limit)
    return tensor


# Opt-in bf16 control networks (ddsp_piano_tpu/nn/layers.py:66-87): the
# Dense and GRU matmuls take operands rounded to bfloat16. Off by default:
# the float32 numerics are the Keras ones that the released checkpoints and
# the tests hold. Read at call time, so it reaches every model built from
# these layers (renders, streams, serving and training steps); there is no
# environment variable.
_BF16_MATMUL = False


def enable_bf16_control(enabled: bool = True) -> None:
    global _BF16_MATMUL
    _BF16_MATMUL = bool(enabled)


def bf16_control() -> bool:
    """Whether the bf16 control networks are on."""
    return _BF16_MATMUL


def _mm(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x @ kernel; under the bf16 switch, of the operands rounded to
    bfloat16, the float32 product rounded once to bfloat16, as jnp.matmul
    of bfloat16 operands returns it (its gradients then round the same
    way: the product's cotangent, and each operand's gradient)."""
    if _BF16_MATMUL:
        return core.round_bf16(torch.matmul(core.round_bf16(x),
                                            core.round_bf16(kernel)))
    return torch.matmul(x, kernel)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32))


class Dense(nn.Module):
    """y = act(x @ kernel + bias); the kernel starts glorot_uniform or, with
    kernel_init='zeros', at zero (the Detuner's)."""

    def __init__(self, units: int, in_features: int, activation=None,
                 kernel_init: str = 'glorot_uniform'):
        super().__init__()
        if kernel_init not in ('glorot_uniform', 'zeros'):
            raise ValueError(f"Unknown kernel_init {kernel_init!r}")
        self.activation = _resolve_activation(activation)
        self.kernel_init = kernel_init
        self.kernel = _param(in_features, units)
        self.bias = _param(units)

    def reset_parameters(self, generator: torch.Generator):
        if self.kernel_init == 'zeros':
            nn.init.zeros_(self.kernel)
        else:
            glorot_uniform_(self.kernel, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return self.activation(_mm(x, self.kernel) + self.bias)


class Activation(nn.Module):
    def __init__(self, activation):
        super().__init__()
        self.activation = _resolve_activation(activation)

    def forward(self, x):
        return self.activation(x)


class LayerNormalization(nn.Module):
    """Keras LayerNormalization over the last axis, epsilon = 1e-3."""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = _param(features)

    def reset_parameters(self, generator: torch.Generator):
        nn.init.ones_(self.gamma)
        nn.init.zeros_(self.beta)

    def forward(self, x):
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
        xn = (x - mean) * torch.rsqrt(var + self.epsilon)
        return xn * self.gamma + self.beta


class Normalize(nn.Module):
    """ddsp nn.Normalize ('layer'): the statistics pool over every axis but
    the batch, so over time and channels jointly for a sequence: a render
    normalises the whole file at once. epsilon = 1e-5; scale and shift are
    (1, 1, 1, ch) as in the JAX package (layers.py:151-194), so its leaves
    load unchanged."""

    EPSILON = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1, 1, 1, features))
        self.shift = _param(1, 1, 1, features)

    def reset_parameters(self, generator: torch.Generator):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.shift)

    @property
    def features(self) -> int:
        return self.scale.shape[-1]

    def forward(self, x):
        axes = tuple(range(1, x.dim()))
        mean = torch.mean(x, dim=axes, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
        return self.apply_with_stats(x, mean, var)

    def apply_with_stats(self, x, mean, var):
        """Normalize with given statistics (broadcasting against x, e.g.
        (batch, 1, 1)): streaming synthesis sweeps the file for its
        whole-sequence mean and variance, then normalizes every chunk with
        them (ddsp_piano_tpu/nn/layers.py:180-188)."""
        xn = (x - mean) * torch.rsqrt(var + self.EPSILON)
        return xn * self.scale.reshape(-1) + self.shift.reshape(-1)


class Embedding(nn.Module):
    """Keras Embedding; out-of-range ids are clipped (layers.py:227-233)."""

    def __init__(self, input_dim: int, output_dim: int,
                 embeddings_init: str = 'uniform', init_mean: float = 0.0,
                 init_stddev: float = 0.05):
        super().__init__()
        self.embeddings_init = embeddings_init
        self.init_mean = init_mean
        self.init_stddev = init_stddev
        self.embeddings = _param(input_dim, output_dim)

    def reset_parameters(self, generator: torch.Generator):
        shape = self.embeddings.shape
        with torch.no_grad():
            if self.embeddings_init == 'uniform':
                draw = torch.rand(shape, generator=generator)
                self.embeddings.copy_(0.1 * draw - 0.05)
            elif self.embeddings_init == 'normal':
                draw = torch.randn(shape, generator=generator)
                self.embeddings.copy_(self.init_mean
                                      + self.init_stddev * draw)
            elif self.embeddings_init == 'zeros':
                self.embeddings.zero_()
            elif self.embeddings_init == 'ones':
                self.embeddings.fill_(1.0)
            else:
                raise ValueError(
                    f"Unknown embeddings_init {self.embeddings_init!r}")

    def forward(self, ids):
        ids = torch.as_tensor(ids, device=self.embeddings.device)
        if ids.is_floating_point():
            ids = ids.to(torch.int32)
        ids = ids.long().clamp(0, self.embeddings.shape[0] - 1)
        return self.embeddings[ids]


class GRU(nn.Module):
    """Keras GRU v2 (reset_after=True), gate order [z, r, h].

    The input projection of all steps is one matmul; the recurrence goes
    through kernels.gru.gru_scan (the CUDA kernel on the card). Under the
    bf16 switch both take bfloat16 operands (gru_scan's ``bf16``).
    """

    def __init__(self, units: int, in_features: int):
        super().__init__()
        self.units = units
        self.kernel = _param(in_features, 3 * units)
        self.recurrent_kernel = _param(units, 3 * units)
        self.bias = _param(2, 3 * units)

    def reset_parameters(self, generator: torch.Generator):
        glorot_uniform_(self.kernel, generator)
        with torch.no_grad():
            w = torch.empty(self.recurrent_kernel.shape)
            nn.init.orthogonal_(w, generator=generator)
            self.recurrent_kernel.copy_(w)
        nn.init.zeros_(self.bias)

    def forward(self, x, initial_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
        """x: (batch, time, in_features) -> (batch, time, units); with
        ``return_state`` also the final hidden state (batch, units), which
        streaming synthesis carries into the next chunk."""
        b = x.shape[0]
        x_proj = _mm(x, self.kernel) + self.bias[0]
        x_proj = x_proj.transpose(0, 1).contiguous()     # (time, batch, 3u)
        h0 = (x.new_zeros((b, self.units)) if initial_state is None
              else initial_state)
        hs = gru_scan(x_proj, self.recurrent_kernel, self.bias[1], h0,
                      _BF16_MATMUL)
        out = hs.transpose(0, 1)
        if return_state:
            return out, hs[-1]
        return out


class Fc(nn.Sequential):
    """ddsp nn.Fc: Dense -> Keras LayerNorm -> LeakyReLU."""

    def __init__(self, ch: int, in_features: int,
                 nonlinearity='leaky_relu'):
        super().__init__(Dense(ch, in_features), LayerNormalization(ch),
                         Activation(nonlinearity))


class FcStack(nn.Sequential):
    """ddsp nn.FcStack: ``layers`` stacked Fc blocks."""

    def __init__(self, ch: int, in_features: int, layers: int = 2,
                 nonlinearity='leaky_relu'):
        blocks = []
        d = in_features
        for _ in range(layers):
            blocks.append(Fc(ch, d, nonlinearity))
            d = ch
        super().__init__(*blocks)


def split_to_dict(tensor: torch.Tensor,
                  tensor_splits: Sequence[Tuple[str, int]]) -> dict:
    """Split the last axis into named chunks (ddsp nn.split_to_dict)."""
    labels = [v[0] for v in tensor_splits]
    sizes = [v[1] for v in tensor_splits]
    return dict(zip(labels, torch.split(tensor, sizes, dim=-1)))


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Keras-style init of every submodule, from one seeded CPU generator
    (the same weights whatever device the module lives on). Children go
    before their parents, so a parent may overwrite what a child drew
    (pretrained tables)."""
    generator = torch.Generator(device='cpu').manual_seed(int(seed))
    for sub in reversed(list(module.modules())):
        reset = getattr(sub, 'reset_parameters', None)
        if reset is not None:
            reset(generator)
    return module
