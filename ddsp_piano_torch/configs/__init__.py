"""Model configurations (counterpart of ddsp_piano_tpu/configs)."""

from ddsp_piano_torch.configs.registry import (available_configs,
                                              config_rates, get_model)

__all__ = ['available_configs', 'config_rates', 'get_model']
