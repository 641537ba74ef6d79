"""Architecture configurations of the port (copies of ``repro.configs``)."""

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_config, list_configs, register)

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "get_config",
           "list_configs", "register"]
