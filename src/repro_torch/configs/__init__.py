"""Architecture configurations of the port (copies of ``repro.configs``)."""

from repro_torch.configs.base import ArchConfig, get_config, list_configs, register

__all__ = ["ArchConfig", "get_config", "list_configs", "register"]
