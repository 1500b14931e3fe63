from repro_torch.configs.base import ModelConfig, TrainConfig, reduce_config
from repro_torch.configs.registry import get_config, get_reduced_config

__all__ = ["ModelConfig", "TrainConfig", "reduce_config", "get_config",
           "get_reduced_config"]
