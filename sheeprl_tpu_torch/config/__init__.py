from sheeprl_tpu_torch.config.loader import ConfigError, compose, instantiate, parse_yaml

__all__ = ["ConfigError", "compose", "instantiate", "parse_yaml"]
