from .engine import Config, compose, instantiate_from_config, load_config, to_container

__all__ = ["Config", "compose", "instantiate_from_config", "load_config", "to_container"]
