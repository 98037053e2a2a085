from .synthetic import SyntheticImages, collate

__all__ = ["SyntheticImages", "collate"]
