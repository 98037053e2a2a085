from .condition import VECTOR_COND_METHODS, prepare_condition_kwargs

__all__ = ["VECTOR_COND_METHODS", "prepare_condition_kwargs"]
