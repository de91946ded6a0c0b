from .pipeline import DataConfig, DataState, SyntheticLM

__all__ = ["DataConfig", "DataState", "SyntheticLM"]
