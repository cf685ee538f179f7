from .pipeline import DataConfig, DataState, init_state, make_batch

__all__ = ["DataConfig", "DataState", "init_state", "make_batch"]
