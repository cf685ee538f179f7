from .checkpointer import Checkpointer
from .journal import Journal

__all__ = ["Checkpointer", "Journal"]
