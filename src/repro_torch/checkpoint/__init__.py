from . import checkpointer
from .checkpointer import latest_step, restore, save, save_async, wait_for_saves

__all__ = ["checkpointer", "latest_step", "restore", "save", "save_async", "wait_for_saves"]
