from .checkpointer import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
