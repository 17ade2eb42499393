"""Render output: the PNG writer and progressive checkpoints."""

from metalpathtracer_torch.io.checkpoint import load_checkpoint, save_checkpoint
from metalpathtracer_torch.io.png import linear_to_srgb, read_png, write_png

__all__ = [
    "write_png",
    "read_png",
    "linear_to_srgb",
    "save_checkpoint",
    "load_checkpoint",
]
