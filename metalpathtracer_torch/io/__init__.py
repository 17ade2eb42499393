"""Render output: the PNG writer and progressive checkpoints."""
