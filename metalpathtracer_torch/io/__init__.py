"""Render output: the PNG writer."""
