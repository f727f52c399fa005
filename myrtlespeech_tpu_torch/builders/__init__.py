"""Builders: TaskConfig -> modules and callables."""
