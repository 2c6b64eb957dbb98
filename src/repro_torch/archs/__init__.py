"""Arch-level entry points of the port (port of ``repro.archs``): the
recsys serve shapes so far."""
