"""Executable examples of the port (counterparts of the root ``examples/``)."""
