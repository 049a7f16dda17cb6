"""Runnable examples of the port, the twins of the repository's ``examples/``."""
