"""Entry points of the port (counterpart of ``repro/launch``): the LM
serving loop of ``serve.py``."""
