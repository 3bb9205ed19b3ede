"""Entry points of the port (counterpart of ``repro/launch``): the LM
serving loop of ``serve.py``, training in ``train.py``, the attachment
server of
``attach_server.py`` and the paper's Figures 2 and 3 in
``figures.py``."""
