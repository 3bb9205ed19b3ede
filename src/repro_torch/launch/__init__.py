"""Entry points of the port (counterpart of ``repro/launch``): the LM
serving loop of ``serve.py``, training in ``train.py``, the attachment
server of
``attach_server.py`` and the paper's Figures 2 and 3 in
``figures.py``; the bounds' tooling: ``roofline.py`` (the card's
peaks), ``flops.py`` (a step's matmul flops by dtype), ``mesh.py`` (a
rank's view of the production mesh, its collectives counted),
``dryrun.py`` (every arch and shape counted on the meta device) and
``perf_probe.py`` (one step profiled on the card)."""
