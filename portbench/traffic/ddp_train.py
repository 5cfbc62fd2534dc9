"""The data-parallel train traffic's batch maker: the train traffic's
(``traffic/train.py``), asked by each rank for the global batch, ``batch``
x ``ranks`` rows, of which the kind keeps the rank's own (``kinds/
ddp_train.py``). Parameters: the train traffic's, ``batch`` being a rank's,
and ``ranks``."""

from portbench.traffic.train import make_pool

__all__ = ["make_pool"]
