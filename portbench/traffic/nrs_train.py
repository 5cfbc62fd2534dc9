"""The NRS train traffic's batch maker: the train traffic's
(``traffic/train.py``: a pool of distinct host batches of synthetic frames
with their context frames and colour jitter). Its one more parameter,
``progress``, the fraction of training done that the step runs at, is read
by the kind (``kinds/nrs_train.py``)."""

from portbench.traffic.train import make_pool

__all__ = ["make_pool"]
