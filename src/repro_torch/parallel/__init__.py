"""Parallel execution across ranks: the strategies' rule tables
(``strategies``), sharded activations (``sharded``), the collectives that
autograd differentiates (``collectives``), the halo-exchange conv
(``halo``) and the pipeline schedules (``schedules``)."""
