"""Parallel execution across ranks: the strategies' rule tables
(``strategies``), sharded activations (``sharded``), the collectives that
autograd differentiates (``collectives``) and the halo-exchange conv
(``halo``)."""
