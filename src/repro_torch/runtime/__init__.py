"""The training runtime: fault tolerance and elastic re-planning
(counterpart of ``repro.runtime``)."""
