"""Observability of the port (``sagecal_tpu/obs``): so far the metrics
registry (:mod:`obs.metrics`); export, health and the sentinel come with
ROADMAP queue A item 10."""
