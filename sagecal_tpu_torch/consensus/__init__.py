"""Consensus calibration (port of ``sagecal_tpu/consensus``)."""
