"""Checkpoints: the atomic-commit contract (port of ``repro.checkpoint``)."""
