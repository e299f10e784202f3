"""Morsel-driven engine: columns, morsels, the plan API and its executors."""
