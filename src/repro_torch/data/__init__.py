"""Data sources for the streaming GROUP BY."""
