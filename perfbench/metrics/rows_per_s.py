"""Rows of every query completed in the window, over the window's seconds."""


def read(run):
    rows = sum(q.rows for q in run.done)
    return rows / run.window_s if rows and run.window_s > 0 else None
