"""Host ms a query inside the operator's ``pause_migrate_resume`` spans."""


def read(run):
    n = len(run.done)
    return run.span_us("pause_migrate_resume") / 1e3 / n if n and run.spans else None
