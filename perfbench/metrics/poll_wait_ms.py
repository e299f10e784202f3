"""Host ms a query waiting on the device: the ``poll`` spans outside
``finalize`` and the ``finalize`` spans (which drain the last polls)."""


def read(run):
    n = len(run.done)
    if not n or not run.spans:
        return None
    return (run.span_us("poll", outside=("finalize",)) + run.span_us("finalize")) / 1e3 / n
