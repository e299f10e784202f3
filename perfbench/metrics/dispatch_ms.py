"""Host ms a query in ``StreamHandle._dispatch``'s ``consume_async`` spans:
staging each chunk, the resolver's sample read, the launches."""


def read(run):
    n = len(run.done)
    return run.span_us("consume_async") / 1e3 / n if n and run.spans else None
