"""Table grows a query: ``migrations`` + ``bound_grows`` of the executor's
event counters at finalize; 0 where the route keeps no such counter."""


def read(run):
    stats = [q.stats for q in run.done if q.stats is not None]
    if not stats:
        return None
    total = sum(s["device"].get("migrations", 0) + s["device"].get("bound_grows", 0)
                for s in stats)
    return total / len(stats)
