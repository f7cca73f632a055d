"""Mean milliseconds from a request's due time to the dispatch of its
batch (the harness's stamps)."""


def read(run):
    q = run["window"]["queue_s"]
    return 1e3 * sum(q) / len(q) if q else None
