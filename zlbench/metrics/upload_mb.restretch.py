"""upload_mb.restretch: the bank's refresh (engine.engine), MB copied to
the device an applied render: the window's `bank_upload_bytes` over its
`renders_applied` (engine.stats()). A render that reuses or appends a
region moves that region; a whole-capacity upload moves the capacity.
None where the program has no such counters."""


def read(run):
    c = run.counters or {}
    n = c.get("renders_applied")
    if not n or "bank_upload_bytes" not in c:
        return None
    return c["bank_upload_bytes"] / n / 1e6
