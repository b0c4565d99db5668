"""swap_ms.restretch: the re-render swap (engine.engine), ms an applied
render: the window's totals of the engine's `render_swap` span (the
finished renders swapped in at a block's start: the bank's region
replaced, the clip's voices rebased) and `bank_upload` span (the bank's
device copies refreshed), over the window's applied renders (stats()'s
`renders_applied`). None where the program has no such span or counter."""


def read(run):
    n = (run.counters or {}).get("renders_applied")
    if not n:
        return None
    swap, m = run.phases.get("render_swap", (0.0, 0))
    upload, _ = run.phases.get("bank_upload", (0.0, 0))
    if not m:
        return None
    return (swap + upload) / n * 1e3
