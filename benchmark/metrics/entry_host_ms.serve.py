"""Host milliseconds a served frame inside the program's serving entry
point: its span ``rt.render_jit`` around `render_jit` (the cache's key,
the static inputs' copy, the replay's launch, the live count's read, the
outputs' clones), summed over the traced stretch. The training entry
point's reader (`entry_host_ms.train`) and the nested spans' readers use
its helpers."""

ENTRY = {"serve": "rt.render_jit", "train": "rt.train_step"}


def spans(trace, name: str) -> list:
    """(start, end) of the host events named ``name``, by start."""
    return sorted((s, e) for n, s, e in trace.host if n == name)


def entry_ms(trace, kind: str):
    """Milliseconds a unit in the entry span of ``kind``; None in a trace
    of the other kind or one without the span."""
    got = spans(trace, ENTRY[kind]) if trace.kind == kind else []
    if not got:
        return None
    return sum(e - s for s, e in got) * 1e-3 / trace.units


def read(trace):
    return entry_ms(trace, "serve")
