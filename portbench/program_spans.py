"""The program's own spans (dipole_tpu_torch.utils.timing's ring, in this
process), read after the loop for the per-layer metrics whose source is
`program_span`. A program that keeps no ring (an older commit) reads None,
and so does a ring without the spans a metric asks for.

The window's work is picked by count, newest last: the last `ctx.calls`
`api.orient_simple` roots of a closed loop (its warm-up call comes first),
the last `ctx.calls` `serve.request` spans of an open loop (the server's
warm-up opens none)."""
from __future__ import annotations


def ring():
    """The ring's spans, oldest first, or None where the program has none."""
    from dipole_tpu_torch.utils import timing

    read = getattr(timing, "spans", None)
    return None if read is None else read()


def last(spans, name: str, count: int):
    """The last `count` spans named `name`, or None where there are none."""
    if not spans or not count:
        return None
    hits = [s for s in spans if s.name == name]
    return hits[-int(count):] or None


def _ns(s) -> int:
    return s.end_ns - s.start_ns


def serve_requests(ctx):
    """(spans, request ids) of the window's requests, or None."""
    spans = ring()
    requests = last(spans, "serve.request", getattr(ctx, "calls", 0))
    if requests is None:
        return None
    return spans, {s.request for s in requests}


def mean_per_request_ms(ctx, name: str):
    """The `name` spans' milliseconds summed a request, averaged over the
    window's requests; None where none of them has such a span."""
    found = serve_requests(ctx)
    if found is None:
        return None
    spans, ids = found
    hits = [_ns(s) for s in spans if s.name == name and s.request in ids]
    return sum(hits) / len(ids) * 1e-6 if hits else None


def mean_core_ms(ctx):
    """The mean `serve.core` span of the batches that ran the window's
    requests, in ms."""
    found = serve_requests(ctx)
    if found is None:
        return None
    spans, ids = found
    hits = [_ns(s) for s in spans if s.name == "serve.core"
            and ids.intersection(s.tags.get("requests", ()))]
    return sum(hits) / len(hits) * 1e-6 if hits else None


def api_calls(ctx):
    """(spans, roots) of the window's `api.orient_simple` calls, or None."""
    spans = ring()
    roots = last(spans, "api.orient_simple", getattr(ctx, "calls", 0))
    return None if roots is None else (spans, roots)


def seconds_per_call(ctx, name: str):
    """The `name` spans' seconds inside the window's calls, over the calls;
    None where no call has one."""
    found = api_calls(ctx)
    if found is None:
        return None
    spans, roots = found
    ids = {r.request for r in roots}
    hits = [_ns(s) for s in spans if s.name == name and s.request in ids]
    return sum(hits) / len(roots) * 1e-9 if hits else None


def self_seconds_per_call(ctx):
    """A call's root span less the union of its direct children, in seconds,
    averaged over the window's calls."""
    found = api_calls(ctx)
    if found is None:
        return None
    spans, roots = found
    children = {r.id: [] for r in roots}
    for s in spans:
        if s.parent in children:
            children[s.parent].append((s.start_ns, s.end_ns))
    total = 0
    for r in roots:
        covered, edge = 0, r.start_ns
        for a, b in sorted(children[r.id]):
            a, b = max(a, edge), min(b, r.end_ns)
            if b > a:
                covered += b - a
                edge = b
        total += _ns(r) - covered
    return total / len(roots) * 1e-9
