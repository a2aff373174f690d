"""How far the port's spans cover its work, read from its span ring
(dipole_tpu_torch/utils/timing.py).

Served requests: a request's uncovered time is its `serve.request` span less
the union of its direct children and the `serve.core` spans of the batches
that list it (a follower waits out its batch's core on the leader's thread).
The report gives the share of requests uncovered by at most `--limit-ms`,
and every gap between adjacent covering spans, keyed by the spans on either
side ("serve.estimate -> serve.queue"), over all requests and over those
above the limit, with its count, sum and quantiles, and how much of it
another request's host kNN (`estimate.knn`, on all the host's cores) ran
(`under_knn_ms`; `knn_share` is the share of the whole run with one
running).

Batch calls: each `api.orient_simple` root against its stage spans, the
`estimate.knn` and `estimate.pca` spans against their stage, and the root's
self time (the root less its direct children).

    python tools/span_closure.py read SPANS.json [--limit-ms 2] [--skip 1]
    python tools/span_closure.py run --dump SPANS.json [--switch-interval S] \\
        -- --workload simple10k.serve --seed 7 --seconds 51 --trace 1

`run` runs one cell of the benchmark (portbench/run.py's arguments) in this
process, prints its result line, writes the ring to `--dump` and reports on
it. `--switch-interval` sets the interpreter's thread switch interval for
the run (sys.setswitchinterval; 0.005 s by default): waits for the
interpreter lock move with it. `read` reports on a dump: a JSON list of
[id, name, start_ns, end_ns, thread, parent, request, tags], one a span,
oldest first.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

FIELDS = ("id", "name", "start_ns", "end_ns", "thread", "parent", "request",
          "tags")
BATCH_STAGES = ("estimate unoriented normals", "dipole propagation",
                "global sign fix")


def load(path) -> list:
    with open(path) as f:
        return [SimpleNamespace(**dict(zip(FIELDS, row))) for row in json.load(f)]


def dump(spans, path) -> None:
    with open(path, "w") as f:
        json.dump([[getattr(s, k) for k in FIELDS] for s in spans], f)


def _quantiles(ms: list) -> dict:
    ms = sorted(ms)
    at = lambda q: ms[min(len(ms) - 1, int(q * (len(ms) - 1) + 0.5))]  # noqa: E731
    return {"n": len(ms), "sum_ms": sum(ms), "p50_ms": at(0.5),
            "p90_ms": at(0.9), "p99_ms": at(0.99), "max_ms": ms[-1]}


def _gaps(lo: int, hi: int, covering: list) -> list:
    """The stretches of [lo, hi] that no (start, end, name) covers, each as
    (the name before it, the name after it, its start, its end); "start"
    and "end" stand for the edges."""
    out, edge, before = [], lo, "start"
    for a, b, name in sorted(covering):
        if a > edge:
            out.append((before, name, edge, min(a, hi)))
        if b > edge:
            edge, before = b, name
        if edge >= hi:
            break
    if hi > edge:
        out.append((before, "end", edge, hi))
    return out


def _union(intervals: list, lo: int, hi: int) -> int:
    """ns of [lo, hi] under the union of sorted (start, end) intervals."""
    covered, edge = 0, lo
    for a, b in intervals:
        a, b = max(a, edge), min(b, hi)
        if b > a:
            covered, edge = covered + b - a, b
    return covered


def serve_closure(spans, limit_ms: float = 2.0) -> dict | None:
    """The coverage of every served request in `spans` (see the module
    docstring); None where there is none."""
    requests = [s for s in spans if s.name == "serve.request"]
    if not requests:
        return None
    cores = [s for s in spans if s.name == "serve.core"]
    listed = [r for c in cores for r in c.tags.get("requests", ())]
    core_of = {}
    for c in cores:
        for rid in c.tags.get("requests", ()):
            core_of.setdefault(rid, []).append(c)
    children = {r.id: [] for r in requests}
    for s in spans:
        if s.parent in children and s.name != "serve.core":
            children[s.parent].append((s.start_ns, s.end_ns, s.name))
    for c in cores:                   # on the leader's thread, under its request
        if c.parent in children:
            own = c.request in c.tags.get("requests", ())
            children[c.parent].append((c.start_ns, c.end_ns, "serve.core" if own
                                       else "serve.core (a later chunk)"))
    knn = sorted((s.start_ns, s.end_ns, s.thread) for s in spans
                 if s.name == "estimate.knn" and s.request is not None)
    uncovered, every, over = [], {}, {}
    for r in requests:
        covering = list(children[r.id])
        covering += [(c.start_ns, c.end_ns, "serve.core (its leader's)")
                     for c in core_of.get(r.request, ()) if c.parent != r.id]
        gaps = _gaps(r.start_ns, r.end_ns, covering)
        ms = sum(b - a for _, _, a, b in gaps) * 1e-6
        uncovered.append(ms)
        for before, after, a, b in gaps:
            others = [(x, y) for x, y, t in knn if t != r.thread and x < b and y > a]
            gap = ((b - a) * 1e-6, _union(others, a, b) * 1e-6)
            every.setdefault(f"{before} -> {after}", []).append(gap)
            if ms > limit_ms:
                over.setdefault(f"{before} -> {after}", []).append(gap)

    def by_sum(table):
        out = {}
        for key, gaps in sorted(table.items(), key=lambda kv: -sum(g for g, _ in kv[1])):
            out[key] = _quantiles([g for g, _ in gaps])
            out[key]["under_knn_ms"] = sum(k for _, k in gaps)
        return out

    ids = [r.request for r in requests]
    lo, hi = min(r.start_ns for r in requests), max(r.end_ns for r in requests)
    return {"requests": len(requests),
            "ids_each_in_one_core": sorted(listed) == sorted(ids),
            "limit_ms": limit_ms,
            "within_limit": sum(u <= limit_ms for u in uncovered) / len(uncovered),
            "knn_share": _union([(x, y) for x, y, _ in knn], lo, hi) / (hi - lo),
            "uncovered": _quantiles(uncovered),
            "gaps": by_sum(every),
            "gaps_of_requests_over_the_limit": by_sum(over)}


def batch_closure(spans, skip: int = 0) -> dict | None:
    """Per call (mean over the `api.orient_simple` roots after the first
    `skip`), in seconds: the root, each stage span, `estimate.knn` and
    `estimate.pca`, `transform` and `transform.inverse`, the root's self
    time; and the shares the stages cover. None where there is no root."""
    roots = [s for s in spans if s.name == "api.orient_simple"][skip:]
    if not roots:
        return None
    ids = {r.request for r in roots}
    per = {}
    for s in spans:
        if s.request in ids:
            per[s.name] = per.get(s.name, 0) + (s.end_ns - s.start_ns)
    kids = {r.id: [] for r in roots}
    for s in spans:
        if s.parent in kids:
            kids[s.parent].append((s.start_ns, s.end_ns, s.name))
    self_ns = sum(sum(b - a for _, _, a, b in _gaps(r.start_ns, r.end_ns, kids[r.id]))
                  for r in roots)
    mean = {k: v / len(roots) * 1e-9 for k, v in per.items()}
    mean["self"] = self_ns / len(roots) * 1e-9
    root = mean["api.orient_simple"]
    stages = sum(mean.get(k, 0.0) for k in BATCH_STAGES)
    estimate = mean.get(BATCH_STAGES[0])
    out = {"calls": len(roots), "seconds_per_call": mean,
           "stages_and_self_of_root": (stages + mean["self"]) / root,
           "stages_transforms_and_self_of_root":
               (stages + mean.get("transform", 0.0)
                + mean.get("transform.inverse", 0.0) + mean["self"]) / root}
    if estimate:
        out["knn_and_pca_of_estimate"] = (mean.get("estimate.knn", 0.0)
                                          + mean.get("estimate.pca", 0.0)) / estimate
    return out


def report(spans, limit_ms: float = 2.0, skip: int = 0) -> dict:
    return {"serve": serve_closure(spans, limit_ms),
            "batch": batch_closure(spans, skip)}


def _run(argv, dump_path, switch_interval):
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    t0 = time.perf_counter()
    from portbench import run

    if switch_interval is not None:
        sys.setswitchinterval(switch_interval)
    line, lines = run.execute(run.parse(argv), t0=t0)
    for text in lines:
        print(text, file=sys.stderr)
    print(line, flush=True)
    from dipole_tpu_torch.utils import timing

    spans = timing.spans()
    if dump_path:
        dump(spans, dump_path)
    return spans


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    passed = []
    if "--" in argv:
        at = argv.index("--")
        argv, passed = argv[:at], argv[at + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("read", "run"))
    p.add_argument("spans", nargs="?", help="a dump, for `read`")
    p.add_argument("--dump", help="where `run` writes the ring")
    p.add_argument("--switch-interval", type=float, default=None)
    p.add_argument("--limit-ms", type=float, default=2.0)
    p.add_argument("--skip", type=int, default=None,
                   help="roots to leave out first (default: 0 for `read`, "
                        "1 for `run`, the cell's warm-up call)")
    args = p.parse_args(argv)
    if args.mode == "read":
        if not args.spans:
            p.error("`read` takes a dump")
        spans, skip = load(args.spans), args.skip or 0
    else:
        spans = _run(passed, args.dump, args.switch_interval)
        skip = 1 if args.skip is None else args.skip
    print(json.dumps(report(spans, args.limit_ms, skip), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
