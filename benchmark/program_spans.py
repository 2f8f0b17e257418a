"""The program's own spans on a traced run's clock, and the split of the
coding calls' device-idle time by the span open at each instant.

dcvc_tpu_torch.utils.profiling keeps, while torch.profiler is on, the
spans of the codecs (name, parent index, request id, start and end in
unix-epoch ns) and their counters; `records()` there returns them.  A
request is a span named "codec.*" with no parent; `codec.dpb_seed` (the
DPB's seed) belongs with the request after it, so a call of the benchmark
holds its dpb_seed requests and one other.  The calls of both kinds, in
time order, are matched with the last such groups, in time order (a
process that traced before holds older groups first).  The clock offset
is the smallest, over the calls, of (the start of the call's first
request span - the call's start), so that no request starts before its
call.  If a span then lies outside its call, or the groups are fewer
than the calls, or the program keeps no such records (a version without
them), `split` returns None, and so does every metric that reads it.

Each device-idle interval of a call (counts.gaps over the device
operations tracing.in_calls gives) is split at the spans' boundaries and
put down to the innermost span open there, or to the client where no
program span is.  The spans' categories: dispatch (stage.*, k1.launch,
k2.launch), entropy (entropy.*), host copies (copy.start, wait.copy),
codec glue (codec.*), client (no span).  Times are in microseconds.
"""

from benchmark.reference.counts import gaps
from benchmark.tracing import in_calls

KINDS = ("enc", "dec")
SEED = "codec.dpb_seed"

_memo = [None, None]


def category(name):
    if name is None:
        return "client"
    if name.startswith("stage.") or name in ("k1.launch", "k2.launch"):
        return "dispatch"
    if name.startswith("entropy."):
        return "entropy"
    if name in ("copy.start", "wait.copy"):
        return "host copies"
    if name.startswith("codec."):
        return "codec glue"
    return "other"


def program_records():
    """The program's records, or None where it keeps none."""
    try:
        from dcvc_tpu_torch.utils import profiling
        return profiling.records()
    except (ImportError, AttributeError):
        return None


def _groups(spans):
    """The request spans' indexes grouped by call: each group its
    dpb_seed requests and the request after them."""
    groups, cur = [], []
    for i, s in enumerate(spans):
        if s[1] == -1 and s[0].startswith("codec.") and s[4] is not None:
            cur.append(i)
            if s[0] != SEED:
                groups.append(cur)
                cur = []
    return groups


def _innermost(spans, a, b):
    """[(t0, t1, name)] covering [a, b], name the innermost of `spans`
    ((start, end, depth, name), nested as a thread records them) open
    there, None where none is.  At one instant ends come before starts,
    a child's end before its parent's, a parent's start before its
    child's."""
    events = []
    for s, e, depth, name in spans:
        events.append((s, 1, depth, name))
        events.append((e, 0, -depth, name))
    events.sort(key=lambda ev: ev[:3])
    out, stack, t = [], [], a
    for when, start, _, name in events:
        if when > t:
            out.append((t, when, stack[-1] if stack else None))
            t = when
        if start:
            stack.append(name)
        else:
            stack.pop()
    if t < b:
        out.append((t, b, stack[-1] if stack else None))
    return out


def _overlap(pieces, segments):
    """{name: length} of the overlap of the sorted disjoint `pieces`
    ((start, end)) with the sorted disjoint labelled `segments`."""
    out, j = {}, 0
    for s, e in pieces:
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            t0, t1, name = segments[k]
            d = min(e, t1) - max(s, t0)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out


def split(trace):
    """split_records of the program's records (once a trace)."""
    if _memo[0] is not trace:
        _memo[:] = [trace, split_records(trace, program_records())]
    return _memo[1]


def split_records(trace, rec):
    """The records' spans on the trace's clock and the calls' idle split,
    or None (above).  Returns {"offset_ns", "offset_spread_us", "spans":
    {kind: [(start, end, depth, name)]}, "idle": {kind: {span name or
    None: us}}, "by_category": {kind: {category: us}}, "counters"}."""
    if not rec or not rec.get("spans"):
        return None
    spans = rec["spans"]
    calls = sorted((a, b, kind) for kind in KINDS
                   for a, b in trace.calls[kind])
    groups = _groups(spans)
    if not calls or len(groups) < len(calls):
        return None
    first = groups[len(groups) - len(calls)][0]
    groups = groups[len(groups) - len(calls):]
    firsts = [spans[g[0]][3] - round(1e3 * a)
              for (a, _, _), g in zip(calls, groups)]
    offset = min(firsts)
    depth = {}
    for i, s in enumerate(spans):
        depth[i] = depth[s[1]] + 1 if s[1] >= 0 else 0
    call_of = {spans[i][2]: c for c, g in enumerate(groups) for i in g}
    per_call = [[] for _ in calls]
    for i in range(first, len(spans)):
        name, _, request, s_ns, e_ns = spans[i]
        if e_ns is None:
            continue
        s, e = (s_ns - offset) / 1e3, (e_ns - offset) / 1e3
        inside = [c for c, (a, b, _) in enumerate(calls) if a <= s and e <= b]
        if request in call_of:
            inside = [c for c in inside if c == call_of[request]]
        if not inside:
            return None                # a span outside its call
        per_call[inside[0]].append((s, e, depth[i], name))
    out = {"offset_ns": offset,
           "offset_spread_us": (max(firsts) - offset) / 1e3,
           "spans": {k: [] for k in KINDS},
           "idle": {k: {} for k in KINDS},
           "by_category": {k: {} for k in KINDS},
           "counters": dict(rec.get("counters", {}))}
    for kind in KINDS:
        busy = [(s, e) for _, s, e in in_calls(trace, kind)]
        for (a, b, k), sp in zip(calls, per_call):
            if k != kind:
                continue
            out["spans"][kind].extend(sp)
            idle = _overlap(gaps(busy, a, b), _innermost(sp, a, b))
            for name, us in idle.items():
                out["idle"][kind][name] = out["idle"][kind].get(name, 0) + us
                cat = category(name)
                out["by_category"][kind][cat] = \
                    out["by_category"][kind].get(cat, 0) + us
    return out


def self_us(spans, name):
    """Summed self time of the spans called `name` among `spans` ((start,
    end, depth, name), one kind's): each one's duration less the union of
    the spans nested in it one level down."""
    total = 0.0
    for s, e, d, n in spans:
        if n != name:
            continue
        inner = sorted((max(s2, s), min(e2, e)) for s2, e2, d2, _ in spans
                       if d2 == d + 1 and s2 >= s and e2 <= e)
        covered, end = 0.0, s
        for s2, e2 in inner:
            if e2 > end:
                covered += e2 - max(s2, end)
                end = e2
        total += e - s - covered
    return total
