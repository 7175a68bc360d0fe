"""The reduction of a ``torch.profiler`` trace (CPU and CUDA activity) of
the window to what the per-layer metrics and ``breakdown`` read: device
busy time (the union of every operation on the card), time by kernel
name, the longest device operations and idle gaps. A gap is labelled by
the innermost host span open at its middle: the benchmark's own
(``bench:sample:<name>``) or one the program records on the thread that
runs the sample (``<sample>:<stage>``)."""

WINDOW = 'bench:window'
TOP = 10


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof):
    """{busy_s, window_s, kernels {name: seconds}, breakdown} of a profiler
    whose trace holds a ``WINDOW`` span, or None without one."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans, device = [], []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((start, end, e.name()))
        elif e.is_user_annotation():
            spans.append((start, end, e.name()))
    window = [(s, e) for s, e, name in spans if name == WINDOW]
    if not window:
        return None
    w0, w1 = window[0]
    inside = [(max(s, w0), min(e, w1), name) for s, e, name in device if e > w0 and s < w1]
    merged = _union([(s, e) for s, e, _ in inside])
    busy = sum(e - s for s, e in merged)
    kernels = {}
    for s, e, name in inside:
        kernels[name] = kernels.get(name, 0) + (e - s)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    label = [_label(spans, (s + e) // 2) for s, e in gaps[:TOP]]
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        'busy_s': busy / 1e9,
        'window_s': (w1 - w0) / 1e9,
        'kernels': {name: ns / 1e9 for name, ns in kernels.items()},
        'breakdown': {
            'device_ops': [[name[:120], ns / 1e9] for name, ns in top_ops],
            'idle_gaps': [[name, (e - s) / 1e9] for name, (s, e) in zip(label, gaps[:TOP])],
        },
    }


def _label(spans, t):
    """The name of the shortest span other than the window open at t."""
    best = None
    for s, e, name in spans:
        if s <= t < e and name != WINDOW and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else 'outside every span'
