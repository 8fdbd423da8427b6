"""One call of the window under torch.profiler, reduced in memory to what
the per-layer metrics and the result's breakdown read: device time by
kernel name, the union of the device's busy intervals over the call's
span on the device, and its idle gaps, each named by what the host was
doing during it (a CUDA runtime call such as a graph launch or a sync,
or the profiler's own buffer work). Nothing is written to disk."""

import torch

WINDOW = 'lmcbench.profiled_call'


def _span_ns(e):
    """(start, end) of a profiler event in ns (torch versions differ in
    which accessors the events have)."""
    if hasattr(e, 'start_ns'):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


def _is_annotation(e):
    f = getattr(e, 'is_user_annotation', None)
    return e.name() == WINDOW or (f is not None and f())


def profiled(fn, device):
    """Run fn() under torch.profiler, ending in a device sync. Returns
    (fn's result, a function that reduces the profile to a Trace: call it
    once the window has closed). It records the device's activity alone
    (kernels, copies, and the CUDA runtime calls that launch them):
    recording the host's operators as well stretched a traced call's
    span on the device further (on the box cells 41-85% over an untraced
    call, against 16-22%)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize(device)
    return out, lambda: Trace.from_events(
        prof.profiler.kineto_results.events())


def _union(intervals):
    """Merged [start, end) intervals of a list of (start, end)."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class Trace:
    """kernels: {name: device seconds}; window_s: the profiled call's span
    on the device, from its first device operation's start to its last
    one's end; busy_s: the union of the device operations' intervals in
    it; gaps: [(host activity, seconds)] of the device's idle intervals
    inside the window, longest first. All read from the one trace."""

    def __init__(self, kernels, busy_s, window_s, gaps):
        self.kernels, self.busy_s, self.window_s = kernels, busy_s, window_s
        self.gaps = gaps

    @classmethod
    def from_events(cls, events):
        from torch.autograd import DeviceType
        dev, host = [], []
        kernels = {}
        for e in events:
            on_device = e.device_type() == DeviceType.CUDA
            if on_device and _is_annotation(e):
                continue        # an annotation mirrored on the device
            s, end = _span_ns(e)
            name = e.name()
            if on_device:
                dev.append((s, end))
                kernels[name] = kernels.get(name, 0.0) + (end - s) * 1e-9
            elif name != WINDOW:
                host.append((s, end, name))
        if not dev:
            raise RuntimeError('the profiled call left no device operation '
                               'in its trace')
        busy = _union(dev)
        w0, w1 = busy[0][0], busy[-1][1]
        busy_ns = sum(e - s for s, e in busy)
        idle = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        idle.sort(key=lambda g: g[0] - g[1])
        gaps = [(_host_during(host, s, e), (e - s) * 1e-9)
                for s, e in idle[:10]]
        return cls(kernels, busy_ns * 1e-9, (w1 - w0) * 1e-9, gaps)

    def kernel_seconds(self, *names):
        """Device seconds of the kernels whose name contains any of
        `names` (a kernel's name is its demangled signature)."""
        return sum(t for k, t in self.kernels.items()
                   if any(n in k for n in names))

    def breakdown(self):
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[k, t] for k, t in top],
                    idle_gaps=[[k, t] for k, t in self.gaps])


def _host_during(host, s, e):
    """The host activity that covers the middle of [s, e) and started
    last (the innermost), else the one that ended last before it."""
    mid = (s + e) // 2
    cover = [h for h in host if h[0] <= mid < h[1]]
    if cover:
        return max(cover, key=lambda h: h[0])[2]
    before = [h for h in host if h[1] <= mid]
    if before:
        return 'after ' + max(before, key=lambda h: h[1])[2]
    return 'host: no traced activity'
