"""The port's trace registry: kernel launch counters, stage spans on the
device that survive CUDA-graph capture, host spans on the profiler's
clock and live-ray counters, read together by snapshot().

Launch counters are always on. Everything else costs one Python `if` per
span while tracing is off (the default): enable() turns it on, and a
StepGraphs decides at its capture whether its graphs carry the stamps.

* Stage spans, span(name): entering a span stamps the device once and
  leaving it stamps again. A stamp is a one-thread kernel (csrc/stamp.cu)
  that reads %globaltimer, adds the time since the previous stamp to the
  int64 slots of the stage whose interval just ended, and counts it: on
  entry the enclosing stage (the parent), on exit the span's own. So the
  slots hold self times. A stamp is an ordinary launch, so a captured
  step holds it as a graph node and every replay adds into the same
  slots with no host read. A stage is the path of span names open on the
  host when its stamps were launched ('mlt.small/chain.replay'), so a
  query's time stays apart under each caller, and inclusive times are
  sums over a path's descendants. Device time inside no span is charged
  to 'other'; each graph of a StepGraphs begins with a stamp that charges
  'graphs.gap' (the device time since the previous graph: host launches,
  flag reads, the caller's syncs); an eager call between two graphs is
  stamped on each side, so its own device time is charged to the stage
  open where it was captured. Self times summed over every stage equal
  the device time from the first stamp to the last.
  On the CPU the same accounting runs on the host clock.
* Host spans: every span, and the host-only spans of ops.graphs and the
  multi-step (host_open / host_close), recorded in a ring of the newest
  RING_SIZE: name, start, end, parent, the multi-step call it belongs to
  and an argument (the graph's index for graphs.launch). Their clock is
  time.perf_counter_ns() plus one offset read at enable(): the Unix-epoch
  nanoseconds that torch.profiler's events carry, so a trace of the
  device and the program's spans line up.
* Ray counters: with tracing on, make_intersect_fns wraps every query
  (count_rays): the rays submitted (a host count that StepGraphs adds at
  every replay, like a launch) and the live ones, max_t >= min_t, summed
  into an int64 tensor on the device.
* Lane counters: a module registers a named counter at its import
  (lane_counter); with tracing on, count_lanes adds the lanes set in a
  bool tensor to the counter's side ('cur' or 'prop': a small step's
  current state or its proposal) on the device. mcmc/chain.py counts
  MALA's lanes that needed a kNN query (knn_need, beside the host count
  of each query's lane budget, knn_budget) and H2MC's lanes whose
  Gaussian came from a Hessian (h2mc_lanes), those of them that fell back
  to the isotropic Gaussian (h2mc_fallback) and those whose gradient or
  Hessian was zeroed as not finite (hess_nonfinite); path/replay.py
  counts, by side, the double-backward passes each Hessian ran while
  tracing (hess_passes, a launch counter: one a row group).

The registry traces one device (enable's): spans stamp its current
stream."""

import contextlib
import ctypes
import itertools
import json
import time
import weakref

import numpy as np
import torch

RING_SIZE = 1 << 16       # host spans the ring keeps
MAX_STAGES = 1024         # device stage slots
GAP = 'graphs.gap'
OTHER = 'other'

# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

_counters = []    # every launch_counter dict
_owners = []      # the module that made each


def launch_counter(keys, owner):
    """A dict of launch counts, each key at 0, that StepGraphs keeps
    counting kernel executions under replay. A kernel wrapper adds one to
    its key where it launches its kernel, and nowhere else. owner: the
    name snapshot() files the counts under (the wrapper's module)."""
    counts = dict.fromkeys(keys, 0)
    _counters.append(counts)
    _owners.append(owner)
    return counts


def launch_snapshot():
    """A copy of every launch counter, in registration order."""
    return [dict(c) for c in _counters]


def add_launches(delta, sign=1):
    """Add sign * delta (a launch_snapshot's shape) to the counters."""
    for counts, d in zip(_counters, delta):
        for k, v in d.items():
            counts[k] += sign * v


def launches_since(before):
    """The counts launched since the launch_snapshot `before`."""
    return [{k: c[k] - b.get(k, 0) for k in c}
            for c, b in zip(_counters, before)]


def reset_launches():
    """Zero every launch counter, the ray counts included."""
    for counts in _counters:
        for k in counts:
            counts[k] = 0


# rays submitted to the queries while tracing (count_rays)
ray_counts = launch_counter(('closest', 'any'), 'rays')

# ---------------------------------------------------------------------------
# lane counters
# ---------------------------------------------------------------------------

# the sides of a small step: the current state and the proposal
SIDES = ('cur', 'prop')
MAX_LANE_COUNTERS = 16
_lane_names = []    # every lane_counter, in the order of its device row


def lane_counter(name):
    """Register the device lane counter `name` (count_lanes), reported by
    snapshot() under 'lanes' as {side: lanes}. The module that counts
    makes it at its import; registering a name again is a no-op."""
    if name not in _lane_names:
        if len(_lane_names) == MAX_LANE_COUNTERS:
            raise ValueError(f'more than {MAX_LANE_COUNTERS} lane counters')
        _lane_names.append(name)
    return name

# ---------------------------------------------------------------------------
# the registry's state
# ---------------------------------------------------------------------------

_on = False
_st = None          # the _State of the traced device
_states = {}        # every device traced in this process: its _State
_graphs = {}        # every StepGraphs, by the number it was registered as
_serials = itertools.count()
_offset = 0         # the host spans' clock less time.perf_counter_ns()
_NULL_SPAN = contextlib.nullcontext()


class _State:
    """The slots, counters and ring of one traced device."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == 'cuda'
        # [0] the last stamp's time; stage i: [1 + 2i] its self ns, [2 + 2i]
        # the intervals charged to it (on the CPU a host array)
        n = 1 + 2 * MAX_STAGES
        self.slots = torch.zeros(n, dtype=torch.int64, device=device) \
            if self.cuda else np.zeros(n, np.int64)
        self.live = torch.zeros(2, dtype=torch.int64, device=device)
        self.lanes = torch.zeros((MAX_LANE_COUNTERS, len(SIDES)),
                                 dtype=torch.int64, device=device)
        self.lib = None
        if self.cuda:
            from . import cuda_build
            self.lib = cuda_build.load_library()
        self.stage_ids = {}           # stage path -> slot index
        self.stage_paths = []
        self.stage_stack = []         # the open stages' slot indices
        self.host_stack = []          # the open host spans' ids
        self.call = 0                 # multi-step calls so far
        self.next_id = 0              # host span ids handed out
        self.closed = 0               # host spans recorded
        self.r_name = np.empty(RING_SIZE, object)
        self.r_id = np.zeros(RING_SIZE, np.int64)
        self.r_parent = np.zeros(RING_SIZE, np.int64)
        self.r_call = np.zeros(RING_SIZE, np.int64)
        self.r_arg = np.zeros(RING_SIZE, np.int64)
        self.r_t0 = np.zeros(RING_SIZE, np.int64)
        self.r_t1 = np.zeros(RING_SIZE, np.int64)
        self.stage(OTHER)
        self.stage(GAP)

    def stage(self, path):
        i = self.stage_ids.get(path)
        if i is None:
            i = len(self.stage_paths)
            if i >= MAX_STAGES:
                raise RuntimeError(f'tracing: more than {MAX_STAGES} '
                                   f'stages')
            self.stage_ids[path] = i
            self.stage_paths.append(path)
        return i

    def stamp(self, i):
        """Charge the interval since the previous stamp to stage i."""
        if self.cuda:
            err = self.lib.stamp(
                ctypes.c_void_p(self.slots.data_ptr()), i,
                ctypes.c_void_p(
                    torch.cuda.current_stream(self.device).cuda_stream))
            if err:
                raise RuntimeError(f'stamp launch failed: CUDA error {err}')
        else:
            s = self.slots
            now = time.perf_counter_ns()
            if s[0]:
                s[1 + 2 * i] += now - s[0]
                s[2 + 2 * i] += 1
            s[0] = now


def enable(device=None):
    """Turn tracing on for `device` (default: the current CUDA device where
    there is one, else the CPU). Spans record from here on; a step
    captured from here on carries the stamps. Slots and counters go on
    from where an earlier enable() of the same device left them. A first
    stamp starts the device's clock here (the interval up to the next one
    is charged to 'other')."""
    global _on, _st, _offset
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    device = _indexed(device)
    if device not in _states:
        _states[device] = _State(device)
    _st = _states[device]
    _offset = time.time_ns() - time.perf_counter_ns()
    _on = True
    _st.stamp(0)


def disable():
    """Turn tracing off. Graphs captured with it on go on stamping; their
    slots stay readable by snapshot()."""
    global _on
    _on = False


def enabled():
    return _on


def traces(device):
    """Whether a step captured now on `device` carries the stamps."""
    return _on and _st.cuda and _indexed(device) == _st.device


def _indexed(device):
    """torch.device(device), a CUDA device without an index as the
    current one."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def now_ns():
    """The host spans' clock: torch.profiler's (Unix-epoch ns)."""
    return time.perf_counter_ns() + _offset


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _Span:
    """A span while tracing is on (span, timed); stage=False: a host span
    alone."""
    __slots__ = ('name', 'arg', 'stage', 'sp', 't0', 't1')

    def __init__(self, name, arg=-1, stage=True):
        self.name, self.arg, self.stage = name, arg, stage

    def __enter__(self):
        st = _st
        if self.stage:
            stack = st.stage_stack
            parent = stack[-1] if stack else 0
            st.stamp(parent)
            path = self.name if not stack else \
                f'{st.stage_paths[stack[-1]]}/{self.name}'
            stack.append(st.stage(path))
        self.sp = host_open(self.name, self.arg)
        self.t0 = self.sp[3]
        return self

    def __exit__(self, *exc):
        st = _st
        self.t1 = host_close(self.sp)
        if self.stage:
            st.stamp(st.stage_stack.pop())
        return False


def span(name):
    """A stage span (see the module's docstring); a no-op while tracing is
    off."""
    return _Span(name) if _on else _NULL_SPAN


def host_span(name, arg=-1):
    """A host span (no stamp); a no-op while tracing is off."""
    return _Span(name, arg, stage=False) if _on else _NULL_SPAN


def host_open(name, arg=-1):
    """Open a host span (the ring's record only, no stamp). Returns its
    handle, which host_close takes."""
    st = _st
    i = st.next_id
    st.next_id += 1
    st.host_stack.append(i)
    return i, name, arg, now_ns()


def host_close(sp):
    """Close and record host span sp (host_open's). Returns its end."""
    t1 = now_ns()
    i, name, arg, t0 = sp
    st = _st
    st.host_stack.pop()
    k = st.closed % RING_SIZE
    st.closed += 1
    st.r_name[k] = name
    st.r_id[k] = i
    st.r_parent[k] = st.host_stack[-1] if st.host_stack else -1
    st.r_call[k] = st.call
    st.r_arg[k] = arg
    st.r_t0[k] = t0
    st.r_t1[k] = t1
    return t1


def call_span():
    """The host span 'mlt.call' of one multi-step call, numbered: the
    spans inside it carry its number."""
    if not _on:
        return _NULL_SPAN
    _st.call += 1
    return _Span('mlt.call', _st.call, stage=False)


def stamp_gap():
    """The stamp that begins a graph: charges 'graphs.gap'."""
    _st.stamp(1)


def open_stage():
    """The slot of the innermost open stage ('other' where none is)."""
    stack = _st.stage_stack
    return stack[-1] if stack else 0


def stamp_open():
    """The stamp that ends a graph: charges the innermost open stage."""
    _st.stamp(open_stage())


def stamp_stage(i):
    """A stamp that charges stage slot i (open_stage's)."""
    _st.stamp(i)


def timed(fn, device, name=None, stage=False):
    """fn() between two syncs of `device`: (fn's result, host seconds).
    With tracing on and a name, the interval is the span `name` (a stage
    span when stage, else a host span), and the seconds are its own clock
    readings."""
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.synchronize(device)
    if _on and name is not None:
        with _Span(name, stage=stage) as sp:
            out = fn()
            if cuda:
                torch.cuda.synchronize(device)
        return out, (sp.t1 - sp.t0) * 1e-9
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# ray counters
# ---------------------------------------------------------------------------

def traced_query(kind, fn):
    """fn, a ray query (org, d, time, min_t, max_t) of kind 'closest' or
    'any', inside the span isect.<kind>, counting its rays (count_rays)."""
    name = f'isect.{kind}'

    def query(org, d, time, min_t, max_t):
        with span(name):
            count_rays(kind, min_t, max_t)
            return fn(org, d, time, min_t, max_t)
    return query


def count_rays(kind, min_t, max_t):
    """Add a query's rays (min_t, max_t [R]) to the ray counters: R to the
    submitted, and the live ones (max_t >= min_t) on the device."""
    if not _on or max_t.device != _st.device:
        return
    ray_counts[kind] += max_t.shape[0]
    _st.live[0 if kind == 'closest' else 1].add_((max_t >= min_t).sum())


def count_lanes(name, side, lanes):
    """Add the lanes set in `lanes` ([n] bool) to lane counter `name`'s
    `side` ('cur' or 'prop') on the device. Returns whether it counted:
    only while tracing, and only lanes on the traced device."""
    if not _on or lanes.device != _st.device:
        return False
    _st.lanes[_lane_names.index(name), SIDES.index(side)].add_(lanes.sum())
    return True


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

def register_graphs(g):
    """Keep StepGraphs g in the registry (snapshot's 'graphs'), as long as
    it lives."""
    _graphs[next(_serials)] = weakref.ref(g)
    for k in [k for k, r in _graphs.items() if r() is None]:
        del _graphs[k]


def graph_record(g):
    """A StepGraphs' numbers as snapshot() reports them: eager_calls are
    a step's calls between graphs, eager_fns the functions they run."""
    return dict(traced=g.traced, graphs=len(g.graphs),
                eager_calls=len(g.calls),
                eager_fns=sorted({f'{fn.__module__}.{fn.__qualname__}'
                                  for fn, _, _ in g.calls}),
                branches=len(g.branches),
                nodes=sum(g.nodes), capture_s=g.capture_s,
                instantiate_s=g.instantiate_s, branch_runs=g.branch_runs,
                branch_skips=g.branch_skips)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def snapshot():
    """Everything the registry holds, in one dict: 'enabled'; 'launches'
    ({owner: {key: executions}}, the rays submitted under 'rays'); 'graphs' ({number: graph_record} of
    every live StepGraphs, in the order they were made); and, once
    tracing was enabled: 'device', 'clock_ns' (the last stamp's time),
    'stages' ({stage path: [self ns, intervals]}), 'live' ({'closest',
    'any'}: live rays), 'lanes' ({lane counter: {'cur', 'prop'}}),
    'calls' (multi-step calls) and 'host_spans' (host spans recorded).
    The device's slots are read with one copy, after a sync of the
    device."""
    out = dict(enabled=_on,
               launches={o: dict(c) for o, c in zip(_owners, _counters)},
               graphs={k: graph_record(r()) for k, r in _graphs.items()
                       if r() is not None})
    st = _st
    if st is None:
        return out
    if st.cuda:
        torch.cuda.synchronize(st.device)
    slots = st.slots.cpu() if st.cuda else st.slots
    live = st.live.cpu().tolist()
    lanes = st.lanes.cpu().tolist()
    v = slots.tolist()
    out.update(device=str(st.device), clock_ns=v[0],
               stages={p: [v[1 + 2 * i], v[2 + 2 * i]]
                       for i, p in enumerate(st.stage_paths)},
               live=dict(closest=live[0], any=live[1]),
               lanes={n: dict(zip(SIDES, lanes[i]))
                      for i, n in enumerate(_lane_names)},
               calls=st.call, host_spans=st.closed)
    return out


def delta(a, b):
    """What happened between snapshots a and b (b later): every count and
    time of b less a's. A stage that charged nothing in between is left
    out, so a stage whose graphs were captured without tracing reads as
    missing (stage_times: None), never as 0. 'device_ns' is the device
    time between the last stamps before a and before b: the sum of the
    stages' self times (None where a was taken before tracing began)."""
    out = dict(enabled=b['enabled'], launches={
        o: {k: v - a['launches'].get(o, {}).get(k, 0) for k, v in c.items()}
        for o, c in b['launches'].items()})
    ga = a['graphs']
    out['graphs'] = {
        i: dict(g, **{k: g[k] - ga[i][k] for k in
                      ('capture_s', 'instantiate_s', 'branch_runs',
                       'branch_skips')}) if i in ga else dict(g)
        for i, g in b['graphs'].items()}
    if 'stages' not in b:
        return out
    sa = a.get('stages', {})
    stages = {}
    for p, (ns, n) in b['stages'].items():
        ns0, n0 = sa.get(p, (0, 0))
        if n != n0:
            stages[p] = [ns - ns0, n - n0]
    la = a.get('live', dict(closest=0, any=0))
    na = a.get('lanes', {})
    out.update(device=b['device'], stages=stages,
               device_ns=b['clock_ns'] - a['clock_ns'] if 'clock_ns' in a
               else None,
               live={k: v - la[k] for k, v in b['live'].items()},
               lanes={n: {s: v - na.get(n, {}).get(s, 0)
                          for s, v in c.items()}
                      for n, c in b['lanes'].items()},
               calls=b['calls'] - a.get('calls', 0),
               host_spans=b['host_spans'] - a.get('host_spans', 0))
    return out


def stage_times(snap):
    """{span name: {'self_ns', 'incl_ns', 'count'}} of a snapshot or a
    delta, summed over the stages (paths) the name ends: self is the time
    charged to the name's own slots, inclusive adds its descendants',
    counting a stage nested in a stage of the same name once. Names with
    no stage in snap are missing."""
    stages = snap.get('stages', {})
    out = {}
    for p, (ns, n) in stages.items():
        parts = p.split('/')
        name = parts[-1]
        e = out.setdefault(name, dict(self_ns=0, incl_ns=0, count=0))
        e['self_ns'] += ns
        e['count'] += n
        if name in parts[:-1]:
            continue
        pre = p + '/'
        e['incl_ns'] += ns + sum(v[0] for q, v in stages.items()
                                 if q.startswith(pre))
    return out


def stage_ms(snap, name, inclusive=False, per=1):
    """Milliseconds of span `name` in snap (stage_times), over `per`;
    None where no stage of that name charged anything."""
    e = stage_times(snap).get(name)
    if e is None:
        return None
    return e['incl_ns' if inclusive else 'self_ns'] * 1e-6 / per


def host_spans(since=None):
    """The ring's host spans, oldest first, recorded after snapshot
    `since` (default: all the ring holds): dicts of name, id, parent (its
    enclosing span's id, -1 at the top), call, arg, start_ns and end_ns on
    the profiler's clock."""
    st = _st
    if st is None:
        return []
    first = max(st.closed - RING_SIZE, 0)
    if since is not None:
        first = max(first, since.get('host_spans', 0))
    out = []
    for j in range(first, st.closed):
        k = j % RING_SIZE
        out.append(dict(name=st.r_name[k], id=int(st.r_id[k]),
                        parent=int(st.r_parent[k]), call=int(st.r_call[k]),
                        arg=int(st.r_arg[k]), start_ns=int(st.r_t0[k]),
                        end_ns=int(st.r_t1[k])))
    return out


def write_chrome_trace(path):
    """The ring's host spans as a Chrome-trace JSON file (chrome://tracing,
    Perfetto): complete events in microseconds on the profiler's clock,
    each with its call, argument, id and parent."""
    events = [dict(name=s['name'], ph='X', pid=0, tid=0,
                   ts=s['start_ns'] / 1e3,
                   dur=(s['end_ns'] - s['start_ns']) / 1e3,
                   args=dict(call=s['call'], arg=s['arg'], id=s['id'],
                             parent=s['parent']))
              for s in host_spans()]
    with open(path, 'w') as f:
        json.dump(dict(traceEvents=events, displayTimeUnit='ms'), f)


def stages_ms(snap):
    """{span name: {'self_ms', 'incl_ms', 'count'}} of snap (the CLI's
    timings['stages_ms'])."""
    return {k: dict(self_ms=v['self_ns'] * 1e-6, incl_ms=v['incl_ns'] * 1e-6,
                    count=v['count'])
            for k, v in sorted(stage_times(snap).items())}
