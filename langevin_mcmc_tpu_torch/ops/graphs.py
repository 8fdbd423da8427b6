"""CUDA graphs of the chain step: the port's counterpart of the JAX
package's fused multi-step (integrators/mlt.make_mlt_multi_step), which
runs n_inner chain iterations as one device program.

A StepGraphs captures one call of a step on the card and replays it. The
step must be static-shaped and free of host reads, as a jitted JAX step
is, with two exceptions, each of which ends the graph in progress and
begins the next one after it:

* eager_call(fn, ...): a call that cannot be captured (a library call
  that reads its error flags on the host, as torch.linalg.eigh does)
  runs eagerly between two graphs, again at every replay;
* cond_call(flag, fn, ...): JAX's lax.cond of a costly branch. Outside a
  capture fn runs and its results are selected by flag on the device.
  Captured, fn becomes graphs of its own, and a replay reads flag on the
  host (one sync) and replays them only when it is true, else it zeroes
  their results.

The kernel wrappers count launches on the host, each in a dict made by
launch_counter (ops/tracing, the trace registry). A capture launches
nothing, so the launches its wrappers counted are taken back, and added
again at every execution of the graph: the counts stay kernel
executions.

With tracing on (ops/tracing) at its capture, each graph of a StepGraphs
begins with a stamp charging 'graphs.gap' and ends with one charging the
innermost open span, each eager call is stamped on both sides (its device
time charged to the span open where it was captured), and its replays
record the host spans graphs.replay, graphs.launch (the graph's index),
graphs.flag_read, graphs.eager_call.<the function's name> and, at the
capture, graphs.instantiate.
"""

import ctypes
import gc
import time

import torch

from ..utils.tree import tree_leaves
from . import tracing

_capture = None   # the StepGraphs capturing in this process, else None


def eager_call(fn, *args):
    """fn(*args), run outside every CUDA graph. Outside a capture this is
    the plain call. During StepGraphs.capture the graph in progress ends
    (and runs once) before the call and the next one begins after it;
    every replay calls fn again on the same input tensors and copies its
    result into the tensors this call returned. fn takes tensors (and
    objects that do not change between replays) and returns a tensor or a
    tuple of tensors, of the same shapes at every call."""
    if _capture is None:
        return fn(*args)
    return _capture._split(fn, args)


def cond_call(flag, fn, *args):
    """fn(*args) where the 0-dim bool tensor flag is true, zeros of the
    same shapes where it is false: what lax.cond(flag, fn, zeros) gives.
    Outside a capture fn runs and its results are selected on the device,
    with no host read. During StepGraphs.capture fn becomes graphs of its
    own, run (at the capture and at every replay) only when flag, read on
    the host after the graph that computes it, is true. fn returns a
    tensor or a tuple of tensors that it made (zeroed in place when flag
    is false) and draws no random numbers (a skipped branch advances no
    generator)."""
    if _capture is None:
        out = fn(*args)
        return type(out)(torch.where(flag, o, torch.zeros_like(o))
                         for o in out) if isinstance(out, tuple) else \
            torch.where(flag, out, torch.zeros_like(out))
    return _capture._cond(flag, fn, args)


def node_count(graph):
    """Nodes of a graph captured with keep_graph=True (the driver's
    cuGraphGetNodes)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL('libcuda.so.1').cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f'cuGraphGetNodes failed ({err})')
    return n.value


class StepGraphs:
    """One step captured as CUDA graphs on `device`, replayed in order.

    generator: the torch.Generator the step draws from, registered with
    every graph outside a cond_call branch, so that a replay draws the
    numbers an eager call would draw next. pool: the graphs' memory pool
    (one torch.cuda.graph_pool_handle shared by steps that never run
    interleaved; default a new one).

    After capture: graphs (every CUDAGraph), calls (the eager calls
    between them: (fn, args, results)), branches (the cond_calls: (fn,
    graphs of the branch)), nodes (each graph's node count), capture_s
    and instantiate_s (host seconds), branch_runs and branch_skips (the
    branches' executions and skips, the capture's included), and traced
    (whether tracing was on at the capture: its graphs carry the stamps).
    The trace registry reports every StepGraphs (tracing.snapshot)."""

    def __init__(self, device, generator=None, pool=None):
        self.device = torch.device(device)
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.graphs, self.calls, self.branches, self.nodes = [], [], [], []
        self.capture_s = self.instantiate_s = 0.0
        self.branch_runs = self.branch_skips = 0
        self.traced = False
        self._seq = []      # the step: ('graph' | 'call' | 'cond', ...)
        self._cur = self._seq
        self._depth = 0     # cond_call branches open
        self._stream = torch.cuda.Stream(self.device)
        tracing.register_graphs(self)

    def capture(self, body):
        """Capture body() (a step that writes its results into tensors
        that outlive it) and run it once: each graph runs as soon as it is
        captured, each eager call between graphs runs for real, and a
        branch's graphs run when its flag is true. A capture that fails
        raises."""
        global _capture
        if _capture is not None or self.graphs:
            raise RuntimeError('StepGraphs.capture: a capture is in '
                               'progress or this step was captured')
        # an unreachable graph of an earlier step, freed by the cyclic
        # collector in the middle of this capture, would end it (a graph's
        # reset is not permitted while a stream captures)
        gc.collect()
        self.traced = tracing.traces(self.device)
        gc_was_on = gc.isenabled()
        gc.disable()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            _capture = self
            try:
                self._begin()
                body()
                self._end()
            except BaseException:
                if torch.cuda.is_current_stream_capturing():
                    # leave the stream usable for the error's report
                    try:
                        self.graphs[-1].capture_end()
                    except RuntimeError:
                        pass
                raise
            finally:
                _capture = None
                if gc_was_on:
                    gc.enable()
        cur.wait_stream(self._stream)

    def run_eager(self, fn):
        """fn() on the capture's side stream (the warm-up before a capture:
        lazy initialisations happen outside it)."""
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        return out

    def replay(self):
        """One execution of the captured step on the current stream."""
        with tracing.host_span('graphs.replay'):
            self._run(self._seq)

    def _run(self, seq):
        on = tracing._on
        for item in seq:
            if item[0] == 'graph':
                if on:
                    sp = tracing.host_open('graphs.launch', item[3])
                item[1].replay()
                tracing.add_launches(item[2])
                if on:
                    tracing.host_close(sp)
            elif item[0] == 'call':
                _, fn, args, out, stage = item
                self._eager(fn, args, stage, into=out)
            else:
                _, flag, branch, out = item
                if on:
                    sp = tracing.host_open('graphs.flag_read')
                run = bool(flag)
                if on:
                    tracing.host_close(sp)
                if run:
                    self.branch_runs += 1
                    self._run(branch)
                else:
                    self.branch_skips += 1
                    for o in _as_tuple(out):
                        o.zero_()

    def _begin(self):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generator is not None and not self._depth:
            g.register_generator_state(self.generator)
        self._before = tracing.launch_snapshot()
        self._t0 = time.perf_counter()
        g.capture_begin(pool=self.pool)
        self.graphs.append(g)
        if self.traced:
            tracing.stamp_gap()

    def _end(self):
        g = self.graphs[-1]
        if self.traced:
            tracing.stamp_open()
        g.capture_end()
        self.capture_s += time.perf_counter() - self._t0
        delta = tracing.launches_since(self._before)
        tracing.add_launches(delta, -1)
        index = len(self.graphs) - 1
        self._cur.append(('graph', g, delta, index))
        self.nodes.append(node_count(g))
        with tracing.host_span('graphs.instantiate', index):
            t0 = time.perf_counter()
            g.instantiate()
            self.instantiate_s += time.perf_counter() - t0
        with tracing.host_span('graphs.launch', index):
            g.replay()
        tracing.add_launches(delta)

    def _split(self, fn, args):
        self._end()
        stage = tracing.open_stage() if self.traced else None
        out = self._eager(fn, args, stage)
        self.calls.append((fn, args, out))
        self._cur.append(('call', fn, args, out, stage))
        self._begin()
        return out

    def _eager(self, fn, args, stage, into=None):
        """fn(*args) between two graphs, its results copied into `into`
        where given, as the host span graphs.eager_call.<fn's name>;
        stage: None, or (a traced step) the stage slot its device time is
        charged to, between a stamp charging 'graphs.gap' and one charging
        the stage."""
        if stage is not None:
            tracing.stamp_gap()
        with tracing.host_span(f'graphs.eager_call.{fn.__name__}'):
            out = fn(*args)
            if into is not None:
                for o, n in zip(_as_tuple(into), _as_tuple(out)):
                    o.copy_(n)
        if stage is not None:
            tracing.stamp_stage(stage)
        return out

    def _cond(self, flag, fn, args):
        self._end()
        outer, self._cur = self._cur, []
        self._depth += 1
        before = tracing.launch_snapshot()
        self._begin()
        out = fn(*args)
        self._end()
        self._depth -= 1
        branch, self._cur = self._cur, outer
        self.branches.append((fn, [x[1] for x in branch if x[0] == 'graph']))
        self._cur.append(('cond', flag, branch, out))
        # the branch ran as it was captured; undo it where flag is false
        # (its stamps and live-ray counts, on the device, stay)
        with tracing.host_span('graphs.flag_read'):
            run = bool(flag)
        if run:
            self.branch_runs += 1
        else:
            self.branch_skips += 1
            tracing.add_launches(tracing.launches_since(before), -1)
            for o in _as_tuple(out):
                o.zero_()
        self._begin()
        return out


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def commit(dst, src):
    """Copy the tree src into the tree dst leaf by leaf, in place (the end
    of a captured step: its results into the tensors that persist across
    replays). A src leaf that is its dst leaf is left alone; a src leaf
    that shares memory with some other dst leaf is cloned first, so that
    no copy reads memory an earlier copy wrote."""
    dl, sl = tree_leaves(dst), tree_leaves(src)
    if len(dl) != len(sl):
        raise ValueError(f'commit: {len(sl)} leaves into {len(dl)}')
    spans = [(d.untyped_storage().data_ptr(), d.untyped_storage().nbytes())
             for d in dl]

    def overlaps(x):
        p = x.untyped_storage().data_ptr()
        return any(lo <= p < lo + n for lo, n in spans)
    for d, s in zip(dl, sl):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f'commit: {tuple(s.shape)} {s.dtype} into '
                             f'{tuple(d.shape)} {d.dtype}')
    pairs = [(d, s.clone() if overlaps(s) else s)
             for d, s in zip(dl, sl) if s is not d]
    for d, s in pairs:
        d.copy_(s)
