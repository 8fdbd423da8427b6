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
launch_counter. A capture launches nothing, so the launches its wrappers
counted are taken back, and added again at every execution of the graph:
the counts stay kernel executions.
"""

import ctypes
import gc
import time

import torch

from ..utils.tree import tree_leaves

_capture = None   # the StepGraphs capturing in this process, else None
_counters = []    # every launch_counter dict


def launch_counter(keys):
    """A dict of launch counts, each key at 0, that StepGraphs keeps
    counting kernel executions under replay. A kernel wrapper adds one to
    its key where it launches its kernel, and nowhere else."""
    counts = dict.fromkeys(keys, 0)
    _counters.append(counts)
    return counts


def _snapshot():
    return [dict(c) for c in _counters]


def _add_launches(delta, sign=1):
    for counts, d in zip(_counters, delta):
        for k, v in d.items():
            counts[k] += sign * v


def _since(before):
    return [{k: c[k] - b.get(k, 0) for k in c}
            for c, b in zip(_counters, before)]


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
    and instantiate_s (host seconds), and branch_runs and branch_skips
    (the branches' executions and skips, the capture's included)."""

    def __init__(self, device, generator=None, pool=None):
        self.device = torch.device(device)
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.graphs, self.calls, self.branches, self.nodes = [], [], [], []
        self.capture_s = self.instantiate_s = 0.0
        self.branch_runs = self.branch_skips = 0
        self._seq = []      # the step: ('graph' | 'call' | 'cond', ...)
        self._cur = self._seq
        self._depth = 0     # cond_call branches open
        self._stream = torch.cuda.Stream(self.device)

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
        self._run(self._seq)

    def _run(self, seq):
        for item in seq:
            if item[0] == 'graph':
                item[1].replay()
                _add_launches(item[2])
            elif item[0] == 'call':
                _, fn, args, out = item
                new = fn(*args)
                for o, n in zip(_as_tuple(out), _as_tuple(new)):
                    o.copy_(n)
            else:
                _, flag, branch, out = item
                if bool(flag):
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
        self._before = _snapshot()
        self._t0 = time.perf_counter()
        g.capture_begin(pool=self.pool)
        self.graphs.append(g)

    def _end(self):
        g = self.graphs[-1]
        g.capture_end()
        self.capture_s += time.perf_counter() - self._t0
        delta = _since(self._before)
        _add_launches(delta, -1)
        self._cur.append(('graph', g, delta))
        self.nodes.append(node_count(g))
        t0 = time.perf_counter()
        g.instantiate()
        self.instantiate_s += time.perf_counter() - t0
        g.replay()
        _add_launches(delta)

    def _split(self, fn, args):
        self._end()
        out = fn(*args)
        self.calls.append((fn, args, out))
        self._cur.append(('call', fn, args, out))
        self._begin()
        return out

    def _cond(self, flag, fn, args):
        self._end()
        outer, self._cur = self._cur, []
        self._depth += 1
        before = _snapshot()
        self._begin()
        out = fn(*args)
        self._end()
        self._depth -= 1
        branch, self._cur = self._cur, outer
        self.branches.append((fn, [x[1] for x in branch if x[0] == 'graph']))
        self._cur.append(('cond', flag, branch, out))
        # the branch ran as it was captured; undo it where flag is false
        if bool(flag):
            self.branch_runs += 1
        else:
            self.branch_skips += 1
            _add_launches(_since(before), -1)
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
