"""The port's program layer: the counterpart of the JAX package's
``jax.jit(fn, static_argnames=...)``.

``Program(fn, static_argnames=...)`` wraps a function whose other
arguments are tensors or nested tuples, NamedTuples, lists and dicts of
them. Called on the CUDA card, each cache key is run once and captured
once, then replayed:

  - The key is the static arguments' values, the structure of the other
    arguments, each tensor's shape, dtype and device, and the value of each
    non-tensor leaf (a host int in a state, such as the streaming
    aligner's buffer index, picks a branch as a static argument does): the
    key on which JAX retraces. Unhashable static arguments raise.
  - First call of a key: the inputs are copied into static buffers on the
    card and ``fn`` runs eagerly on a side stream, which does every lazy
    set-up (the nvcc build, kernel B's and C's launch-shape caches and
    shared-memory limits, cuFFT's plans, the per-device index tables).
    Its outputs are the call's result. Then ``fn`` is captured once more
    as a CUDA graph (``torch.cuda.CUDAGraph``) on the static inputs, into
    the program's memory pool on that card (below); the first call's time
    and the capture's are printed to stderr.
  - Every later call copies its inputs into the static inputs (a pinned
    host tensor with ``non_blocking=True``: the caller must not overwrite
    it before the stream has read it), replays the graph and returns
    clones of the static outputs. Inputs are never written, and a value
    returned by one call is never changed by a later call. The function
    reads its static inputs where they lie: the chunk programs' kernel A
    warps the carried frame tail and the chunk straight from theirs
    (models/chunked.py). JAX's ``donate_argnums`` is not mirrored, so a
    carried state, that frame tail included, is copied into the static
    inputs and its successor cloned out at every call.
  - The kernel wrappers count a launch when their Python runs, which in a
    replay it does not: each capture records the counts' deltas (and takes
    them back, since a capture launches nothing) and every replay adds
    them, so ``launch_counts()`` stays the number of kernels the card ran.
  - The spans of ``utils/spans.py`` cannot be timed inside a replay: a call
    on the card while a ``Recorder`` is active raises rather than dropping
    them. Inside ``eager()`` every program calls its function directly
    (the counterpart of ``jax.disable_jit``): stage tables come from there.
  - A capture that fails raises, naming the last torch function it reached;
    nothing falls back to the eager path.
  - All keys of one program on one card are captured into one memory pool
    (``torch.cuda.graph_pool_handle()``), so the card holds the largest
    key's temporaries once, not once per key. Sharing is safe because a
    key's temporaries are written before they are read in every replay;
    each key's static outputs stay allocated as live tensors, so another
    capture never receives them; every call clones its outputs right after
    its replay; and static inputs are allocated before the capture,
    outside the pool. The hazard left is two keys of one program replayed
    at the same time on two streams of one card: no caller does that
    (every replay runs on the caller's current stream, and each card of
    ``parallel/mesh.py`` has a pool of its own).
  - Each key keeps its graph, its static inputs and outputs until
    ``reset``, unless the program was made with ``max_keys``: then a new
    key's first call on a card that already holds ``max_keys`` of its keys
    first drops the least recently called of them. Once a card holds no
    key of the program, its pool goes back to the card and the next
    capture there opens a new one. The clip, metric and sweep programs
    keep one key per card: a clip's pool grows with its length (14.91 GB
    for 8 x 32 frames of 1080p on an NVIDIA H100), and a video's length
    changes from clip to clip. The chunk programs keep four
    (``models/chunked.py``).

On CPU tensors a program calls ``fn`` directly: the CPU runs the plain
versions, as the kernel wrappers do. A program called from inside another
program's function (while it runs or is captured) calls its function
directly too, as a nested ``jax.jit`` is inlined. No ``torch.compile``: a
replay runs the hand kernels and the same eager operations as the
un-captured function, bit for bit.
"""

from __future__ import annotations

import contextlib
import inspect
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

from video_stabilizer_tpu_torch.utils import spans

_LEAF = "*"
_eager_depth = 0
_tracing_depth = 0
_backend = None          # the capture backend; None means CudaGraphs()
PROGRAMS: list = []      # every program made, for ``reset`` and the stats


# -- pytrees -----------------------------------------------------------------

def _flatten(tree, leaves: list):
    """Append ``tree``'s leaves to ``leaves`` in order and return its
    (hashable) structure."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple(tree),
                tuple(_flatten(v, leaves) for v in tree.values()))
    leaves.append(tree)
    return _LEAF


def _unflatten(spec, it):
    if spec == _LEAF:
        return next(it)
    kind = spec[0]
    if kind is dict:
        return dict(zip(spec[1], (_unflatten(s, it) for s in spec[2])))
    children = [_unflatten(s, it) for s in spec[1]]
    return kind(*children) if hasattr(kind, "_fields") else kind(children)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    return ("value", type(x), x)


# -- launch counts -----------------------------------------------------------

def _kernel_wrappers():
    from video_stabilizer_tpu_torch.ops.accum import accum_scan_kernel
    from video_stabilizer_tpu_torch.ops.gn8_solve import gn8_solve
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.ops.gray import bgr_to_gray_kernel
    from video_stabilizer_tpu_torch.ops.keyframe import keyframe_levels_kernel
    from video_stabilizer_tpu_torch.ops.linalg import (
        regularized_pinv_sym4_kernel)
    from video_stabilizer_tpu_torch.ops.prelude import level_prelude_kernel
    from video_stabilizer_tpu_torch.ops.pyr_down import pyr_down_kernel
    from video_stabilizer_tpu_torch.ops.tvl1 import tvl1_smooth_kernel
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
    return (gn_solve, gn8_solve, warp_frames, tvl1_smooth_kernel,
            regularized_pinv_sym4_kernel, accum_scan_kernel,
            bgr_to_gray_kernel, pyr_down_kernel, keyframe_levels_kernel,
            level_prelude_kernel)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, and kernel A's per form:
    {(wrapper name, None or form): count}."""
    counts = {}
    for fn in _kernel_wrappers():
        counts[(fn.__name__, None)] = fn.launches
        for form, n in getattr(fn, "form_launches", {}).items():
            counts[(fn.__name__, form)] = n
    return counts


def add_launches(delta: dict):
    """Add ``delta`` (as ``launch_counts`` keys it) to the wrappers'
    counts."""
    by_name = {fn.__name__: fn for fn in _kernel_wrappers()}
    for (name, form), n in delta.items():
        fn = by_name[name]
        if form is None:
            fn.launches += n
        else:
            fn.form_launches[form] = fn.form_launches.get(form, 0) + n


def _count_delta(before: dict, after: dict) -> dict:
    delta = {k: n - before.get(k, 0) for k, n in after.items()}
    return {k: n for k, n in delta.items() if n}


# -- the CUDA backend ---------------------------------------------------------

class _LastFunction(TorchFunctionMode):
    """Remembers the last torch function called, to name the one that
    broke a capture."""

    def __init__(self):
        super().__init__()
        self.last = "no torch function"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.last = getattr(func, "__qualname__", None) or repr(func)
        return func(*args, **(kwargs or {}))


class CudaGraphs:
    """Runs, captures and replays programs on a CUDA device, on one side
    stream per device."""

    def __init__(self):
        self._streams = {}

    def device_of(self, leaves):
        """The CUDA device of the tensor leaves, or None when none is on
        one."""
        devs = {x.device for x in leaves
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
        if len(devs) > 1:
            raise ValueError(f"a program's tensors lie on several devices: "
                             f"{sorted(map(str, devs))}")
        if not devs:
            return None
        dev = devs.pop()
        return torch.device("cuda", dev.index if dev.index is not None
                            else torch.cuda.current_device())

    def _side(self, dev):
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        return stream

    def on(self, dev):
        return torch.cuda.device(dev)

    def warmup(self, dev, fn):
        side = self._side(dev)
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        return out

    def new_pool(self, dev):
        """A handle for a new memory pool that captures on ``dev`` share."""
        return torch.cuda.graph_pool_handle()

    def capture(self, dev, fn, name, pool):
        """(graph, static outputs, capture s, instantiate s, the bytes the
        capture added to the card's reserved memory): ``fn`` captured into
        the memory pool ``pool``."""
        side = self._side(dev)
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        tracker = _LastFunction()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                with tracker:
                    out = fn()
            except BaseException as err:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                if not isinstance(err, Exception):
                    raise
                raise RuntimeError(
                    f"{name}: the CUDA graph capture failed after "
                    f"{tracker.last} ({type(err).__name__}: {err}); the "
                    "program does not fall back to the eager path") from err
            t1 = time.perf_counter()
            graph.capture_end()          # ends the capture and instantiates
        t2 = time.perf_counter()
        pool = torch.cuda.memory_reserved(dev) - reserved
        return graph, out, t1 - t0, t2 - t1, pool

    def replay(self, dev, graph):
        graph.replay()

    def release(self, dev, entries):
        """Free the dropped ``entries`` (their graphs, static inputs and
        outputs) once the card has run what was queued. A pool whose last
        graph went goes back to the card; the blocks of a pool still in use
        stay in it for its next capture."""
        torch.cuda.synchronize(dev)
        entries.clear()
        torch.cuda.empty_cache()


def _the_backend():
    global _backend
    if _backend is None:
        _backend = CudaGraphs()
    return _backend


@contextlib.contextmanager
def use_backend(backend):
    """Run programs through ``backend`` (a stand-in for ``CudaGraphs``,
    with the same methods) inside the block."""
    global _backend
    saved, _backend = _backend, backend
    try:
        yield backend
    finally:
        _backend = saved


@contextlib.contextmanager
def eager():
    """Inside the block every program calls its function directly, on any
    device (the counterpart of ``jax.disable_jit``): the spans of
    ``utils/spans.py`` and the profiler's Python frames see its stages."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


@contextlib.contextmanager
def _tracing():
    global _tracing_depth
    _tracing_depth += 1
    try:
        yield
    finally:
        _tracing_depth -= 1


# -- programs -----------------------------------------------------------------

class _Entry:
    """One captured key: its device, static inputs (None for non-tensor
    leaves), the graph, its static outputs and their structure, the
    launch-count deltas of one replay, and what the capture cost and
    holds."""

    def __init__(self, dev, static_in, graph, out, delta, stats):
        self.dev = dev
        self.static_in = static_in
        self.graph = graph
        self.out_leaves = []
        self.out_spec = _flatten(out, self.out_leaves)
        self.delta = delta
        self.stats = dict(stats, static_in_bytes=storage_nbytes(static_in),
                          static_out_bytes=storage_nbytes(self.out_leaves))


def storage_nbytes(leaves) -> int:
    """The bytes of the storages the tensor leaves hold, each once."""
    storages = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
                for x in leaves if isinstance(x, torch.Tensor)}
    return sum(storages.values())


class Program:
    """A function captured once per cache key and replayed on the card
    (see the module's docstring). ``captures`` and ``replays`` count what
    it did, ``evictions`` the keys ``max_keys`` dropped; ``stats()`` lists
    each kept key's capture figures, least recently called first."""

    def __init__(self, fn, static_argnames=(), name=None, max_keys=None):
        self.fn = fn
        self.name = name or fn.__name__
        self._sig = inspect.signature(fn)
        unknown = set(static_argnames) - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"{self.name} has no argument {sorted(unknown)}")
        self.static_argnames = tuple(static_argnames)
        self.max_keys = max_keys
        self._cache = {}         # least recently called first
        self._pools = {}         # device -> the pool its keys share
        self.captures = self.replays = self.evictions = 0
        PROGRAMS.append(self)

    def __repr__(self):
        return (f"<program {self.name}: {len(self._cache)} keys, "
                f"{self.replays} replays>")

    def reset(self):
        """Drop every captured graph (and its memory pools) and set the
        counts to 0."""
        self._cache.clear()
        self._pools.clear()
        self.captures = self.replays = self.evictions = 0

    def stats(self) -> list:
        return [e.stats for e in self._cache.values()]

    def pool(self, dev):
        """The handle of the pool this program's keys share on ``dev``, or
        None while it holds no key there."""
        return self._pools.get(dev)

    def _call(self, arguments, dyn_names, dyn_values):
        kwargs = dict(arguments)
        kwargs.update(zip(dyn_names, dyn_values))
        return self.fn(**kwargs)

    def __call__(self, *args, **kwargs):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = bound.arguments
        statics = tuple(arguments[n] for n in self.static_argnames)
        dyn_names = [n for n in arguments if n not in self.static_argnames]
        leaves = []
        spec = _flatten(tuple(arguments[n] for n in dyn_names), leaves)
        key = (statics, spec, tuple(_meta(x) for x in leaves))
        try:
            hash(key)
        except TypeError as err:
            raise TypeError(
                f"{self.name}: its static arguments "
                f"{dict(zip(self.static_argnames, statics))} and non-tensor "
                f"leaves must be hashable ({err})") from err
        backend = _the_backend()
        dev = (None if _eager_depth or _tracing_depth
               else backend.device_of(leaves))
        if dev is None:
            return self.fn(**arguments)
        if spans.active():
            raise RuntimeError(
                f"{self.name}: a span Recorder is active, and the spans of a "
                "replayed graph cannot be timed; record the stages inside "
                "graphs.eager()")
        with backend.on(dev):
            entry = self._cache.pop(key, None)
            if entry is None:
                self._make_room(dev, backend)
                return self._first_call(key, arguments, dyn_names, spec,
                                        leaves, dev, backend)
            self._cache[key] = entry
            for buf, x in zip(entry.static_in, leaves):
                if buf is not None:
                    buf.copy_(x, non_blocking=True)
            backend.replay(dev, entry.graph)
            add_launches(entry.delta)
            self.replays += 1
            return _unflatten(entry.out_spec, iter(
                [y.clone() if isinstance(y, torch.Tensor) else y
                 for y in entry.out_leaves]))

    def _make_room(self, dev, backend):
        """Drop the least recently called keys on ``dev`` beyond
        ``max_keys - 1``, before a new key's capture needs their memory."""
        if self.max_keys is None:
            return
        on_dev = [k for k, e in self._cache.items() if e.dev == dev]
        old = on_dev[:max(0, len(on_dev) - self.max_keys + 1)]
        if old:
            self.evictions += len(old)
            backend.release(dev, [self._cache.pop(k) for k in old])
            self._forget_empty_pool(dev)

    def _forget_empty_pool(self, dev):
        """Once no key is left on ``dev``, its pool has gone back to the
        card (or no graph ever used it): the next capture opens a new one,
        since the allocator cannot reopen a pool whose graphs are all
        gone."""
        if all(e.dev != dev for e in self._cache.values()):
            self._pools.pop(dev, None)

    def _first_call(self, key, arguments, dyn_names, spec, leaves, dev,
                    backend):
        t0 = time.perf_counter()
        static_in = _static_inputs(leaves, dev)
        dyn_values = _unflatten(spec, iter(
            [b if b is not None else x for b, x in zip(static_in, leaves)]))

        def run():
            return self._call(arguments, dyn_names, dyn_values)

        with _tracing():
            out = backend.warmup(dev, run)
            t1 = time.perf_counter()
            before = launch_counts()
            if dev not in self._pools:
                self._pools[dev] = backend.new_pool(dev)
            try:
                graph, static_out, cap_s, inst_s, grew = backend.capture(
                    dev, run, self.name, self._pools[dev])
            except BaseException:
                self._forget_empty_pool(dev)
                raise
            finally:
                # A capture launches nothing: take back what it counted.
                delta = _count_delta(before, launch_counts())
                add_launches({k: -n for k, n in delta.items()})
        stats = dict(program=self.name, first_call_s=time.perf_counter() - t0,
                     eager_s=t1 - t0, capture_s=cap_s, instantiate_s=inst_s,
                     pool_bytes=grew, launches_per_replay=delta)
        self._cache[key] = _Entry(dev, static_in, graph, static_out, delta,
                                  stats)
        self.captures += 1
        print(f"{self.name}: first call {stats['first_call_s']:.2f} s (eager "
              f"{stats['eager_s']:.2f} s, capture {cap_s:.2f} s, instantiate "
              f"{inst_s:.2f} s), the shared graph pool grew "
              f"{grew / 1e6:.1f} MB",
              file=sys.stderr)
        # The eager outputs are the call's result; any that shares memory
        # with a static input would change at the next call: copy it.
        in_ptrs = {b.untyped_storage().data_ptr() for b in static_in
                   if b is not None}
        out_leaves = []
        out_spec = _flatten(out, out_leaves)
        return _unflatten(out_spec, iter(
            [y.clone() if isinstance(y, torch.Tensor)
             and y.untyped_storage().data_ptr() in in_ptrs else y
             for y in out_leaves]))


def _static_inputs(leaves, dev):
    """A copy on ``dev`` of each tensor leaf (None for the other leaves),
    all views of one allocation. Static inputs live as long as their key:
    allocated one by one, a small one could take the tail of a segment that
    a caller's tensor of the moment fills, and hold the whole segment once
    that tensor is freed (on the card a 1.5 MB input held a 499 MB segment
    that way). On the card the cache is emptied first, so that the one
    allocation gets a segment of its own size, not a larger free one."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    align = 512
    offsets, total = [], 0
    for x in leaves:
        if isinstance(x, torch.Tensor):
            offsets.append(total)
            total += -(-x.numel() * x.element_size() // align) * align
        else:
            offsets.append(None)
    block = torch.empty(total, dtype=torch.uint8, device=dev)
    bufs = []
    for x, at in zip(leaves, offsets):
        if at is None:
            bufs.append(None)
            continue
        size = x.numel() * x.element_size()
        buf = block[at:at + size].view(x.dtype).view(x.shape)
        buf.copy_(x, non_blocking=True)
        bufs.append(buf)
    return bufs


def reset(programs=None):
    """Drop the captured graphs of ``programs`` (every program's if None),
    free their memory and set their counts to 0."""
    for prog in PROGRAMS if programs is None else programs:
        prog.reset()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
