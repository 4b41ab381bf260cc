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
    returned by one call is never changed by a later call, except where
    the call donates (below). The function reads its static inputs where
    they lie: the chunk programs' kernel A warps the carried frame tail and
    the chunk straight from theirs (models/chunked.py).
  - ``Program(..., donate_argnames=("states",))`` is the counterpart of
    ``donate_argnums``: the named arguments (pytrees) are donated when the
    program is called (``prog(...)``), and not when it is called as
    ``prog.call(..., donate=False)``; both share one key and its buffers.
    The function must write the new state into the donated argument's
    tensors and return them. A donating call returns those static inputs
    themselves, as fresh views, uncloned; its other outputs are cloned. A
    donating call whose donated tensors are the views the same key returned
    last copies nothing in: the state is already where the graph reads it.
    Any other donated tensor (a fresh state, one from the host or from
    another chain) is copied in, as every input of a call that does not
    donate is, and is never written. Before a call writes a key's donated
    static inputs, the views it returned last, where a caller still holds
    them, are moved to a copy of their own (``Tensor.set_``): two chains of
    one key each give what they give alone, a single chain pays nothing,
    and interleaved chains pay one state in and one out per call, as a call
    that does not donate does. A caller must use only the state a donating
    call returned: passing again a state that a later call has advanced
    raises ``RuntimeError`` (JAX raises on a deleted buffer), also after its
    key was dropped. Static inputs of donated arguments are one allocation
    of their own, outside the graph pool, so a state its caller keeps after
    its key was dropped holds only the state's bytes.
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
    its replay (a donated state it returns is a static input); and static
    inputs are allocated before the capture, outside the pool. The hazard
    left is two keys of one program replayed at the same time on two
    streams of one card: no caller does that (every replay runs on the
    caller's current stream, and each card of ``parallel/mesh.py`` has a
    pool of its own).
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
versions, as the kernel wrappers do. So does a program inside ``eager()``;
there a donating call lets ``fn`` write the caller's donated tensors in
place (as JAX on the CPU may consume a donated buffer), and a call that
does not donate gives ``fn`` copies of them. A program called from inside
another program's function (while it runs or is captured) calls its
function directly too, as a nested ``jax.jit`` is inlined. No
``torch.compile``: a replay runs the hand kernels and the same eager
operations as the un-captured function, bit for bit.
"""

from __future__ import annotations

import contextlib
import inspect
import sys
import time
import weakref

import torch
from torch.overrides import TorchFunctionMode

from video_stabilizer_tpu_torch.utils import spans

_LEAF = "*"
_DONATED = "_vs_donated"  # a donated state's view: (its _Generation, number)
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


def _tree_map(fn, tree):
    leaves = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([fn(x) for x in leaves]))


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

    def capture(self, dev, fn, name, pool, inputs):
        """(graph, static outputs, capture s, instantiate s, the bytes the
        capture added to the card's reserved memory): ``fn`` captured into
        the memory pool ``pool``. A capture runs no kernel, so it leaves
        ``inputs``, the static inputs ``fn`` reads and may write, holding
        what the eager run left there."""
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

class _Generation:
    """How many donated states a key has returned: each view it returns
    carries the number it was returned at, so a state that a later call has
    advanced is known, also after the key was dropped."""

    def __init__(self):
        self.n = 0


def _same_view(a, b) -> bool:
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.dtype == b.dtype and a.shape == b.shape
            and a.stride() == b.stride() and a.data_ptr() == b.data_ptr())


class _Entry:
    """One captured key: its device, static inputs (None for non-tensor
    leaves) and which of them are donated, the graph, its static outputs
    and their structure, the launch-count deltas of one replay, and what
    the capture cost and holds. For a donated state: ``returns`` maps an
    output leaf that is a donated static input to that input's leaf, and
    ``views`` each such input to the view of it the key returned last."""

    def __init__(self, dev, static_in, donated, graph, out, delta, stats):
        self.dev = dev
        self.static_in = static_in
        self.graph = graph
        self.out_leaves = []
        self.out_spec = _flatten(out, self.out_leaves)
        self.delta = delta
        self.returns = {j: i for j, y in enumerate(self.out_leaves)
                        for i, b in enumerate(static_in)
                        if donated[i] and _same_view(y, b)}
        self.views = {}
        self.generation = _Generation()
        self.in_storages = {b.untyped_storage().data_ptr() for b in static_in
                            if b is not None}
        self.donated_block = next(
            (b.untyped_storage().data_ptr() for b, d in zip(static_in, donated)
             if d and b is not None), None)
        self.stats = dict(stats, static_in_bytes=storage_nbytes(static_in),
                          static_out_bytes=storage_nbytes(
                              [y for y in self.out_leaves
                               if isinstance(y, torch.Tensor)
                               and y.untyped_storage().data_ptr()
                               not in self.in_storages]))

    def holds(self, i, x) -> bool:
        """Whether ``x`` is the view of donated input ``i`` that this key
        returned last: its chain's state, already in place."""
        ref = self.views.get(i)
        return ref is not None and ref() is x

    def release(self, i):
        """Move the view of donated input ``i`` returned last, if a caller
        still holds it, to a copy of its own, before the input is
        written."""
        ref = self.views.pop(i, None)
        view = None if ref is None else ref()
        if view is not None:
            view.set_(view.clone())
            delattr(view, _DONATED)

    def outputs(self, leaves, donate, first=False):
        """The call's results from the output leaves ``leaves`` (the static
        outputs after a replay; the eager run's at the first call): where
        the call donates, a fresh view of each donated static input the
        function returned; a clone of every other tensor, or at the first
        call only of those that lie in a static input (the others are the
        eager run's own)."""
        if donate and self.returns:
            self.generation.n += 1
        res = []
        for j, y in enumerate(leaves):
            if isinstance(y, torch.Tensor):
                if donate and j in self.returns:
                    buf = self.static_in[self.returns[j]]
                    if not _same_view(y, buf):
                        raise RuntimeError(
                            "a donating program's eager run and its capture "
                            "returned different tensors as its state")
                    y = buf.view(buf.shape)
                    setattr(y, _DONATED, (self.generation,
                                          self.generation.n))
                    self.views[self.returns[j]] = weakref.ref(y)
                elif (not first
                      or y.untyped_storage().data_ptr() in self.in_storages):
                    y = y.clone()
            res.append(y)
        return _unflatten(self.out_spec, iter(res))


def storage_nbytes(leaves) -> int:
    """The bytes of the storages the tensor leaves hold, each once."""
    storages = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
                for x in leaves if isinstance(x, torch.Tensor)}
    return sum(storages.values())


class Program:
    """A function captured once per cache key and replayed on the card
    (see the module's docstring). ``captures`` and ``replays`` count what
    it did, ``evictions`` the keys ``max_keys`` dropped; ``stats()`` lists
    each kept key's capture figures, least recently called first.
    ``donate_argnames`` names the arguments a call donates."""

    def __init__(self, fn, static_argnames=(), name=None, max_keys=None,
                 donate_argnames=()):
        self.fn = fn
        self.name = name or fn.__name__
        self._sig = inspect.signature(fn)
        unknown = (set(static_argnames) | set(donate_argnames)) - set(
            self._sig.parameters)
        if unknown:
            raise ValueError(f"{self.name} has no argument {sorted(unknown)}")
        if set(static_argnames) & set(donate_argnames):
            raise ValueError(f"{self.name}: a static argument cannot be "
                             "donated")
        self.static_argnames = tuple(static_argnames)
        self.donate_argnames = tuple(donate_argnames)
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
        """Call as ``jax.jit`` does: ``donate_argnames`` are donated."""
        return self._run(args, kwargs, donate=True)

    def call(self, *args, donate: bool, **kwargs):
        """A call whose donation is chosen here: with ``donate=False`` the
        donated arguments are copied in as the others are, never written,
        and the state returned is a copy."""
        return self._run(args, kwargs, donate)

    def _run(self, args, kwargs, donate):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = bound.arguments
        statics = tuple(arguments[n] for n in self.static_argnames)
        dyn_names = [n for n in arguments if n not in self.static_argnames]
        leaves, donated, specs = [], [], []
        for n in dyn_names:
            start = len(leaves)
            specs.append(_flatten(arguments[n], leaves))
            donated += [n in self.donate_argnames] * (len(leaves) - start)
        spec = (tuple, tuple(specs))
        key = (statics, spec, tuple(_meta(x) for x in leaves))
        try:
            hash(key)
        except TypeError as err:
            raise TypeError(
                f"{self.name}: its static arguments "
                f"{dict(zip(self.static_argnames, statics))} and non-tensor "
                f"leaves must be hashable ({err})") from err
        if self.donate_argnames:
            self._refuse_advanced(leaves, donated)
        backend = _the_backend()
        dev = (None if _eager_depth or _tracing_depth
               else backend.device_of(leaves))
        if dev is None:
            if self.donate_argnames and not donate:
                arguments = dict(arguments, **{
                    n: _tree_map(_clone, arguments[n])
                    for n in self.donate_argnames})
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
                                        leaves, donated, donate, dev,
                                        backend)
            self._cache[key] = entry
            for i, (buf, x) in enumerate(zip(entry.static_in, leaves)):
                if buf is None:
                    continue
                if donated[i]:
                    if donate and entry.holds(i, x):
                        continue
                    entry.release(i)
                buf.copy_(x, non_blocking=True)
            backend.replay(dev, entry.graph)
            add_launches(entry.delta)
            self.replays += 1
            return entry.outputs(entry.out_leaves, donate)

    def _refuse_advanced(self, leaves, donated):
        """Raise on a donated tensor whose values a later call has
        overwritten: a view this program returned that is no longer its
        key's newest, or any other view of a kept key's donated static
        inputs."""
        blocks = {e.donated_block for e in self._cache.values()}
        for x, d in zip(leaves, donated):
            if not d or not isinstance(x, torch.Tensor):
                continue
            tag = getattr(x, _DONATED, None)
            if (tag[0].n != tag[1] if tag is not None else x.numel()
                    and x.untyped_storage().data_ptr() in blocks):
                raise RuntimeError(
                    f"{self.name}: a donated argument "
                    f"({', '.join(self.donate_argnames)}) is a state that a "
                    "later call has already advanced, so its values are "
                    "gone; pass the state that the latest call returned")

    def _make_room(self, dev, backend):
        """Drop the least recently called keys on ``dev`` beyond
        ``max_keys - 1``, before a new key's capture needs their memory.
        A donated state a caller still holds keeps its static inputs, and
        its next call copies it in as any other state."""
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

    def _first_call(self, key, arguments, dyn_names, spec, leaves, donated,
                    donate, dev, backend):
        t0 = time.perf_counter()
        static_in = _static_inputs(leaves, donated, dev)
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
                    dev, run, self.name, self._pools[dev], static_in)
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
        entry = self._cache[key] = _Entry(dev, static_in, donated, graph,
                                          static_out, delta, stats)
        self.captures += 1
        print(f"{self.name}: first call {stats['first_call_s']:.2f} s (eager "
              f"{stats['eager_s']:.2f} s, capture {cap_s:.2f} s, instantiate "
              f"{inst_s:.2f} s), the shared graph pool grew "
              f"{grew / 1e6:.1f} MB",
              file=sys.stderr)
        # The eager run's outputs are the call's result (the eager run
        # updated a donated state in place, and the capture wrote nothing);
        # any other that shares memory with a static input would change at
        # the next call: copy it.
        out_leaves = []
        _flatten(out, out_leaves)
        return entry.outputs(out_leaves, donate, first=True)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _static_inputs(leaves, donated, dev):
    """A copy on ``dev`` of each tensor leaf (None for the other leaves):
    the donated ones views of one allocation, the others of another, so a
    donated state a caller keeps after its key was dropped holds only its
    own bytes. Static inputs live as long as their key: allocated one by
    one, a small one could take the tail of a segment that a caller's
    tensor of the moment fills, and hold the whole segment once that tensor
    is freed (on the card a 1.5 MB input held a 499 MB segment that way).
    On the card the cache is emptied first, so that each allocation gets a
    segment of its own size, not a larger free one."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    align = 512
    bufs = [None] * len(leaves)
    for group in (True, False):
        offsets, total = {}, 0
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor) and donated[i] == group:
                offsets[i] = total
                total += -(-x.numel() * x.element_size() // align) * align
        if not offsets:
            continue
        block = torch.empty(total, dtype=torch.uint8, device=dev)
        for i, at in offsets.items():
            x = leaves[i]
            size = x.numel() * x.element_size()
            buf = block[at:at + size].view(x.dtype).view(x.shape)
            buf.copy_(x, non_blocking=True)
            bufs[i] = buf
    return bufs


def reset(programs=None):
    """Drop the captured graphs of ``programs`` (every program's if None),
    free their memory and set their counts to 0."""
    for prog in PROGRAMS if programs is None else programs:
        prog.reset()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
