"""ctypes binding for the native host runtime (native/framepipe.cpp).

A copy of ``video_stabilizer_tpu.utils.native`` (native.py:1-210), kept
here because importing that module imports the JAX package. It provides
the aligned buffer pool, the multi-threaded batch staging queue and the
zero-dependency Y4M reader, and builds ``native/libframepipe.so`` with
``make -C native`` on first use if g++ is available (under a lock on the
``native`` directory, so that processes of the port do not build it at
once); ``bgr_to_gray`` has a pure-Python fallback, so the port never
hard-depends on the native component.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libframepipe.so"))

_lib = None
_lib_lock = threading.Lock()


def _build():
    native_dir = os.path.abspath(_NATIVE_DIR)
    fd = os.open(native_dir, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True)
    finally:
        os.close(fd)


def load(build: bool = True):
    """Load (building if needed) libframepipe; returns None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH) and build:
            try:
                _build()
            except (OSError, subprocess.CalledProcessError):
                return None
        if not os.path.exists(_SO_PATH):
            return None
        lib = ctypes.CDLL(_SO_PATH)

        c_i64 = ctypes.c_int64
        c_vp = ctypes.c_void_p
        c_u8p = ctypes.POINTER(ctypes.c_uint8)

        lib.fp_pool_create.restype = c_vp
        lib.fp_pool_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
        lib.fp_pool_acquire.restype = c_vp
        lib.fp_pool_acquire.argtypes = [c_vp]
        lib.fp_pool_release.argtypes = [c_vp, c_vp]
        lib.fp_pool_available.restype = ctypes.c_int
        lib.fp_pool_available.argtypes = [c_vp]
        lib.fp_pool_destroy.argtypes = [c_vp]

        lib.fp_bgr_to_gray.argtypes = [c_u8p, c_u8p, c_i64]
        lib.fp_stage_frame.argtypes = [c_u8p, c_i64, c_u8p, c_i64, c_i64, c_i64]

        lib.fp_queue_create.restype = c_vp
        lib.fp_queue_create.argtypes = [c_i64, c_i64, c_i64, ctypes.c_int,
                                        ctypes.c_int]
        lib.fp_queue_submit.restype = c_i64
        lib.fp_queue_submit.argtypes = [c_vp, c_u8p, c_i64]
        lib.fp_queue_pop_batch.restype = c_u8p
        lib.fp_queue_pop_batch.argtypes = [c_vp]
        lib.fp_queue_recycle.argtypes = [c_vp, c_u8p]
        lib.fp_queue_destroy.argtypes = [c_vp]

        lib.fp_y4m_open.restype = c_vp
        lib.fp_y4m_open.argtypes = [ctypes.c_char_p]
        lib.fp_y4m_width.restype = c_i64
        lib.fp_y4m_width.argtypes = [c_vp]
        lib.fp_y4m_height.restype = c_i64
        lib.fp_y4m_height.argtypes = [c_vp]
        lib.fp_y4m_next_gray.restype = ctypes.c_int
        lib.fp_y4m_next_gray.argtypes = [c_vp, c_u8p]
        lib.fp_y4m_next_bgr.restype = ctypes.c_int
        lib.fp_y4m_next_bgr.argtypes = [c_vp, c_u8p]
        lib.fp_y4m_close.argtypes = [c_vp]

        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """Native BGR->gray (cv2 5.x float-weight semantics); numpy fallback."""
    bgr = np.ascontiguousarray(bgr, np.uint8)
    lib = load()
    if lib is None:
        f = bgr.astype(np.float32)
        g = 0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]
        return np.round(g).astype(np.uint8)
    out = np.empty(bgr.shape[:-1], np.uint8)
    lib.fp_bgr_to_gray(_u8p(bgr), _u8p(out), out.size)
    return out


class BatchStager:
    """Multi-threaded (T, H, W, 3) batch assembly off the Python thread.

    Usage:
        stager = BatchStager(h, w, batch_frames=16)
        for frame in frames: stager.submit(frame)
        batch = stager.pop()      # (T, H, W, 3) u8 numpy view
        ... torch.from_numpy(batch).to(device) ...
        stager.recycle(batch)
    """

    def __init__(self, h: int, w: int, batch_frames: int = 16,
                 n_slabs: int = 4, n_workers: int = 2):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native framepipe unavailable")
        self.h, self.w, self.batch_frames = h, w, batch_frames
        self._q = self._lib.fp_queue_create(h, w, batch_frames, n_slabs,
                                            n_workers)
        if not self._q:
            raise MemoryError("fp_queue_create failed")
        self._inflight = []   # keep submitted frames alive
        self._views = {}

    def submit(self, frame_bgr: np.ndarray):
        frame_bgr = np.ascontiguousarray(frame_bgr, np.uint8)
        if frame_bgr.shape != (self.h, self.w, 3):
            raise ValueError(f"frame {frame_bgr.shape}, want "
                             f"{(self.h, self.w, 3)}")
        self._inflight.append(frame_bgr)
        idx = self._lib.fp_queue_submit(self._q, _u8p(frame_bgr),
                                        frame_bgr.strides[0])
        if idx < 0:
            raise RuntimeError("staging backpressure: no free batch slab "
                               "(pop/recycle batches faster)")
        return int(idx)

    def pop(self) -> np.ndarray:
        ptr = self._lib.fp_queue_pop_batch(self._q)
        if not ptr:
            raise RuntimeError("staging queue stopped")
        n = self.batch_frames * self.h * self.w * 3
        buf = np.ctypeslib.as_array(ptr, shape=(n,))
        batch = buf.view(np.uint8).reshape(self.batch_frames, self.h,
                                           self.w, 3)
        addr = ctypes.addressof(ptr.contents)
        self._views[addr] = ptr
        # Frames for this batch are now fully copied.
        del self._inflight[: self.batch_frames]
        return batch

    def recycle(self, batch: np.ndarray):
        addr = batch.ctypes.data
        ptr = self._views.pop(addr)
        self._lib.fp_queue_recycle(self._q, ptr)

    def close(self):
        if self._q:
            self._lib.fp_queue_destroy(self._q)
            self._q = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Y4MReader:
    """Zero-dependency YUV4MPEG2 reader (native fread path)."""

    def __init__(self, path: str):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native framepipe unavailable")
        self._y = self._lib.fp_y4m_open(path.encode())
        if not self._y:
            raise IOError(f"not a y4m file: {path}")
        self.width = int(self._lib.fp_y4m_width(self._y))
        self.height = int(self._lib.fp_y4m_height(self._y))

    def frames_gray(self):
        while True:
            out = np.empty((self.height, self.width), np.uint8)
            if not self._lib.fp_y4m_next_gray(self._y, _u8p(out)):
                return
            yield out

    def frames_bgr(self):
        while True:
            out = np.empty((self.height, self.width, 3), np.uint8)
            if not self._lib.fp_y4m_next_bgr(self._y, _u8p(out)):
                return
            yield out

    def close(self):
        if self._y:
            self._lib.fp_y4m_close(self._y)
            self._y = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
