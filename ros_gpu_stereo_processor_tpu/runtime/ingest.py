"""Frame-ingest runtime: ctypes bindings to the native C++ ring/pairer.

The reference's ingest path — message_filters synchronizers feeding pinned
``HostMem`` staging buffers (SURVEY.md §2.4/§2.16) — is C++; so is ours:
``native/frame_ring.cpp`` provides

  * :class:`FrameRing` — fixed-capacity staging ring with drop-on-overflow
    (the ``queue_size`` semantics) and **zero-copy consumption**: ``peek()``
    returns numpy views into the ring slot, which feed ``jax.device_put``
    directly; ``release()`` recycles the slot;
  * :class:`StereoPairer` — Exact/ApproximateTime timestamp pairing in
    native code (producer threads never hold the GIL);
  * :class:`StreamingIngest` — pairer→ring composition plus a device
    double-buffer: ``frames()`` yields device arrays while the next pair
    stages (the ≥2-frames-in-flight streaming called for by SURVEY.md §7).

The library auto-builds on first use (g++ via the Makefile) and falls back to
a pure-Python implementation with the same API if a toolchain is missing.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from collections import deque
from typing import Iterator, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libframe_ring.so")

_lib = None
_lib_err: Optional[str] = None


def _load_lib():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True, capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(os.path.abspath(_LIB_PATH))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_size_t
        lib.ring_size.argtypes = [ctypes.c_void_p]
        for f in ("ring_pushed", "ring_popped", "ring_dropped"):
            getattr(lib, f).restype = ctypes.c_uint64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, u8p, u8p, ctypes.c_double,
                                  ctypes.c_uint64, ctypes.c_double]
        lib.ring_peek.restype = ctypes.c_int
        lib.ring_peek.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p),
                                  ctypes.POINTER(u8p),
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.c_double]
        lib.ring_release.argtypes = [ctypes.c_void_p]
        lib.ring_pop.restype = ctypes.c_int
        lib.ring_pop.argtypes = [ctypes.c_void_p, u8p, u8p,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.c_double]
        lib.pairer_create.restype = ctypes.c_void_p
        lib.pairer_create.argtypes = [ctypes.c_double, ctypes.c_int,
                                      ctypes.c_size_t, ctypes.c_size_t]
        lib.pairer_destroy.argtypes = [ctypes.c_void_p]
        lib.pairer_add.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p,
                                   ctypes.c_double]
        lib.pairer_get.restype = ctypes.c_int
        lib.pairer_get.argtypes = [ctypes.c_void_p, u8p, u8p,
                                   ctypes.POINTER(ctypes.c_double)]
        for f in ("pairer_paired", "pairer_dropped"):
            getattr(lib, f).restype = ctypes.c_uint64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:  # toolchain missing → python fallback
        _lib_err = str(e)
        _lib = None
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class FrameRing:
    """Fixed-capacity stereo staging ring (native when possible)."""

    def __init__(self, capacity: int, shape: Tuple[int, ...],
                 drop_on_full: bool = True):
        self.shape = tuple(shape)
        self.image_bytes = int(np.prod(shape))
        self.capacity = capacity
        self._lib = _load_lib()
        if self._lib is not None:
            self._h = self._lib.ring_create(capacity, self.image_bytes,
                                            1 if drop_on_full else 0)
            self._peeking = False
        else:
            self._q: deque = deque()
            self._drop_on_full = drop_on_full
            self._lock = threading.Lock()
            self._nonempty = threading.Condition(self._lock)
            self._stats = {"pushed": 0, "popped": 0, "dropped": 0}

    # -- producer -----------------------------------------------------------
    def push(self, left: np.ndarray, right: np.ndarray, stamp: float = 0.0,
             seq: int = 0, timeout: float = -1.0) -> bool:
        l = np.ascontiguousarray(left, dtype=np.uint8)
        r = np.ascontiguousarray(right, dtype=np.uint8)
        if self._lib is not None:
            return bool(self._lib.ring_push(self._h, _u8ptr(l), _u8ptr(r),
                                            stamp, seq, timeout))
        with self._nonempty:
            if len(self._q) >= self.capacity:
                if self._drop_on_full:
                    self._stats["dropped"] += 1
                    return False
                # blocking semantics (matches the native ring): wait for a slot
                ok = self._nonempty.wait_for(
                    lambda: len(self._q) < self.capacity,
                    None if timeout < 0 else timeout,
                )
                if not ok:
                    return False
            self._q.append((l.copy(), r.copy(), stamp, seq))
            self._stats["pushed"] += 1
            self._nonempty.notify()
            return True

    # -- consumer -----------------------------------------------------------
    def peek(self, timeout: float = -1.0):
        """Zero-copy view of the oldest pair: (left, right, stamp, seq) or
        None.  Call :meth:`release` when done with the views."""
        if self._lib is not None:
            assert not self._peeking, "peek/release must alternate"
            pl = ctypes.POINTER(ctypes.c_uint8)()
            pr = ctypes.POINTER(ctypes.c_uint8)()
            stamp = ctypes.c_double()
            seq = ctypes.c_uint64()
            ok = self._lib.ring_peek(self._h, ctypes.byref(pl), ctypes.byref(pr),
                                     ctypes.byref(stamp), ctypes.byref(seq),
                                     timeout)
            if not ok:
                return None
            self._peeking = True
            l = np.ctypeslib.as_array(pl, shape=(self.image_bytes,)).reshape(self.shape)
            r = np.ctypeslib.as_array(pr, shape=(self.image_bytes,)).reshape(self.shape)
            return l, r, stamp.value, seq.value
        with self._nonempty:
            if not self._q:
                if timeout == 0:
                    return None
                if not self._nonempty.wait_for(
                    lambda: bool(self._q), None if timeout < 0 else timeout
                ):
                    return None
            l, r, stamp, seq = self._q[0]
            return l.reshape(self.shape), r.reshape(self.shape), stamp, seq

    def release(self) -> None:
        if self._lib is not None:
            assert self._peeking
            self._lib.ring_release(self._h)
            self._peeking = False
        else:
            with self._nonempty:
                self._q.popleft()
                self._stats["popped"] += 1
                self._nonempty.notify_all()

    def pop(self, timeout: float = -1.0):
        """Copy-out consume: (left, right, stamp, seq) or None."""
        got = self.peek(timeout)
        if got is None:
            return None
        l, r, stamp, seq = got
        out = (l.copy(), r.copy(), stamp, seq)
        self.release()
        return out

    # -- stats (the reference's observability-by-log, SURVEY.md §5.5) -------
    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_size(self._h))
        return len(self._q)

    def stats(self) -> dict:
        if self._lib is not None:
            return {
                "pushed": int(self._lib.ring_pushed(self._h)),
                "popped": int(self._lib.ring_popped(self._h)),
                "dropped": int(self._lib.ring_dropped(self._h)),
            }
        return dict(self._stats)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None


class StereoPairer:
    """Exact/ApproximateTime stereo pairing (message_filters equivalent)."""

    def __init__(self, shape: Tuple[int, ...], exact: bool = True,
                 slop: float = 0.01, queue_size: int = 5):
        self.shape = tuple(shape)
        self.image_bytes = int(np.prod(shape))
        self._lib = _load_lib()
        if self._lib is not None:
            self._h = self._lib.pairer_create(slop, 1 if exact else 0,
                                              self.image_bytes, queue_size)
        else:
            self._exact = exact
            self._slop = slop
            self._queue_size = queue_size
            self._left: deque = deque()
            self._right: deque = deque()
            self._lock = threading.Lock()
            self._stats = {"paired": 0, "dropped": 0}

    def add(self, side: str, image: np.ndarray, stamp: float) -> None:
        img = np.ascontiguousarray(image, dtype=np.uint8)
        s = 0 if side == "left" else 1
        if self._lib is not None:
            self._lib.pairer_add(self._h, s, _u8ptr(img), stamp)
            return
        with self._lock:
            q = self._left if s == 0 else self._right
            q.append((img.copy(), stamp))
            if len(q) > self._queue_size:
                q.popleft()
                self._stats["dropped"] += 1

    def get(self):
        """(left, right, stamp) or None."""
        if self._lib is not None:
            l = np.empty(self.image_bytes, np.uint8)
            r = np.empty(self.image_bytes, np.uint8)
            stamp = ctypes.c_double()
            if not self._lib.pairer_get(self._h, _u8ptr(l), _u8ptr(r),
                                        ctypes.byref(stamp)):
                return None
            return l.reshape(self.shape), r.reshape(self.shape), stamp.value
        with self._lock:
            while self._left and self._right:
                tl = self._left[0][1]
                tr = self._right[0][1]
                match = tl == tr if self._exact else abs(tl - tr) <= self._slop
                if match:
                    if (not self._exact and len(self._right) > 1
                            and abs(self._right[1][1] - tl) < abs(tr - tl)):
                        self._right.popleft()
                        continue
                    l = self._left.popleft()[0]
                    r = self._right.popleft()[0]
                    self._stats["paired"] += 1
                    return l.reshape(self.shape), r.reshape(self.shape), tl
                if tl < tr:
                    self._left.popleft()
                else:
                    self._right.popleft()
                self._stats["dropped"] += 1
            return None

    def stats(self) -> dict:
        if self._lib is not None:
            return {
                "paired": int(self._lib.pairer_paired(self._h)),
                "dropped": int(self._lib.pairer_dropped(self._h)),
            }
        return dict(self._stats)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.pairer_destroy(self._h)
            self._h = None


class StreamingIngest:
    """Pairer → ring → device double-buffer.

    Producers call :meth:`feed`; the consumer iterates :meth:`frames`, which
    keeps one pair in flight on the device (async ``device_put`` from the
    ring's zero-copy views) while yielding the previous one.
    """

    def __init__(self, shape: Tuple[int, ...], capacity: int = 4,
                 exact: bool = True, slop: float = 0.01, queue_size: int = 5,
                 drop_on_full: bool = True):
        self.pairer = StereoPairer(shape, exact=exact, slop=slop,
                                   queue_size=queue_size)
        self.ring = FrameRing(capacity, shape, drop_on_full=drop_on_full)
        self._seq = 0

    def feed(self, side: str, image: np.ndarray, stamp: float) -> None:
        self.pairer.add(side, image, stamp)
        got = self.pairer.get()
        if got is not None:
            l, r, t = got
            self.ring.push(l, r, t, self._seq)
            self._seq += 1

    def frames(self, timeout: float = 0.0, zero_copy: bool = True) -> Iterator[tuple]:
        """Yield (left_dev, right_dev, stamp, seq) device-array frames until
        the ring drains (with ``timeout`` ≤ 0: non-blocking drain).

        ``zero_copy=True`` feeds ``device_put`` straight from the ring-slot
        views and must block before recycling the slot — lowest host overhead
        when the device is local.  ``zero_copy=False`` copies out of the slot
        and dispatches the put asynchronously (never blocks the consumer
        thread) — the right trade when host→device transfers have high
        latency and the pipeline hides it with frames in flight.
        """
        import jax

        pending = None
        while True:
            if zero_copy:
                got = self.ring.peek(timeout)
                if got is None:
                    if pending is not None:
                        yield pending
                    return
                l, r, stamp, seq = got
                dev = (jax.device_put(l), jax.device_put(r))
                # the put reads from the slot views; block before recycling
                jax.block_until_ready(dev)
                self.ring.release()
            else:
                got = self.ring.pop(timeout)
                if got is None:
                    if pending is not None:
                        yield pending
                    return
                l, r, stamp, seq = got
                dev = (jax.device_put(l), jax.device_put(r))
            nxt = (dev[0], dev[1], stamp, seq)
            if pending is not None:
                yield pending
            pending = nxt

    def frames_prefetch(self, timeout: float = 0.0,
                        depth: int = 3, stacked: bool = False) -> Iterator[tuple]:
        """Like :meth:`frames`, but host→device staging runs on a dedicated
        uploader thread, keeping up to ``depth`` frames in flight on the
        device while the consumer computes.

        Where ``jax.device_put`` blocks the calling thread for the transfer,
        :meth:`frames` serializes upload into the consumer's loop; this
        overlaps them — the form here of the reference's upload-on-stream
        overlap
        (src/StereoProcessor.cpp:179-180 enqueues uploads on per-side CUDA
        streams while the CPU thread keeps going).

        ``timeout`` is per-pop: the stream ends when the ring stays empty for
        ``timeout`` seconds (≤ 0: non-blocking drain).  The uploader copies
        out of the ring slot (never blocks producers on device transfers).

        ``stacked=True`` uploads each pair as ONE (2, H, W) ``device_put``
        and yields on-device row-0/row-1 slices: one put per pair instead of
        two saves a per-transfer overhead every frame; the slices are
        device-side ops, no extra link traffic.
        """
        import jax

        q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        stop = threading.Event()
        _END = object()

        def uploader():
            try:
                while not stop.is_set():
                    got = self.ring.pop(timeout)
                    if got is None:
                        break
                    l, r, stamp, seq = got
                    if stacked:
                        lr = jax.device_put(np.stack([l, r]))
                        item = (lr[0], lr[1], stamp, seq)
                    else:
                        item = (jax.device_put(l), jax.device_put(r), stamp, seq)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            finally:
                while True:
                    try:
                        q.put(_END, timeout=0.1)
                        return
                    except queue.Full:
                        if stop.is_set():
                            return

        t = threading.Thread(target=uploader, daemon=True,
                             name="ingest-uploader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
