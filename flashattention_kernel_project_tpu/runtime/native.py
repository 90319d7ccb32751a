"""ctypes bindings for the native C++ oracle library (runtime/oracle.cpp).

Compiles the library on first use (see build_library); falls back to the
numpy oracles in utils.oracles when no compiler is available, so the API is
always usable. Mirrors the reference's C++ CPU-oracle layer (SURVEY.md
section 4.1) with a python surface identical to utils.oracles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from flashattention_kernel_project_tpu.utils import oracles as np_oracles

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "oracle.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "native")


def build_library(src: str) -> str | None:
    """Compile `src` into a shared library under the checkout's gitignored
    build/native/, named by a hash of the source, and return its path
    (None without a C++ compiler). A changed source gets a new name, so a
    stale library is never loaded; a library copied with the tree is never
    trusted."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(_BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", src,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    os.replace(tmp, so)  # atomic: concurrent builders race harmlessly
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build_library(_SRC)
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
        ptr = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.gemm_f32.argtypes = [ptr, ptr, ptr, i64, i64, i64]
        lib.softmax_f32.argtypes = [ptr, ptr, i64, i64]
        lib.gqa_attention_f32.argtypes = [
            ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, f32, i32, i64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None or a.ndim != 2:
        return np_oracles.gemm(a, b)
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    m, k = a.shape
    n = b.shape[1]
    c = np.empty((m, n), np.float32)
    lib.gemm_f32(a, b, c, m, k, n)
    return c


def softmax(x: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        return np_oracles.softmax(x)
    x2 = np.ascontiguousarray(x, np.float32).reshape(-1, x.shape[-1])
    y = np.empty_like(x2)
    lib.softmax_f32(x2, y, x2.shape[0], x2.shape[1])
    return y.reshape(x.shape)


def gqa_attention(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    scale: float | None = None,
    causal: bool = False,
    q_offset: int = 0,
) -> np.ndarray:
    lib = _load()
    if lib is None:
        return np_oracles.gqa_attention(
            q, k, v, scale=scale, causal=causal, q_offset=q_offset
        )
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    q = np.ascontiguousarray(q, np.float32)
    k = np.ascontiguousarray(k, np.float32)
    v = np.ascontiguousarray(v, np.float32)
    o = np.empty((b, hq, n, d), np.float32)
    lib.gqa_attention_f32(
        q, k, v, o, b, hq, hkv, n, s, d, float(scale), int(causal), q_offset
    )
    return o


# ---------------------------------------------------------------------------
# Native continuous-batching scheduler core (runtime/scheduler.cpp)
# ---------------------------------------------------------------------------

_SCHED_SRC = os.path.join(_DIR, "scheduler.cpp")
_sched_lib = None
_sched_tried = False


def _load_scheduler():
    global _sched_lib, _sched_tried
    with _lock:
        if _sched_lib is not None or _sched_tried:
            return _sched_lib
        _sched_tried = True
        so = build_library(_SCHED_SRC)
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
        lib.cbs_create.restype = vp
        lib.cbs_create.argtypes = [i32, i32, i32]
        lib.cbs_destroy.argtypes = [vp]
        lib.cbs_bucket.restype = i32
        lib.cbs_bucket.argtypes = [vp, i32]
        lib.cbs_submit.restype = i64
        lib.cbs_submit.argtypes = [vp, i32, i32]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.cbs_fill.restype = i32
        lib.cbs_fill.argtypes = [vp, i64p, i32p, i32p, i32]
        lib.cbs_on_token.restype = i32
        lib.cbs_on_token.argtypes = [vp, i32, i32, i32]
        lib.cbs_active.restype = i32
        lib.cbs_active.argtypes = [vp]
        lib.cbs_pending.restype = i32
        lib.cbs_pending.argtypes = [vp]
        lib.cbs_slot_uid.restype = i64
        lib.cbs_slot_uid.argtypes = [vp, i32]
        lib.cbs_cancel.restype = i32
        lib.cbs_cancel.argtypes = [vp, i64]
        _sched_lib = lib
        return _sched_lib


def scheduler_available() -> bool:
    return _load_scheduler() is not None


class BatchSchedulerCore:
    """Continuous-batching bookkeeping: request admission, slot allocation,
    per-slot budget/EOS tracking, prompt-length bucketing. Backed by the
    native C++ core when g++ is available, else a behavior-identical pure
    Python fallback — models/serving.py delegates all decisions here so
    native and Python schedules can never diverge."""

    def __init__(self, n_slots: int, max_len: int, granule: int = 64):
        self.n_slots = n_slots
        self.max_len = max_len
        self.granule = granule
        self._lib = _load_scheduler()
        if self._lib is not None:
            self._h = ctypes.c_void_p(
                self._lib.cbs_create(n_slots, max_len, granule)
            )
        else:  # pure-python fallback: same state machine
            self._slots = [None] * n_slots  # (uid, generated, max_new)
            self._pending = []
            self._next_uid = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.cbs_destroy(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._lib is not None

    def bucket(self, n: int) -> int:
        if self._lib is not None:
            return int(self._lib.cbs_bucket(self._h, n))
        b = max(self.granule, -(-n // self.granule) * self.granule)
        return min(b, self.max_len)

    def submit(self, prompt_len: int, max_new: int) -> int:
        """Queue a request; returns uid or -1 if it can never fit."""
        if self._lib is not None:
            return int(self._lib.cbs_submit(self._h, prompt_len, max_new))
        if prompt_len + max_new > self.max_len:
            return -1
        uid = self._next_uid
        self._next_uid += 1
        self._pending.append((uid, prompt_len, max_new))
        return uid

    def fill(self) -> list[tuple[int, int, int]]:
        """Admit pending requests into free slots (FIFO).
        Returns [(uid, slot, prompt_bucket), ...]."""
        if self._lib is not None:
            cap = self.n_slots
            uids = np.empty(cap, np.int64)
            slots = np.empty(cap, np.int32)
            buckets = np.empty(cap, np.int32)
            n = int(self._lib.cbs_fill(self._h, uids, slots, buckets, cap))
            return [
                (int(uids[i]), int(slots[i]), int(buckets[i]))
                for i in range(n)
            ]
        out = []
        for i in range(self.n_slots):
            if not self._pending:
                break
            if self._slots[i] is not None:
                continue
            uid, plen, max_new = self._pending.pop(0)
            self._slots[i] = [uid, 0, max_new]
            out.append((uid, i, self.bucket(plen)))
        return out

    def on_token(self, slot: int, token: int, eos: int = -1) -> bool:
        """Record a generated token; True (and the slot is freed) when the
        request just finished (budget exhausted or EOS)."""
        if self._lib is not None:
            return bool(self._lib.cbs_on_token(self._h, slot, token, eos))
        s = self._slots[slot]
        if s is None:
            return False
        s[1] += 1
        done = s[1] >= s[2] or (eos >= 0 and token == eos)
        if done:
            self._slots[slot] = None
        return done

    def active(self) -> int:
        if self._lib is not None:
            return int(self._lib.cbs_active(self._h))
        return sum(s is not None for s in self._slots)

    def pending(self) -> int:
        if self._lib is not None:
            return int(self._lib.cbs_pending(self._h))
        return len(self._pending)

    def slot_uid(self, slot: int) -> int:
        if self._lib is not None:
            return int(self._lib.cbs_slot_uid(self._h, slot))
        s = self._slots[slot]
        return -1 if s is None else s[0]

    def cancel(self, uid: int) -> int:
        """Cancel a request: 1 = removed from the pending queue, 2 =
        evicted from its slot (caller frees device state), 0 = unknown."""
        if self._lib is not None:
            return int(self._lib.cbs_cancel(self._h, uid))
        for i, p in enumerate(self._pending):
            if p[0] == uid:
                self._pending.pop(i)
                return 1
        for i, s in enumerate(self._slots):
            if s is not None and s[0] == uid:
                self._slots[i] = None
                return 2
        return 0
