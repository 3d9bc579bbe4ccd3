"""ctypes binding for the native region timer (port of
``native/regiontimer.py``; ``regiontimer.cpp``): nested regions with
call-tree paths (``train/train_step``), per-path counts and totals, a text
summary and a chrome-trace export. The ``native`` backend of
``hydragnn_tpu_torch.utils.tracer``."""

import ctypes

from hydragnn_tpu_torch.native.build import load_library

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("regiontimer", ["regiontimer.cpp"])
    lib.rt_create.restype = ctypes.c_void_p
    lib.rt_destroy.argtypes = [ctypes.c_void_p]
    lib.rt_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_stop.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_reset.argtypes = [ctypes.c_void_p]
    lib.rt_print.restype = ctypes.c_int
    lib.rt_print.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_chrome.restype = ctypes.c_int
    lib.rt_chrome.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rt_count.restype = ctypes.c_uint64
    lib.rt_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_totals.restype = ctypes.c_int
    lib.rt_totals.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rt_total.restype = ctypes.c_double
    lib.rt_total.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _lib = lib
    return lib


class NativeRegionTimer:
    """Nested region timer with call-tree stats and chrome-trace export."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.rt_create()

    def start(self, name: str):
        self._lib.rt_start(self._h, name.encode())

    def stop(self, name: str):
        self._lib.rt_stop(self._h, name.encode())

    def reset(self):
        self._lib.rt_reset(self._h)

    def pr_file(self, filename: str):
        import os

        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        self._lib.rt_print(self._h, filename.encode())

    def chrome_trace(self, filename: str, pid: int = 0):
        import os

        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        self._lib.rt_chrome(self._h, filename.encode(), pid)

    def count(self, path: str) -> int:
        return int(self._lib.rt_count(self._h, path.encode()))

    def total(self, path: str) -> float:
        return float(self._lib.rt_total(self._h, path.encode()))

    def totals(self) -> dict:
        """{region path: accumulated seconds} for every region — the
        telemetry layer's end-of-run region forwarding reads this."""
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.rt_totals(self._h, buf, cap)
            if n >= 0:
                break
            cap = -n
        out = {}
        for line in buf.value.decode().splitlines():
            if "\t" in line:
                path, tot = line.rsplit("\t", 1)
                out[path] = float(tot)
        return out

    def __del__(self):
        try:
            if self._h:
                self._lib.rt_destroy(self._h)
                self._h = None
        except Exception:
            pass
