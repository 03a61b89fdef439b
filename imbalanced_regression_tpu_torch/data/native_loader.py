"""ctypes binding of the native batch JPEG loader (``native/loader.cc``).

The port's counterpart of the JAX package's ``data/native_loader.py``: the
same C++ source, unchanged, built with the same ``g++`` command (``-O3
-march=native``, system libjpeg) at first use, into the port's git-ignored
``imbalanced_regression_tpu_torch/build/``. The library is written under a
temporary name and moved into place with ``os.replace``, so a process that
loads it never reads a half-written file while another one builds it.

An image the native decoder rejects (a PNG, a truncated file), or every
image where the library cannot be built (no compiler or no libjpeg), is
decoded with PIL where PIL is importable, each file as the JAX package
decodes it (``convert("RGB")``, bilinear ``resize``), on the loader's
threads (PIL releases the interpreter lock for parts of the work: on an
8-core host, 8 threads loaded a 16,488-file corpus 2.4x faster than one);
where PIL is not importable, the call raises and names the files. No slot
is ever returned zeroed.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "loader.cc"
BUILD_DIR = PACKAGE_DIR / "build"
LIBRARY = BUILD_DIR / "libdirloader.so"

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> None:
    """Compile ``native/loader.cc`` into :data:`LIBRARY` (via a temporary
    file in the same directory and ``os.replace``). Raises
    ``RuntimeError`` with the compiler's message on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libdirloader.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, str(SOURCE), "-ljpeg", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, LIBRARY)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed: {e.stderr.strip()[-500:]}") from e
    except FileNotFoundError as e:
        raise RuntimeError(f"no compiler: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library (built if missing or older than its
    source), or None when it cannot be built or loaded; :func:`build_error`
    then says why."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            logger.warning("native JPEG loader unavailable: %s", _build_error)
            return None
        lib.decode_resize_batch.restype = ctypes.c_int
        lib.decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
    return _lib


def build_error() -> str | None:
    """Why the native library is unavailable (None if it loaded or was not
    asked for yet)."""
    return _build_error


def _pil_decode(paths: list[str], img_size: int, why: str, threads: int) -> np.ndarray:
    """Decode ``paths`` with PIL (RGB, bilinear resize) on ``threads``
    threads, each file as the JAX package's fallback decodes it; raises
    naming the files where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        shown = ", ".join(paths[:5]) + (f" and {len(paths) - 5} more" if len(paths) > 5 else "")
        raise RuntimeError(f"cannot decode {len(paths)} image(s) ({why}) and PIL is not "
                           f"installed: {shown}") from None
    out = np.empty((len(paths), img_size, img_size, 3), np.uint8)

    def decode(i: int) -> None:
        with Image.open(paths[i]) as img:
            out[i] = np.asarray(img.convert("RGB").resize((img_size, img_size), Image.BILINEAR),
                                dtype=np.uint8)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for _ in pool.map(decode, range(len(paths))):  # re-raises a file's error
            pass
    return out


def decode_resize_batch(paths: list[str], img_size: int, threads: int | None = None) -> np.ndarray:
    """Decode and resize image files to a uint8 [N, S, S, 3] RGB batch.

    The native multithreaded libjpeg path decodes what it can (``threads``
    workers, default ``min(8, cpu count)``); the rest goes through PIL (see
    the module docstring)."""
    n = len(paths)
    out = np.zeros((n, img_size, img_size, 3), np.uint8)
    if n == 0:
        return out
    threads = threads or min(8, max(1, os.cpu_count() or 1))
    lib = get_lib()
    if lib is None:
        return _pil_decode(list(paths), img_size, f"native loader unavailable: {_build_error}",
                           threads)
    status = np.zeros(n, np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.decode_resize_batch(
        c_paths, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        img_size, img_size, threads,
    )
    rejected = np.flatnonzero(status == 0)
    if rejected.size:
        out[rejected] = _pil_decode([paths[i] for i in rejected], img_size,
                                    "the native decoder rejected them", threads)
    return out
