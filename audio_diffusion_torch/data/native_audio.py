"""ctypes bindings for the native audio I/O libraries (a copy of
``audio_diffusion_tpu/data/native_audio.py``).

``native/audioio.cpp`` is the multithreaded WAV decode + polyphase resample;
``native/mediadec.cpp`` decodes mp3/m4a through the system libav stack. They
build on demand with ``make -C native`` (g++; the media library also needs
the libav development files) into the repository's ``native/`` directory.
This is the host's decoder, not a device kernel, and every entry point
returns None when its library cannot be built or loaded, so
:mod:`..ops.audio_io` falls back to scipy (WAV) or an ``ffmpeg`` binary.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger("audio_diffusion_torch.native")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libadtaudio.so"))
_lib = None
_tried = False


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            # Build ONLY the dependency-free WAV library: the default `all`
            # target also builds libadtmedia.so, which fails without the
            # libav dev stack and would disable this decoder too.
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR), "libadtaudio.so"],
                           capture_output=True, check=True, timeout=120)
        except Exception as e:
            logger.info("native audio library unavailable (%s); using Python fallback", e)
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        logger.info("failed to load %s: %s", _LIB_PATH, e)
        return None

    lib.adt_load_wav.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                 ctypes.POINTER(ctypes.c_int64)]
    lib.adt_load_wav.restype = ctypes.c_int
    lib.adt_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.adt_load_batch.restype = ctypes.c_int
    lib.adt_resample.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                 ctypes.POINTER(ctypes.c_int64)]
    lib.adt_resample.restype = ctypes.c_int
    lib.adt_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load_library() is not None


def _take(lib, ptr, n: int) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.adt_free(ptr)
    return arr


def load_wav(path: str, target_sr: int) -> Optional[np.ndarray]:
    """Decode one WAV to mono float32 at target_sr, or None if unavailable/failed."""
    lib = _load_library()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    if lib.adt_load_wav(path.encode(), target_sr, ctypes.byref(out), ctypes.byref(n)) != 0:
        return None
    return _take(lib, out, n.value)


def load_batch(paths: Sequence[str], target_sr: int, n_threads: int = 0) -> List[Optional[np.ndarray]]:
    """Decode many WAVs in parallel; None entries mark failed files."""
    lib = _load_library()
    if lib is None:
        return [load_wav(p, target_sr) for p in paths]
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_int64 * n)()
    lib.adt_load_batch(c_paths, n, target_sr, outs, lens, n_threads)
    result: List[Optional[np.ndarray]] = []
    for i in range(n):
        if lens[i] < 0 or not outs[i]:
            result.append(None)
        else:
            result.append(_take(lib, outs[i], lens[i]))
    return result


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> Optional[np.ndarray]:
    lib = _load_library()
    if lib is None or orig_sr == target_sr:
        return None if lib is None else np.asarray(audio, dtype=np.float32)
    g = int(np.gcd(orig_sr, target_sr))
    x = np.ascontiguousarray(audio, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.adt_resample(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
                          target_sr // g, orig_sr // g, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        return None
    return _take(lib, out, n.value)


# ------------------------------------------------------- compressed formats

_MEDIA_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libadtmedia.so"))
_media_lib = None
_media_tried = False


def _load_media_library() -> Optional[ctypes.CDLL]:
    """native/mediadec.cpp: demux+decode+downmix+resample through the system
    libavformat/libavcodec stack (the reference's audioread backend, done
    natively). Built best-effort; None when the codec stack is absent."""
    global _media_lib, _media_tried
    if _media_lib is not None or _media_tried:
        return _media_lib
    _media_tried = True
    if not os.path.exists(_MEDIA_LIB_PATH):
        try:
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR), "libadtmedia.so"],
                           capture_output=True, check=True, timeout=120)
        except Exception as e:
            logger.warning("native media decoder unavailable (%s); "
                           "mp3/m4a decode will need an ffmpeg binary", e)
            return None
    try:
        lib = ctypes.CDLL(_MEDIA_LIB_PATH)
    except OSError as e:
        logger.warning("failed to load %s (%s); mp3/m4a decode will need an "
                       "ffmpeg binary", _MEDIA_LIB_PATH, e)
        return None
    lib.adt_decode_media.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.adt_decode_media.restype = ctypes.c_int
    lib.adt_media_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    _media_lib = lib
    return _media_lib


def media_available() -> bool:
    return _load_media_library() is not None


def load_media(path: str, target_sr: int) -> Optional[np.ndarray]:
    """Decode any libav-supported file (mp3/m4a/ogg/flac/wav/...) to mono
    float32 at target_sr. None when the codec stack is unavailable; raises
    ValueError for an undecodable file (distinguishing 'no backend' from
    'bad file', like audioread)."""
    lib = _load_media_library()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    errbuf = ctypes.create_string_buffer(256)
    rc = lib.adt_decode_media(path.encode(), target_sr, ctypes.byref(out),
                              ctypes.byref(n), errbuf, len(errbuf))
    if rc != 0:
        raise ValueError(f"cannot decode {path!r}: {errbuf.value.decode(errors='replace')}")
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.adt_media_free(out)
    return arr


def encode_media(path: str, audio: np.ndarray, sample_rate: int,
                 codec: Optional[str] = None) -> bool:
    """Encode mono float PCM to .m4a (aac) / .mp3 (libmp3lame) / other
    libav-supported formats. Test/tooling surface (fixture generation and
    decoder roundtrip gates); returns False when the codec stack is absent."""
    lib = _load_media_library()
    if lib is None:
        return False
    if not hasattr(lib, "_encode_configured"):
        lib.adt_encode_media.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.adt_encode_media.restype = ctypes.c_int
        lib._encode_configured = True
    if codec is None:
        ext = os.path.splitext(path)[1].lower()
        codec = {".m4a": "aac", ".mp4": "aac", ".mp3": "libmp3lame",
                 ".flac": "flac", ".ogg": "libvorbis"}.get(ext, "aac")
    x = np.ascontiguousarray(audio, dtype=np.float32)
    errbuf = ctypes.create_string_buffer(256)
    rc = lib.adt_encode_media(path.encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              len(x), sample_rate, codec.encode(), errbuf, len(errbuf))
    if rc != 0:
        raise ValueError(f"cannot encode {path!r}: {errbuf.value.decode(errors='replace')}")
    return True
