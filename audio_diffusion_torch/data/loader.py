"""Training data pipeline: native WAV decode + threaded prefetch batching
(counterpart of audio_diffusion_tpu/data/loader.py).

The host-side input path is native C++ (``data/wavio.cpp``, a ctypes ABI):
WAV decoding and random-crop batch assembly run off the GIL in a worker
thread, double-buffered so host input processing overlaps device compute.

The shared library is compiled by ``g++`` at first use (never at import)
into ``audio_diffusion_torch/_build/``, under a name that carries a hash of
the source, so an edited source builds anew; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["AudioDataset", "wav_probe", "wav_probe_ex", "wav_read",
           "wav_write"]

_SRC = Path(__file__).resolve().parent / "wavio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_CXX_FLAGS = ["-O3", "-Wall", "-fPIC", "-std=c++17", "-shared"]
_LIB = None
_LIB_LOCK = threading.Lock()


def _signature(lib, name, restype, *argtypes) -> None:
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = list(argtypes)


def _load_lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        digest = hashlib.sha256(
            _SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()
        ).hexdigest()[:16]
        so = _BUILD_DIR / f"libwavio-{digest}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Compile to a private name and rename: os.replace is atomic, so
            # a concurrent process never loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    ["g++", *_CXX_FLAGS, "-o", tmp, str(_SRC)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed on {_SRC.name}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(str(so))
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(
            ctypes.c_int64)
        f32p, i16p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
            ctypes.c_int16)
        paths = ctypes.POINTER(ctypes.c_char_p)
        c_int, c_i32, c_i64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64
        _signature(lib, "wav_probe", c_int, ctypes.c_char_p, i32p, i32p, i64p)
        _signature(lib, "wav_read", c_int, ctypes.c_char_p, c_i64, c_i64,
                   f32p)
        _signature(lib, "wav_read_batch", c_int, paths, i64p, c_i32, c_i32,
                   c_i64, f32p)
        _signature(lib, "wav_probe_ex", c_int, ctypes.c_char_p, i32p, i32p,
                   i64p, i32p, i32p)
        _signature(lib, "wav_read_batch_i16", c_int, paths, i64p, c_i32,
                   c_i32, c_i64, i16p)
        _signature(lib, "wav_write", c_int, ctypes.c_char_p, f32p, c_i32,
                   c_i64, c_i32, c_i32)
        _LIB = lib
        return lib


def wav_probe(path: str | os.PathLike) -> tuple[int, int, int]:
    """Return (channels, sample_rate, frames) of a WAV file."""
    return wav_probe_ex(path)[:3]


def wav_probe_ex(path: str | os.PathLike) -> tuple[int, int, int, int, int]:
    """Return (channels, sample_rate, frames, bits, format) of a WAV file.

    format is the WAVE tag: 1 = PCM, 3 = IEEE float. (bits=16, format=1)
    identifies files eligible for the lossless int16 passthrough path.
    """
    lib = _load_lib()
    c, sr, bits, fmt = (ctypes.c_int32() for _ in range(4))
    n = ctypes.c_int64()
    err = lib.wav_probe_ex(str(path).encode(), ctypes.byref(c),
                           ctypes.byref(sr), ctypes.byref(n),
                           ctypes.byref(bits), ctypes.byref(fmt))
    if err != 0:
        raise IOError(f"wav_probe_ex({path}) failed with code {err}")
    return c.value, sr.value, n.value, bits.value, fmt.value


def wav_read(path: str | os.PathLike, start: int = 0,
             num_frames: Optional[int] = None) -> np.ndarray:
    """Decode [start, start+num_frames) to planar float32 [channels, frames]."""
    lib = _load_lib()
    channels, _sr, total = wav_probe(path)
    if num_frames is None:
        num_frames = total - start
    out = np.empty((channels, num_frames), np.float32)
    err = lib.wav_read(str(path).encode(), start, num_frames,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if err != 0:
        raise IOError(f"wav_read({path}) failed with code {err}")
    return out


def wav_write(path: str | os.PathLike, data, sample_rate: int,
              bits: int = 16) -> None:
    """Write planar float32 [channels, frames] (or [frames]) as a WAV file.

    bits=16 writes PCM16 (values clipped to [-1, 1]); bits=32 writes IEEE
    float.
    """
    lib = _load_lib()
    arr = np.ascontiguousarray(np.asarray(data, np.float32))
    if arr.ndim == 1:
        arr = arr[None]
    assert arr.ndim == 2, f"expected [channels, frames], got {arr.shape}"
    channels, frames = arr.shape
    err = lib.wav_write(str(path).encode(),
                        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        channels, frames, sample_rate, bits)
    if err != 0:
        raise IOError(f"wav_write({path}) failed with code {err}")


def read_batch(files: Sequence[Path], starts: np.ndarray, channels: int,
               frames: int, dtype: np.dtype) -> np.ndarray:
    """Crops [len(files), channels, frames] at ``starts`` through the native
    batch reader: int16 (a lossless copy of PCM16 samples) or float32."""
    lib = _load_lib()
    b = len(files)
    starts = np.ascontiguousarray(starts, np.int64)
    paths = (ctypes.c_char_p * b)(*[str(f).encode() for f in files])
    out = np.empty((b, channels, frames), dtype)
    p_starts = starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    if out.dtype == np.int16:
        err = lib.wav_read_batch_i16(
            paths, p_starts, b, channels, frames,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    else:
        err = lib.wav_read_batch(
            paths, p_starts, b, channels, frames,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if err != 0:
        raise IOError(f"wav_read_batch failed with code {err}")
    return out


def _hosts(host_id: Optional[int], num_hosts: Optional[int]):
    """Fill in a missing host index or count from ``torch.distributed``
    when it is initialized, else 0 and 1."""
    import torch.distributed as dist

    ready = dist.is_available() and dist.is_initialized()
    if host_id is None:
        host_id = dist.get_rank() if ready else 0
    if num_hosts is None:
        num_hosts = dist.get_world_size() if ready else 1
    return host_id, num_hosts


class AudioDataset:
    """Random-crop batches from a directory (or list) of WAV files.

    Iterating yields [batch, channels, crop_frames] numpy arrays; the next
    batch is assembled by the native decoder in a background thread while
    the current one is being consumed (double buffering).

    dtype selects the batch element type:

    - "float32": decoded floats in [-1, 1] (the classic path).
    - "int16": raw PCM16 samples — for PCM16 corpora this is a LOSSLESS
      bit copy, and the host->device upload shrinks 2x against float32. The
      train step dequantizes x/32768 on the device, reproducing the float32
      path's values bit-exactly for PCM16 sources (wider formats are
      quantized at decode).
    - "auto" (default): int16 iff every usable file is PCM16 (lossless),
      else float32.

    For a seed and a file list it yields the same batches, bit for bit, as
    the JAX package's ``AudioDataset`` (both draw with numpy's
    ``default_rng``).
    """

    def __init__(
        self,
        source: str | os.PathLike | Sequence[str | os.PathLike],
        crop_frames: int,
        batch_size: int,
        channels: Optional[int] = None,
        seed: int = 0,
        prefetch: int = 2,
        host_id: Optional[int] = None,
        num_hosts: Optional[int] = None,
        dtype: str = "auto",
        return_indices: bool = False,
    ):
        """host_id/num_hosts: multi-host sharding — each host reads a
        disjoint stride of the file list. When one is given and the other
        is None, the missing one comes from ``torch.distributed`` (rank,
        world size) when it is initialized, else 0 and 1; both None = no
        sharding."""
        if isinstance(source, (str, os.PathLike)):
            files: List[Path] = sorted(Path(source).rglob("*.wav"))
        else:
            files = [Path(p) for p in source]
        if not files:
            raise ValueError("no .wav files found")

        global_rate: Optional[int] = None
        if host_id is not None or num_hosts is not None:
            host_id, num_hosts = _hosts(host_id, num_hosts)
            # Resolve channel count AND sample rate from the GLOBAL first
            # decodable file before sharding: per-shard inference could
            # give hosts different values (mixed mono/stereo or mixed-rate
            # sets) and thus mismatched batch shapes across hosts.
            for f in files:
                try:
                    c0, sr0, _ = wav_probe(f)
                except IOError:
                    continue  # undecodable; skipped below anyway
                channels = channels if channels is not None else c0
                global_rate = sr0
                break
            files = files[host_id::num_hosts] or files  # tiny sets: share
            seed = seed * max(num_hosts, 1) + host_id  # decorrelated crops

        self.crop_frames = crop_frames
        self.batch_size = batch_size
        self.return_indices = return_indices
        self._rng = np.random.default_rng(seed)
        self._prefetch = prefetch

        # Probe once; keep files long enough for a crop with matching
        # channel count.
        self.files: List[Path] = []
        self.frames: List[int] = []
        self.channels = channels
        self.sample_rate: Optional[int] = global_rate
        skipped = mismatched = too_short = rate_mismatched = 0
        all_pcm16 = True
        for f in files:
            try:
                c, sr, n, bits, fmt = wav_probe_ex(f)
            except IOError:
                skipped += 1  # undecodable (ADPCM/a-law/...) or corrupt
                continue
            if self.channels is None:
                self.channels = c
            if self.sample_rate is None:
                self.sample_rate = sr
            if c != self.channels:
                mismatched += 1  # e.g. mono file in a stereo corpus
            elif sr != self.sample_rate:
                # Training reads raw frames: a 44.1k file in a 48k corpus
                # would train pitch-shifted. Skip it loudly instead.
                rate_mismatched += 1
            elif n < crop_frames:
                too_short += 1
            else:
                self.files.append(f)
                self.frames.append(n)
                all_pcm16 &= (fmt == 1 and bits == 16)
        self.all_pcm16 = all_pcm16 and bool(self.files)
        assert dtype in ("auto", "float32", "int16"), (
            f"dtype must be auto|float32|int16, got {dtype!r}")
        self.dtype = np.dtype(
            np.int16 if (dtype == "int16"
                         or (dtype == "auto" and self.all_pcm16))
            else np.float32)
        self.skipped_undecodable = skipped
        self.skipped_channel_mismatch = mismatched
        self.skipped_rate_mismatch = rate_mismatched
        self.skipped_too_short = too_short
        if skipped or mismatched or too_short or rate_mismatched:
            reasons = []
            if skipped:
                reasons.append(f"{skipped} undecodable (unsupported format "
                               "or corrupt header)")
            if mismatched:
                reasons.append(f"{mismatched} channel-mismatched (expected "
                               f"{self.channels} channels — a mixed "
                               "mono/stereo corpus trains on a subset; pass "
                               "channels= to pick which)")
            if rate_mismatched:
                reasons.append(
                    f"{rate_mismatched} sample-rate-mismatched (expected "
                    f"{self.sample_rate} Hz — training reads raw frames, "
                    "so a mixed-rate corpus would train pitch-shifted; "
                    "resample offline, e.g. dsp.resample)")
            if too_short:
                reasons.append(f"{too_short} shorter than crop_frames="
                               f"{crop_frames}")
            warnings.warn("AudioDataset skipped " + "; ".join(reasons),
                          stacklevel=2)
        if not self.files:
            raise ValueError(
                f"no usable files (need ≥{crop_frames} frames, "
                f"{self.channels} channels)")

    def _make_batch(self, rng: np.random.Generator):
        b, t = self.batch_size, self.crop_frames
        idx = rng.integers(0, len(self.files), b)
        starts = np.array(
            [rng.integers(0, self.frames[i] - t + 1) for i in idx],
            np.int64)
        out = read_batch([self.files[i] for i in idx], starts,
                         self.channels, t, self.dtype)
        # return_indices: yield (batch, file_indices) so callers can pair
        # per-FILE metadata with each crop — e.g. a precomputed text-
        # embedding table indexed by file (Trainer.fit accepts (x, cond)
        # batches).
        return (out, idx.astype(np.int64)) if self.return_indices else out

    def __iter__(self) -> Iterator[np.ndarray]:
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        # Each iterator's worker gets its OWN generator (numpy Generators
        # are not thread-safe). Seeds derive from the dataset RNG, so
        # iteration order stays deterministic for a fixed construction seed.
        rng = np.random.default_rng(self._rng.integers(0, 2**63))

        def worker():
            try:
                while not stop.is_set():
                    q.put(self._make_batch(rng))
            except Exception as e:  # surface in consumer
                q.put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:  # unblock the producer
                q.get_nowait()
            except queue.Empty:
                pass
