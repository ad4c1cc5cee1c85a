"""The port's data pipeline (audio_diffusion_torch.data) against the JAX
package's (audio_diffusion_tpu.data), on the CPU, with WAVs synthesized
from numpy seeds in tmp_path.

Tolerances: none. Both packages run the same native decoder source, so
probes, decodes and the batches of ``AudioDataset`` (numpy's
``default_rng`` in both) must agree bit for bit. ``DeviceCorpus`` draws
from a torch generator, not JAX's threefry, so its tests hold the windows
(each crop is a window of a file, found by the value it encodes), purity in
the step, coverage of every file and of both end offsets, the memory guard
and the int16 dequantization (bit-equal to the float32 decode), not the
stream.
"""
import wave

import numpy as np
import pytest
import torch

from audio_diffusion_torch import data as port
from audio_diffusion_tpu import data as ref

torch.set_num_threads(2)


def write_pcm(path, data, sr=16000, width=2):
    """data [channels, frames] float32 in [-1, 1) as PCM of ``width`` bytes
    through Python's wave module."""
    scale = float(2 ** (8 * width - 1))
    pcm = np.clip(np.round(data.T.reshape(-1) * scale), -scale,
                  scale - 1).astype(np.int64)
    raw = b"".join(int(v).to_bytes(width, "little", signed=True)
                   for v in pcm)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(data.shape[0])
        f.setframerate(sr)
        f.setsampwidth(width)
        f.writeframes(raw)


def corpus(tmp_path, n_files=4, frames=700, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    d = tmp_path / "wavs"
    d.mkdir()
    for i in range(n_files):
        data = (rng.standard_normal((channels, frames + 37 * i)) * 0.3
                ).astype(np.float32)
        write_pcm(d / f"f{i}.wav", np.clip(data, -0.99, 0.99))
    return d


@pytest.mark.parametrize("fmt", ["pcm16", "pcm24", "pcm32", "float32"])
def test_probe_read_write_round_trip(tmp_path, fmt):
    """Each format probed and read by both packages, bit for bit; the
    port's writer read back by the JAX reader and the other way round."""
    rng = np.random.default_rng(3)
    data = np.clip(rng.standard_normal((2, 513)) * 0.4, -0.99,
                   0.99).astype(np.float32)
    p = tmp_path / f"{fmt}.wav"
    if fmt == "float32":
        port.wav_write(p, data, 22050, bits=32)
    else:
        write_pcm(p, data, 22050, width=int(fmt[3:]) // 8)
    assert port.wav_probe_ex(p) == ref.wav_probe_ex(p)
    assert port.wav_probe(p) == ref.wav_probe(p) == (2, 22050, 513)
    got = port.wav_read(p, start=17, num_frames=300)
    np.testing.assert_array_equal(got, ref.wav_read(p, 17, 300))
    if fmt == "float32":
        np.testing.assert_array_equal(port.wav_read(p), data)
    # Writers: the port's read by JAX, and back.
    for bits in (16, 32):
        a, b = tmp_path / f"port{bits}.wav", tmp_path / f"jax{bits}.wav"
        port.wav_write(a, data, 48000, bits=bits)
        ref.wav_write(b, data, 48000, bits=bits)
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(ref.wav_read(a), port.wav_read(b))
    with pytest.raises(IOError):
        port.wav_read(p, start=500, num_frames=20)


def test_skip_rules_and_warnings(tmp_path):
    """Undecodable, channel-, rate-mismatched and short files are skipped
    with the JAX package's counts and warning."""
    import struct

    d = tmp_path / "mixed"
    d.mkdir()
    rng = np.random.default_rng(4)
    write_pcm(d / "a_good.wav", rng.uniform(-.5, .5, (2, 600)))
    write_pcm(d / "b_good.wav", rng.uniform(-.5, .5, (2, 900)))
    write_pcm(d / "c_mono.wav", rng.uniform(-.5, .5, (1, 900)))
    write_pcm(d / "d_rate.wav", rng.uniform(-.5, .5, (2, 900)), sr=8000)
    write_pcm(d / "e_short.wav", rng.uniform(-.5, .5, (2, 100)))
    fmt = struct.pack("<HHIIHH", 17, 1, 16000, 8000, 1, 4)  # IMA ADPCM
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
            + struct.pack("<I", 64) + b"\x00" * 64)
    (d / "f_adpcm.wav").write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body))
                                    + b"WAVE" + body)
    with pytest.warns(UserWarning) as got:
        ds = port.AudioDataset(d, crop_frames=256, batch_size=2)
    with pytest.warns(UserWarning) as want:
        jds = ref.AudioDataset(d, crop_frames=256, batch_size=2)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert "1 undecodable" in str(got[0].message)
    for attr in ("files", "frames", "channels", "sample_rate", "dtype",
                 "skipped_undecodable", "skipped_channel_mismatch",
                 "skipped_rate_mismatch", "skipped_too_short", "all_pcm16"):
        assert getattr(ds, attr) == getattr(jds, attr), attr
    assert [f.name for f in ds.files] == ["a_good.wav", "b_good.wav"]
    with pytest.raises(ValueError, match="no usable files"):
        port.AudioDataset(d, crop_frames=5000, batch_size=1)
    with pytest.raises(AssertionError, match="auto|float32|int16"):
        port.AudioDataset(d, crop_frames=256, batch_size=1, dtype="int8")


@pytest.mark.parametrize("kwargs", [
    dict(), dict(dtype="float32"), dict(return_indices=True),
    dict(host_id=1, num_hosts=2)])
def test_audio_dataset_batches_match_jax(tmp_path, kwargs):
    """The same seed and files give the same batches, bit for bit (and the
    same file indices, and the same shard per host)."""
    d = corpus(tmp_path)
    ds = port.AudioDataset(d, crop_frames=256, batch_size=3, seed=7,
                           **kwargs)
    jds = ref.AudioDataset(d, crop_frames=256, batch_size=3, seed=7,
                           **kwargs)
    assert ds.files == jds.files and ds.dtype == jds.dtype
    for got, want in zip(_take(ds, 4), _take(jds, 4)):
        if kwargs.get("return_indices"):
            np.testing.assert_array_equal(got[1], want[1])
            got, want = got[0], want[0]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _take(ds, n):
    it = iter(ds)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def test_host_sharding_defaults(tmp_path):
    """A missing host index or count comes from torch.distributed when it
    is initialized, else 0 and 1: one host reads every file."""
    import torch.distributed as dist

    d = corpus(tmp_path, n_files=3)
    assert not dist.is_initialized()
    alone = port.AudioDataset(d, crop_frames=256, batch_size=2, host_id=0)
    assert len(alone.files) == 3
    parts = [port.AudioDataset(d, crop_frames=256, batch_size=2, host_id=i,
                               num_hosts=2).files for i in (0, 1)]
    assert set(parts[0]).isdisjoint(parts[1])
    assert len(parts[0]) + len(parts[1]) == 3


def position_corpus(tmp_path, n_files=3, frames=400, channels=2):
    """PCM16 files whose samples encode (file, position): value = file *
    1000 + position (+7 on the second channel)."""
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(n_files):
        data = np.stack([i * 1000 + np.arange(frames + 11 * i)] * channels)
        data[1:] += 7
        with wave.open(str(d / f"f{i}.wav"), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(np.ascontiguousarray(data.T.astype("<i2"))
                          .tobytes())
    return d


def test_device_corpus_windows_and_purity(tmp_path):
    d = position_corpus(tmp_path)
    dc = port.DeviceCorpus(d, crop_frames=64, batch_size=16, seed=1,
                           device="cpu")
    assert dc.dtype == np.int16 and dc._corpus.dtype == torch.int16
    assert dc.device_bytes == (400 + 411 + 422) * 2 * 2
    batch = dc.batch_at(0).numpy()
    assert batch.shape == (16, 2, 64) and batch.dtype == np.int16
    for row in batch:
        f, pos = divmod(int(row[0, 0]), 1000)
        np.testing.assert_array_equal(
            row[0], f * 1000 + pos + np.arange(64))
        np.testing.assert_array_equal(row[1], row[0] + 7)
        assert pos + 64 <= dc.frames[f]
    # Pure in (seed, step): the same batch again, and in any order.
    np.testing.assert_array_equal(dc.batch_at(0).numpy(), batch)
    it = iter(dc)
    first = [next(it).numpy() for _ in range(3)]
    np.testing.assert_array_equal(first[0], batch)
    np.testing.assert_array_equal(first[2], dc.batch_at(2).numpy())
    assert not np.array_equal(first[1], batch)
    other = port.DeviceCorpus(d, crop_frames=64, batch_size=16, seed=2,
                              device="cpu")
    assert not np.array_equal(other.batch_at(0).numpy(), batch)


def test_device_corpus_covers_files_and_end_offsets(tmp_path):
    """Over many steps every file is drawn and every offset in [0, frames −
    crop] of a file, both ends included."""
    d = position_corpus(tmp_path, n_files=3, frames=70)
    dc = port.DeviceCorpus(d, crop_frames=64, batch_size=32, seed=0,
                           device="cpu")
    seen = set()
    for step in range(40):
        starts = dc.batch_at(step)[:, 0, 0].numpy()
        seen.update(divmod(int(v), 1000) for v in starts)
    want = {(f, pos) for f in range(3) for pos in range(70 + 11 * f - 64 + 1)}
    assert seen == want


def test_device_corpus_guard_dequant_and_mesh(tmp_path):
    d = corpus(tmp_path, n_files=2, frames=500)
    with pytest.raises(ValueError, match="max_bytes"):
        port.DeviceCorpus(d, crop_frames=64, batch_size=2, max_bytes=1000,
                          device="cpu")
    i16 = port.DeviceCorpus(d, crop_frames=128, batch_size=8, seed=5,
                            device="cpu")
    f32 = port.DeviceCorpus(d, crop_frames=128, batch_size=8, seed=5,
                            dtype="float32", device="cpu")
    assert i16.dtype == np.int16 and f32.dtype == np.float32
    from audio_diffusion_torch.utils import dequant_pcm16

    for step in (0, 3):
        assert torch.equal(dequant_pcm16(i16.batch_at(step)),
                           f32.batch_at(step))
    # The float corpus holds the float decode of the files.
    np.testing.assert_array_equal(
        f32._corpus[:, :500].numpy(), port.wav_read(f32.files[0]))
    with pytest.raises(NotImplementedError, match=r"item 4\)"):
        port.DeviceCorpus(d, crop_frames=64, batch_size=2, mesh=object(),
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.DeviceCorpus(d, crop_frames=64, batch_size=2)
