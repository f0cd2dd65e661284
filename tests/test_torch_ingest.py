"""The port's ingest stage on the CPU: the raw HIS reader, the raw
``ProjectionSource`` and its chunk reads, the fast-mode u16 quantization
as torch ops (bit for bit the native quantizer and the JAX package's),
the staged step against the parent's composition (bit for bit), the
projection cache's placement and its three places, and the ingest split
in the job log.  The card's side (the pinned ring, the copy stream, the
card cache, the quantization on the card) is in tests/test_torch_cuda.py.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from paris_tpu.app import ReconstructionJob as JaxJob, run_job as jax_run_job
from paris_tpu.geometry import DetectorGeometry as JaxDetectorGeometry
from paris_tpu import pipeline as jax_pipeline
from paris_tpu_torch.app import ReconstructionJob, cache_placement, run_job
from paris_tpu_torch.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu_torch.io import ddbvf, native
from paris_tpu_torch.io import his as port_his
from paris_tpu_torch.io import source as source_mod
from paris_tpu_torch.io.his import (HisFormatError, read_his, read_his_frames,
                                    read_his_header, read_his_raw,
                                    read_his_selective, write_his)
from paris_tpu_torch.io.source import ProjectionSource
from paris_tpu_torch.ops.backprojection_torch import backproject_chunk_torch
from paris_tpu_torch.pipeline import (ArrayRows, Reconstructor, Staged,
                                      dequantize_chunk, identity_qparams,
                                      preprocess_chunk, quantize_chunk_u16,
                                      quantize_u16_torch, u16_round_trip)
from paris_tpu_torch.utils.logging import StageTimers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=[True, False], ids=["native", "python"])
def io_path(request, monkeypatch):
    """Each reader test runs through the native library and the Python
    fallback."""
    if not request.param:
        monkeypatch.setenv("PARIS_IO_NO_NATIVE", "1")
    else:
        assert native.raw_available()
    return request.param


NUMBER_TYPES = [np.uint8, np.uint16, np.uint32, np.float64, np.float32]
KEPT = (np.uint8, np.uint16, np.float32)


def _frames(dtype, n=5, h=6, w=7, seed=0):
    rng = np.random.default_rng(seed)
    hi = 250 if dtype == np.uint8 else 60000
    frames = rng.uniform(0, hi, (n, h, w))
    if np.dtype(dtype).kind == "f":
        frames -= hi / 3                 # negative values too
    return frames.astype(dtype)


# ------------------------------------------------------------ raw reader

@pytest.mark.parametrize("dtype", NUMBER_TYPES, ids=lambda d: d.__name__)
def test_read_his_raw_against_read_his(tmp_path, io_path, dtype):
    """Every HIS number type: the raw read keeps u8, u16 and f32 as stored
    and makes u32 and f64 float32; cast to float32 it is ``read_his``.  A
    caller's buffer (room for more frames) receives the frames."""
    frames = _frames(dtype)
    path = str(tmp_path / "a.his")
    write_his(path, frames, number_dtype=dtype)
    raw = read_his_raw(path)
    want = np.dtype(dtype) if dtype in KEPT else np.dtype(np.float32)
    assert raw.dtype == want == read_his_header(path).raw_dtype
    np.testing.assert_array_equal(raw.astype(np.float32), read_his(path))
    if dtype in KEPT:
        np.testing.assert_array_equal(raw, frames)
    out = np.full((7, 6, 7), 3, want)
    got = read_his_raw(path, out=out)
    assert got.base is out or got is out or np.shares_memory(got, out)
    np.testing.assert_array_equal(out[:5], raw)
    np.testing.assert_array_equal(out[5:], 3)
    with pytest.raises(ValueError):
        read_his_raw(path, out=np.empty((4, 6, 7), want))


@pytest.mark.parametrize("dtype", NUMBER_TYPES, ids=lambda d: d.__name__)
def test_read_his_selective_raw(tmp_path, dtype):
    frames = _frames(dtype, n=6)
    path = str(tmp_path / "a.his")
    write_his(path, frames, number_dtype=dtype)
    n, f32 = read_his_selective(path, lambda j: j % 2 == 1)
    n_raw, raw = read_his_selective(path, lambda j: j % 2 == 1, raw=True)
    assert n == n_raw == 6 and sorted(raw) == sorted(f32) == [1, 3, 5]
    for j in raw:
        assert raw[j].dtype == read_his_header(path).raw_dtype
        np.testing.assert_array_equal(raw[j].astype(np.float32), f32[j])


def test_read_his_frames_range_and_truncation(tmp_path, io_path):
    """A frame range lands in the caller's rows; a file cut short raises
    ``HisFormatError``; the decode counter counts the frames read."""
    frames = _frames(np.uint16, n=8)
    path = str(tmp_path / "a.his")
    write_his(path, frames, number_dtype=np.uint16)
    header = read_his_header(path)
    before = port_his.DECODE_STATS["frames"]
    out = read_his_frames(path, header, 3, np.empty((4, 6, 7), np.uint16), 2)
    np.testing.assert_array_equal(out, frames[3:7])
    assert port_his.DECODE_STATS["frames"] - before == 4
    with pytest.raises(ValueError):
        read_his_frames(path, header, 6, np.empty((4, 6, 7), np.uint16))
    with open(path, "r+b") as f:
        f.truncate(header.file_bytes - 10)
    with pytest.raises(HisFormatError):
        read_his_frames(path, header, 4, np.empty((4, 6, 7), np.uint16))


# ------------------------------------------------------- the raw source

@pytest.fixture(scope="module")
def his_dir(tmp_path_factory):
    """21 uint16 frames in files of 8, one garbage file, one file cut
    short (skipped, as a read of it would be)."""
    d = tmp_path_factory.mktemp("his")
    frames = _frames(np.uint16, n=21, h=6, w=5, seed=4)
    for i in range(0, 21, 8):
        write_his(str(d / f"b{i:03d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)
    (d / "c_garbage.his").write_bytes(b"not a his file")
    write_his(str(d / "d_cut.his"), frames[:2], number_dtype=np.uint16)
    with open(d / "d_cut.his", "r+b") as f:
        f.truncate(100)
    return str(d), frames


FILTERS = {"all": None, "half": lambda pos: pos % 4 < 2}


@pytest.mark.parametrize("quality", [1, 2, 4])
@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_raw_source_against_the_f32_source(his_dir, io_path, quality, filt):
    """Raw mode yields the f32 mode's projections, in the stored type:
    the same indices, angles, undecoded frames (None) and, cast to
    float32, the same pixels; its chunk reads plan the same chunks, and
    read into a buffer they give iter_chunks' frames with zero rows where
    a frame was not decoded (whole chunks, and the rows of one slot
    range)."""
    d, _ = his_dir
    kw = dict(delta_phi=1.5, quality=quality, slot_filter=FILTERS[filt])
    f32 = list(ProjectionSource(d, **kw))
    raw_src = ProjectionSource(d, raw=True, **kw)
    raw = list(raw_src)
    assert [(p.idx, p.phi) for p in raw] == [(p.idx, p.phi) for p in f32]
    for r, f in zip(raw, f32):
        assert (r.data is None) == (f.data is None)
        if r.data is not None:
            assert r.data.dtype == np.uint16
            np.testing.assert_array_equal(r.data.astype(np.float32), f.data)
    chunks = list(raw_src.iter_chunks(4))
    reads = list(raw_src.chunk_reads(4, n_threads=2))
    assert len(chunks) == len(reads)
    for plist, read in zip(chunks, reads):
        assert read.rows == len(plist) and read.dtype == np.uint16
        np.testing.assert_array_equal(read.phis, [p.phi for p in plist])
        out = np.full((4, 6, 5), 9, np.uint16)
        read.read_into(out)
        for i, p in enumerate(plist):
            np.testing.assert_array_equal(
                out[i], 0 if p.data is None else p.data)
        part = np.full((2, 6, 5), 9, np.uint16)
        read.read_into(part, 2, 4)
        np.testing.assert_array_equal(part[:max(0, read.rows - 2)],
                                      out[2:read.rows])


def test_source_reads_its_headers_once(his_dir, monkeypatch):
    """The file table is built from one header read per file; passes over
    the stream (iteration, chunk reads) read no header again."""
    d, _ = his_dir
    calls = []
    real = source_mod.read_his_header

    def counting(path):
        calls.append(path)
        return real(path)
    monkeypatch.setattr(source_mod, "read_his_header", counting)
    monkeypatch.setattr(port_his, "read_his_header", counting)
    src = ProjectionSource(d, delta_phi=1.0, raw=True)
    assert len(calls) == 5 and len(src.files) == 3
    for _ in range(2):
        for read in src.chunk_reads(8):
            read.read_into(np.empty((8, 6, 5), np.uint16))
        list(src)
    assert len(calls) == 5


def test_mixed_number_types_stage_as_float32(tmp_path):
    """A chunk whose files differ in number type reads as float32."""
    a, b = _frames(np.uint16, n=3), _frames(np.float32, n=3, seed=1)
    write_his(str(tmp_path / "a.his"), a, number_dtype=np.uint16)
    write_his(str(tmp_path / "b.his"), b, number_dtype=np.float32)
    read, = ProjectionSource(str(tmp_path), raw=True).chunk_reads(8)
    assert read.dtype == np.float32 and read.rows == 6
    out = np.empty((6, 6, 7), np.float32)
    read.read_into(out)
    np.testing.assert_array_equal(out[:3], a.astype(np.float32))
    np.testing.assert_array_equal(out[3:], b)


def test_array_rows_reads_its_rows():
    rows = ArrayRows(np.arange(12, dtype=np.uint16).reshape(3, 2, 2), 2, 6)
    out = np.full((4, 2, 2), 7, np.uint16)
    rows.read_into(out, 1, 5)
    np.testing.assert_array_equal(out[0], 0)
    np.testing.assert_array_equal(out[1:4], rows.array)
    rows.read_into(out, 4, 8)            # rows 4, 5 of a 6-row chunk
    np.testing.assert_array_equal(out[0], rows.array[2])
    np.testing.assert_array_equal(out[1], 0)
    assert ArrayRows(np.zeros((2, 2, 2))).dtype == np.float32


# ------------------------------------------------ the u16 quantization

def _near_ties(n, h, w):
    """Frames whose codes land on ties and at the top of the range: lo 0
    and hi 65535 make scale and its inverse exactly 1, so x.5 values are
    ties (half to even) next to the top code; a range 1.9341504e-34 wide
    has a subnormal scale, whose codes reach 65535.016; one 1e-38 wide an
    infinite inverse (codes 0, as the native conversion gives)."""
    f = np.zeros((n, h, w), np.float32)
    f[0] = 65535.0
    f[0, 0, :7] = [0.0, 0.5, 1.5, 2.5, 65533.5, 65534.5, 65535.0]
    for i, width in ((1, 1.9341504e-34), (2, 1e-38)):
        f[i] = np.linspace(0, np.float32(width), h * w,
                           dtype=np.float32).reshape(h, w)
        f[i].flat[-1] = np.float32(width)
    return f


def _case(name):
    rng = np.random.default_rng(21)
    C, h, w = 6, 24, 20
    if name == "u16":
        f = rng.integers(0, 65536, (C, h, w)).astype(np.float32)
    elif name == "f32":
        f = rng.uniform(-300, 9000, (C, h, w)).astype(np.float32)
    elif name == "negative":
        f = rng.uniform(-9000, -3, (C, h, w)).astype(np.float32)
    elif name == "constant":
        f = rng.uniform(0, 1, (C, h, w)).astype(np.float32)
        f[1], f[3] = 7.25, -2.0
    elif name == "zeros":
        f = np.zeros((C, h, w), np.float32)
        f[2] = rng.uniform(0, 1, (h, w))
    else:
        f = _near_ties(C, h, w)
    return f


def _native(frames, n, pad_to):
    q = np.zeros((pad_to,) + frames.shape[1:], np.uint16)
    qp = np.zeros((pad_to, 2), np.float32)
    native.quantize_u16(np.ascontiguousarray(frames[:n]), q, qp, n_threads=1)
    return q, qp


@pytest.mark.parametrize("n", [6, 4], ids=["full", "padded_tail"])
@pytest.mark.parametrize("case", ["u16", "f32", "negative", "constant",
                                  "zeros", "ties_and_top"])
def test_quantize_u16_torch_bit_for_bit(case, n):
    """The torch quantization equals the native quantizer
    (``paris_quantize_u16``), the port's ``quantize_chunk_u16`` and the
    JAX package's, bit for bit: codes and both qparams; constant frames
    (1, lo) with codes 0; padded tail frames (0, 0) with codes 0."""
    frames = _case(case)
    padded = frames.copy()
    padded[n:] = 0
    q, qp = quantize_u16_torch(torch.from_numpy(padded), n)
    assert q.dtype == torch.int32
    q = q.numpy()
    assert q.min() >= 0 and q.max() <= 65535
    nq, nqp = _native(frames, n, 6)
    pq, pqp = quantize_chunk_u16(np.ascontiguousarray(frames[:n]), 6)
    jq, jqp = jax_pipeline.quantize_chunk_u16(
        np.ascontiguousarray(frames[:n]), 6)
    for ref_q, ref_qp in ((nq, nqp), (pq, pqp), (jq, jqp)):
        np.testing.assert_array_equal(q.astype(np.uint16), ref_q)
        np.testing.assert_array_equal(qp.numpy().view(np.uint32),
                                      ref_qp.view(np.uint32))
    if case == "constant":
        np.testing.assert_array_equal(qp[1].numpy(), [1.0, 7.25])
        np.testing.assert_array_equal(q[1], 0)
    np.testing.assert_array_equal(qp[n:].numpy(), 0)
    np.testing.assert_array_equal(q[n:], 0)
    if case == "ties_and_top":
        np.testing.assert_array_equal(q[0, 0, :7],
                                      [0, 0, 2, 2, 65534, 65534, 65535])


def test_quantize_matches_the_numpy_fallback(monkeypatch):
    """Without the native library the port's ``quantize_chunk_u16`` takes
    NumPy's path; the torch quantization equals it too."""
    monkeypatch.setenv("PARIS_IO_NO_NATIVE", "1")
    for case in ("f32", "constant", "ties_and_top"):
        frames = _case(case)
        pq, pqp = quantize_chunk_u16(frames, 6)
        q, qp = quantize_u16_torch(torch.from_numpy(frames))
        np.testing.assert_array_equal(q.numpy().astype(np.uint16), pq)
        np.testing.assert_array_equal(qp.numpy().view(np.uint32),
                                      pqp.view(np.uint32))


def test_round_trip_is_the_dequantized_codes():
    """``u16_round_trip`` is ``dequantize_chunk`` of the native codes, bit
    for bit (its multiply and add two rounded operations), on the CPU
    counting nothing."""
    frames = _case("f32")
    nq, nqp = _native(frames, 5, 6)
    _, qp = quantize_u16_torch(torch.from_numpy(frames), 5)
    before = u16_round_trip.launches
    got = u16_round_trip(torch.from_numpy(frames), qp)
    want = dequantize_chunk(torch.from_numpy(nq.astype(np.float32)),
                            torch.from_numpy(nqp))
    np.testing.assert_array_equal(got[:5].numpy().view(np.uint32),
                                  want[:5].numpy().view(np.uint32))
    assert u16_round_trip.launches == before


# ------------------------------------- the staged step against the parent

DET = DetectorGeometry(40, 48, 2.0, 2.0, 0.0, 0.0, 300.0, 300.0, 7.5)


def _parent_step(rec, volume, raw, ang, n, z_offset):
    """The parent's composition: the whole chunk as float32 on the host,
    quantize_chunk_u16 in fast mode (identity qparams in exact mode), the
    band's rows, dequantize_chunk, preprocess_chunk, the kernel's dtype,
    backproject_chunk_torch."""
    C = rec.chunk_size
    chunk = raw[:n].astype(np.float32)
    if rec.accuracy == "fast":
        q, qp = quantize_chunk_u16(chunk, C)
    else:
        q = np.concatenate([chunk, np.zeros((C - n,) + chunk.shape[1:],
                                            np.float32)])
        qp = identity_qparams(C)
    v_lo = rec._v_band_lo(z_offset)
    rows = slice(v_lo, v_lo + rec._vp)
    band = dequantize_chunk(torch.from_numpy(q)[:, rows],
                            torch.from_numpy(qp))
    filtered = preprocess_chunk(band, rec._weights[rows], rec._spectrum,
                                rec.det.n_row)
    dtype = torch.bfloat16 if rec.accuracy == "fast" else torch.float32
    phi = np.deg2rad(np.pad(ang, (0, C - len(ang)))).astype(np.float32)
    return backproject_chunk_torch(
        volume, filtered.to(dtype).contiguous(),
        torch.from_numpy(np.sin(phi)), torch.from_numpy(np.cos(phi)),
        rec.grid, z_offset=z_offset, v_lo=v_lo)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32],
                         ids=["u16", "f32"])
@pytest.mark.parametrize("accuracy", ["fast", "exact"])
@pytest.mark.parametrize("n", [8, 5], ids=["full", "tail"])
def test_step_staged_equals_the_parents_composition(dtype, accuracy, n):
    """The staged step (raw frames staged, converted, in fast mode
    quantized, on the device) equals the parent's host quantization and
    device composition bit for bit, from u16 and f32 chunks, on a
    detector-row band, whole chunks and a stream's short tail."""
    vol = derive_volume_geometry(DET)
    rec = Reconstructor(DET, vol, chunk_size=8, backend="torch",
                        accuracy=accuracy, block_shape=(8, vol.dim_y,
                                                        vol.dim_x),
                        v_band_width=24)
    raw = _frames(dtype, n=8, h=DET.n_col, w=DET.n_row, seed=5)
    ang = (np.arange(n) * 7.5 + 3.0).astype(np.float32)
    z_offset = 16
    staged = rec.stage_chunk(raw[:n], ang)
    assert isinstance(staged, Staged) and staged.n == n
    got = rec.step_staged(rec.init_block(), staged, z_offset=z_offset)
    want = _parent_step(rec, rec.init_block(), raw, ang, n, z_offset)
    assert rec._vp == 24 and got.abs().max() > 0
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


def test_staged_chunk_keeps_its_raw_type():
    """u16 frames stage as 2 bytes a pixel (int16 holding the u16 bits),
    float64 ones as float32; rows past the chunk's are zero."""
    vol = derive_volume_geometry(DET)
    rec = Reconstructor(DET, vol, chunk_size=4, backend="torch")
    raw = _frames(np.uint16, n=3, h=DET.n_col, w=DET.n_row)
    staged = rec.stage_chunk(raw, np.zeros(3, np.float32), keep=True)
    assert staged.chunk.dtype == torch.int16 and staged.chunk.shape[0] == 4
    np.testing.assert_array_equal(
        staged.chunk[:3].numpy().view(np.uint16), raw)
    np.testing.assert_array_equal(staged.chunk[3].numpy(), 0)
    rows, ang = staged.host
    assert rows.rows == 3 and len(ang) == 3
    np.testing.assert_array_equal(rows.array, raw)
    staged = rec.stage_chunk(raw.astype(np.float64), np.zeros(3))
    assert staged.chunk.dtype == torch.float32


# ------------------------------------------------------ jobs and cache

@pytest.fixture(scope="module")
def u16_scan(tmp_path_factory):
    """48 uint16 frames of a phantom (files of 8) on a 40 x 48 detector."""
    from paris_tpu_torch.phantom import cone_beam_project
    d = tmp_path_factory.mktemp("u16scan")
    angles = np.arange(48, dtype=np.float32) * DET.delta_phi
    vol = derive_volume_geometry(DET)
    projs = cone_beam_project(DET, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2 * 0.9)
    counts = np.rint(projs / projs.max() * 60000).astype(np.uint16)
    for i in range(0, 48, 8):
        write_his(str(d / f"b{i:03d}.his"), counts[i:i + 8],
                  number_dtype=np.uint16)
    return str(d)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_u16_scan_job_against_the_jax_job(u16_scan, tmp_path):
    """A u16 HIS directory through the port's run_job (plain version,
    exact, two blocks, the host cache) and the JAX package's run_job on
    CPU JAX: relative RMSE <= 1e-5, the tolerance of
    tests/test_torch_full_scale.py::test_u16_scan_port_job_against_the_jax_job."""
    port = ddbvf.read_volume(run_job(ReconstructionJob(
        det=DET, input_path=u16_scan, output_path=str(tmp_path / "port"),
        prefix="v", chunk_size=8, backend="torch", accuracy="exact",
        block_dz=16)))
    ref = ddbvf.read_volume(jax_run_job(JaxJob(
        det=JaxDetectorGeometry(**dataclasses.asdict(DET)),
        input_path=u16_scan, output_path=str(tmp_path / "jax"), prefix="v",
        chunk_size=8, backend="xla", accuracy="exact", block_dz=16)))
    assert port.shape == ref.shape and np.abs(ref).max() > 0
    rmse = np.sqrt(np.mean((port.astype(np.float64) - ref) ** 2))
    assert rmse <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("card,host,room,cap,want", [
    (100, 90, 100, 0, "card"),          # fits the card exactly
    (100, 90, 99, 90, "host"),          # not the card: the host's cap
    (100, 90, None, 1 << 40, "host"),   # no card
    (100, 90, 99, 89, "off"),           # neither
    (100, 90, None, 0, "off"),
    (0, 0, None, 0, "host"),            # an empty stream
    (100, 90, -5, 1 << 40, "host"),     # the plan leaves the card no room
])
def test_cache_placement(card, host, room, cap, want):
    """The cache's place as a function of the bytes alone: the card's
    (padded slots) against the room the plan leaves, the host's (frames)
    against the cap."""
    assert cache_placement(card, host, room, cap) == want


@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_cache_on_the_host_and_off_write_the_same_bytes(
        u16_scan, tmp_path, caplog, accuracy):
    """One three-block job with the cache on the host and with it off:
    byte-identical ddbvf; the host cache reads the scan once, the stream
    once per block; the log names the place and the ingest split of every
    block."""
    base = ReconstructionJob(
        det=DET, input_path=u16_scan, output_path=str(tmp_path),
        chunk_size=16, backend="torch", accuracy=accuracy, block_dz=16)
    n_blocks = 3
    outs, decoded = {}, {}
    for label, cache in (("host", True), ("off", False)):
        before = port_his.DECODE_STATS["frames"]
        with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
            outs[label] = _read(run_job(dataclasses.replace(
                base, prefix=label, cache_projections=cache)))
        decoded[label] = port_his.DECODE_STATS["frames"] - before
    assert outs["host"] == outs["off"]
    assert decoded == {"host": 48, "off": n_blocks * 48}
    text = caplog.text
    assert f"projection cache: on the host, {48 * 40 * 48 * 2} bytes" in text
    assert "projection cache: off (cache_projections=False)" in text
    for origin in ("HIS files", "host cache"):
        assert f"ingest from the {origin}: reconstruct" in text
    assert text.count("ingest from the") == 2 * n_blocks


def test_one_block_run_does_not_cache(u16_scan, tmp_path, caplog):
    """A run of one block of a multi-block plan (max_blocks=1) keeps no
    cache; the plan says why."""
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        run_job(ReconstructionJob(
            det=DET, input_path=u16_scan, output_path=str(tmp_path),
            chunk_size=16, backend="torch", block_dz=16, max_blocks=1))
    assert "projection cache: off (one block in this run, max_blocks)" in \
        caplog.text


def test_job_reads_its_headers_once(u16_scan, tmp_path, monkeypatch):
    """A three-block job that streams every block reads each HIS header
    once."""
    calls = []
    real = source_mod.read_his_header

    def counting(path):
        calls.append(path)
        return real(path)
    monkeypatch.setattr(source_mod, "read_his_header", counting)
    monkeypatch.setattr(port_his, "read_his_header", counting)
    before = port_his.DECODE_STATS["frames"]
    run_job(ReconstructionJob(
        det=DET, input_path=u16_scan, output_path=str(tmp_path),
        chunk_size=16, backend="torch", block_dz=16,
        cache_projections=False))
    assert port_his.DECODE_STATS["frames"] - before == 3 * 48
    assert sorted(calls) == sorted(
        os.path.join(u16_scan, n) for n in os.listdir(u16_scan))


def test_stage_timers_are_thread_safe_and_merge():
    import threading
    t = StageTimers()

    def work():
        for _ in range(2000):
            t.add("read", 0.5)
    threads = [threading.Thread(target=work) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.counts["read"] == 8000 and t.totals["read"] == 4000.0
    total = StageTimers()
    total.add("read", 1.0)
    total.merge(t)
    assert total.counts["read"] == 8001 and total.totals["read"] == 4001.0
