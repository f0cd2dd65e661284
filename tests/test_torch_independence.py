"""paris_tpu_torch stands alone: it imports neither JAX nor anything of
the JAX package ``paris_tpu``, and its own copies of that package's
JAX-free modules (geometry, golden oracle, phantom, I/O with its native
library, CLI parser) agree with the originals (CPU only)."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paris_tpu_torch
from paris_tpu import cli as jax_cli
from paris_tpu import exceptions as jax_exceptions
from paris_tpu import geometry as jax_geometry
from paris_tpu import golden as jax_golden
from paris_tpu import phantom as jax_phantom
from paris_tpu.io import ddbvf as jax_ddbvf
from paris_tpu.io import geometry_file as jax_geometry_file
from paris_tpu.io import his as jax_his
from paris_tpu.io import native as jax_native
from paris_tpu.io.sink import VolumeSink as JaxSink
from paris_tpu.io.source import ProjectionSource as JaxSource
from paris_tpu.utils import profiling as jax_profiling
from paris_tpu_torch import cli as port_cli
from paris_tpu_torch import exceptions as port_exceptions
from paris_tpu_torch import geometry as port_geometry
from paris_tpu_torch import golden as port_golden
from paris_tpu_torch import phantom as port_phantom
from paris_tpu_torch.io import ddbvf as port_ddbvf
from paris_tpu_torch.io import geometry_file as port_geometry_file
from paris_tpu_torch.io import his as port_his
from paris_tpu_torch.io import native as port_native
from paris_tpu_torch.io.sink import VolumeSink as PortSink
from paris_tpu_torch.io.source import ProjectionSource as PortSource
from paris_tpu_torch.utils import profiling as port_profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.dirname(os.path.abspath(paris_tpu_torch.__file__))

# (n_row, n_col, l_px_row, l_px_col, delta_s, delta_t, d_so, d_od, delta_phi)
GEOMETRIES = {
    "offset_detector": (96, 80, 2.0, 2.0, 4.6, -2.0, 500.0, 500.0, 2.0),
    "roi": (64, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 6.0),
    "tall_detector": (64, 160, 2.0, 2.0, 0.0, 0.0, 400.0, 400.0, 9.0),
}
ROI = dict(x1=10, x2=29, y1=12, y2=31, z1=4, z2=23)


def _dets(name):
    """(JAX package's detector, the port's) for one geometry."""
    args = GEOMETRIES[name]
    return (jax_geometry.DetectorGeometry(*args),
            port_geometry.DetectorGeometry(*args))


def _vols(name):
    """(JAX volume, port volume), ROI-cut for the "roi" geometry."""
    jdet, pdet = _dets(name)
    jvol = jax_geometry.derive_volume_geometry(jdet)
    pvol = port_geometry.derive_volume_geometry(pdet)
    if name == "roi":
        jvol = jax_geometry.apply_roi(jvol, jax_geometry.RegionOfInterest(**ROI))
        pvol = port_geometry.apply_roi(pvol,
                                       port_geometry.RegionOfInterest(**ROI))
    return jdet, pdet, jvol, pvol


def _fields(obj):
    """A dataclass, or a tuple/list of them, as plain nested tuples (the
    two packages' classes never compare equal by ``==``)."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, dataclasses.astuple(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_fields(o) for o in obj)
    return obj


# ------------------------------------------------------------ independence

def _port_modules():
    names = []
    for root, _, files in os.walk(PACKAGE):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                names.append(mod[:-len(".__init__")]
                             if mod.endswith(".__init__") else mod)
    return sorted(names)


def test_every_module_imports_without_jax_or_the_jax_package():
    """A fresh interpreter imports every module of the port (cli,
    parallel.*, benchmarks.*, golden, phantom included); none of them
    loads jax or a paris_tpu module."""
    mods = _port_modules()
    assert {"paris_tpu_torch.cli", "paris_tpu_torch.parallel.app",
            "paris_tpu_torch.benchmarks.gather_micro2",
            "paris_tpu_torch.benchmarks.synth_c5_3600",
            "paris_tpu_torch.benchmarks.golden_slab",
            "paris_tpu_torch.benchmarks.full_scale_2048_3600",
            "paris_tpu_torch.benchmarks.full_scale_2048",
            "paris_tpu_torch.benchmarks.bench",
            "paris_tpu_torch.benchmarks.run_configs",
            "paris_tpu_torch.benchmarks.config3_stream",
            "paris_tpu_torch.benchmarks.dist_parity_ab",
            "paris_tpu_torch.benchmarks.dist_overlap_ab",
            "paris_tpu_torch.benchmarks.weak_scaling",
            "paris_tpu_torch.benchmarks.weak_scaling_projection",
            "paris_tpu_torch.golden", "paris_tpu_torch.phantom",
            "paris_tpu_torch.io.native"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print(json.dumps([m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paris_tpu')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    [os.path.relpath(os.path.join(r, f), REPO)
     for r, _, fs in os.walk(PACKAGE) for f in fs if f.endswith(".py")]
    + ["chip_smoke.py"]))
def test_source_never_imports_jax_package(path):
    roots = _imported_roots(os.path.join(REPO, path))
    assert not roots & {"paris_tpu", "jax", "jaxlib"}, (path, roots)


def test_native_io_library_is_the_ports_own():
    """The port builds csrc/paris_io.cpp with the host compiler into its
    own build directory, and never loads native/libparis_io.so."""
    from paris_tpu_torch import _build
    assert port_native.available()
    path = _build.build(["paris_io"])["paris_io"][0]
    assert os.path.dirname(path) == _build.BUILD_DIR
    lib = _build.load_library("paris_io")
    assert os.path.samefile(lib._name, path)
    with open(os.path.join(PACKAGE, "csrc", "paris_io.cpp"), "rb") as f, \
            open(os.path.join(REPO, "native", "paris_io.cpp"), "rb") as g:
        assert f.read() == g.read()


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_volume_geometry_matches(name):
    jdet, pdet, jvol, pvol = _vols(name)
    assert _fields(pdet) == _fields(jdet)
    assert pdet.d_sd == jdet.d_sd
    assert _fields(pvol) == _fields(jvol)
    assert (pvol.shape_zyx, pvol.voxels, pvol.nbytes_f32) == \
        (jvol.shape_zyx, jvol.voxels, jvol.nbytes_f32)


@pytest.mark.parametrize("kw", [
    dict(block_dz=16), dict(block_dz=7), dict(hbm_budget_bytes=1 << 20),
    dict(hbm_budget_bytes=1 << 20, num_shards=2, proj_buffer_bytes=1 << 16),
    dict(),
], ids=["dz16", "dz7", "budget", "budget_sharded", "whole"])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plan_z_blocks_matches(name, kw):
    _, _, jvol, pvol = _vols(name)
    jinfo = jax_geometry.plan_z_blocks(jvol, **kw)
    pinfo = port_geometry.plan_z_blocks(pvol, **kw)
    assert _fields(pinfo.blocks) == _fields(jinfo.blocks)
    assert _fields(pinfo) == _fields(jinfo)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_bands_weights_and_filter_size_match(name):
    """The port's band sits where the backprojection samples, at
    ``-delta_t`` (``BpGrid.v_min``); the JAX package's Pallas band puts
    the detector at ``+delta_t``.  So the port's band is the JAX
    function's at the mirrored offset, and the JAX function's itself at
    ``delta_t = 0``."""
    jdet, pdet, jvol, pvol = _vols(name)
    mirrored = dataclasses.replace(jdet, delta_t=-jdet.delta_t)
    centred = (dataclasses.replace(pdet, delta_t=0.0),
               dataclasses.replace(jdet, delta_t=0.0))
    for z0, dz in ((0, 8), (pvol.dim_z // 2, 16), (pvol.dim_z - 4, 4)):
        assert port_geometry.detector_row_band(pdet, pvol, z0, dz) == \
            jax_geometry.detector_row_band(mirrored, jvol, z0, dz)
        assert port_geometry.detector_row_band(centred[0], pvol, z0, dz) == \
            jax_geometry.detector_row_band(centred[1], jvol, z0, dz)
    assert port_geometry.weighting_constants(pdet) == \
        jax_geometry.weighting_constants(jdet)
    for n in (pdet.n_row, pdet.n_col, 1, 1000, 1024, 2048):
        assert port_geometry.filter_size_for(n) == \
            jax_geometry.filter_size_for(n)


def test_apply_roi_rejects_the_same_boxes():
    jdet, pdet, _, _ = _vols("roi")
    jvol = jax_geometry.derive_volume_geometry(jdet)
    pvol = port_geometry.derive_volume_geometry(pdet)
    for bad in (dict(ROI, x1=0, x2=jvol.dim_x + 5), dict(ROI, z1=9, z2=9)):
        with pytest.raises(ValueError) as j:
            jax_geometry.apply_roi(jvol, jax_geometry.RegionOfInterest(**bad))
        with pytest.raises(ValueError) as p:
            port_geometry.apply_roi(pvol,
                                    port_geometry.RegionOfInterest(**bad))
        assert str(p.value) == str(j.value)


def test_exception_hierarchy_matches():
    for name in ("ParisError", "StageConstructionError", "StageRuntimeError"):
        j, p = getattr(jax_exceptions, name), getattr(port_exceptions, name)
        assert [c.__name__ for c in p.__mro__] == \
            [c.__name__ for c in j.__mro__]
    assert not issubclass(port_exceptions.ParisError, jax_exceptions.ParisError)


# ------------------------------------------------------------------ I/O

PACKAGES = {
    "jax": (jax_his, jax_ddbvf, jax_geometry_file),
    "port": (port_his, port_ddbvf, port_geometry_file),
}


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_his_cross_package_byte_exact(tmp_path, writer, reader, dtype):
    rng = np.random.default_rng(5)
    frames = (rng.uniform(0, 60000, (3, 20, 24))).astype(dtype)
    a, b = str(tmp_path / "a.his"), str(tmp_path / "b.his")
    PACKAGES[writer][0].write_his(a, frames, number_dtype=dtype)
    PACKAGES[reader][0].write_his(b, frames, number_dtype=dtype)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    got = PACKAGES[reader][0].read_his(a)
    np.testing.assert_array_equal(got, frames.astype(np.float32))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_ddbvf_cross_package_byte_exact(tmp_path, monkeypatch, writer,
                                        reader, native):
    if not native:
        monkeypatch.setenv("PARIS_IO_NO_NATIVE", "1")
    vol = np.random.default_rng(6).standard_normal((6, 5, 7)).astype(
        np.float32)
    paths = {}
    for side in ("jax", "port"):
        io = PACKAGES[side][1]
        paths[side] = io.create(str(tmp_path / f"{side}.ddbvf"), 7, 5, 6)
        io.write_slices(paths[side], vol[:4], 0)
        io.write_slices(paths[side], vol[4:], 4)
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    rd = PACKAGES[reader][1]
    assert rd.open_meta(paths[writer]) == (7, 5, 6)
    np.testing.assert_array_equal(rd.read_volume(paths[writer]), vol)
    np.testing.assert_array_equal(rd.read_slices(paths[writer], 2, 3),
                                  vol[2:5])


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_geometry_file_cross_package(tmp_path, name):
    jdet, pdet = _dets(name)
    a, b = str(tmp_path / "a.geo"), str(tmp_path / "b.geo")
    jax_geometry_file.dump_geometry_file(jdet, a)
    port_geometry_file.dump_geometry_file(pdet, b)
    with open(a) as f, open(b) as g:
        assert f.read() == g.read()
    assert _fields(port_geometry_file.load_geometry_file(a)) == _fields(pdet)
    assert port_geometry_file.geometry_format_help() == \
        jax_geometry_file.geometry_format_help()


def test_projection_source_matches(tmp_path):
    rng = np.random.default_rng(7)
    frames = rng.uniform(0, 100, (10, 8, 12)).astype(np.float32)
    for i in range(0, 10, 4):
        jax_his.write_his(str(tmp_path / f"p{i:03d}.his"), frames[i:i + 4])
    (tmp_path / "zz_garbage.his").write_bytes(b"not a his file")
    kw = dict(delta_phi=4.5, quality=2)
    want = [(p.idx, p.phi, p.data) for p in JaxSource(str(tmp_path), **kw)]
    got = [(p.idx, p.phi, p.data) for p in PortSource(str(tmp_path), **kw)]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])


def test_volume_sink_manifest_matches(tmp_path):
    vol = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    outs = {}
    for side, cls in (("jax", JaxSink), ("port", PortSink)):
        sink = cls(str(tmp_path / side), "v", 3, 4, 6)
        sink.write_block(1, vol, 2)
        sink.mark_done(1)
        with open(sink.path, "rb") as f, \
                open(sink.path + ".manifest.json") as m:
            outs[side] = (f.read(), json.load(m), sorted(sink.completed_blocks))
    assert outs["port"] == outs["jax"]


def test_native_quantizer_matches_jax_package():
    chunk = np.random.default_rng(8).uniform(-5, 900, (3, 16, 24)).astype(
        np.float32)
    q = np.empty((4, 16, 24), np.uint16)
    qp = np.zeros((4, 2), np.float32)
    port_native.quantize_u16(chunk, q, qp, n_threads=1)
    if jax_native.quantize_u16_available():
        jq = np.empty_like(q)
        jqp = np.zeros_like(qp)
        jax_native.quantize_u16(chunk, jq, jqp, n_threads=1)
        np.testing.assert_array_equal(q[:3], jq[:3])
        np.testing.assert_array_equal(qp[:3], jqp[:3])
    # the pure-Python quantizer of the pipeline is the reference either way
    from paris_tpu_torch.pipeline import quantize_chunk_u16
    rq, rqp = quantize_chunk_u16(chunk, 4)
    np.testing.assert_array_equal(q[:3], rq[:3])
    np.testing.assert_array_equal(qp[:3], rqp[:3])


# ------------------------------------------------------------------ CLI

def _options(parser):
    """option string -> (dest, default, choices, nargs, type, help) for
    every action of a parser."""
    out = {}
    for a in parser._actions:
        for s in a.option_strings:
            out[s] = (a.dest, a.default, a.choices, a.nargs,
                      getattr(a.type, "__name__", a.type), type(a).__name__)
    return out


def test_parsers_have_the_same_options():
    jax_opts = _options(jax_cli.build_parser())
    port_opts = _options(port_cli.build_parser())
    assert set(port_opts) == set(jax_opts)
    for s in port_opts:
        if s == "--backend":
            continue
        if s == "--version":     # the package's own version string
            assert port_opts[s][0] == jax_opts[s][0]
            continue
        assert port_opts[s] == jax_opts[s], s
    assert port_opts["--backend"][2] == ["auto", "cuda", "torch"]
    assert port_opts["--backend"][1] == jax_opts["--backend"][1] == "auto"


@pytest.mark.parametrize("argv", [
    [], ["--geometry", "g.geo", "--input", "p", "--output", "o"],
    ["--roi", "--roi-x1", "1", "--roi-x2", "5", "--quality", "3"],
    ["--accuracy", "exact", "--chunk-size", "8", "--block-dz", "32",
     "--max-blocks", "2", "--resume", "--hbm-budget-gb", "1.5"],
    ["--distributed", "--coordinator", "h:1", "--num-processes", "2",
     "--process-id", "1", "--trace-dir", "t", "--verbose"],
], ids=["empty", "io", "roi", "job", "distributed"])
def test_parsers_parse_alike(argv):
    j = vars(jax_cli.build_parser().parse_args(argv))
    p = vars(port_cli.build_parser().parse_args(argv))
    assert p == j


# ------------------------------------------------- golden oracle, phantom

@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_cone_beam_project_matches(name):
    jdet, pdet, jvol, _ = _vols(name)
    ang = np.asarray([0.0, 37.5, 211.0], np.float32)
    scale = jvol.dim_x * jvol.l_vx_x / 2 * 0.9
    np.testing.assert_array_equal(
        port_phantom.cone_beam_project(pdet, ang, scale_mm=scale),
        jax_phantom.cone_beam_project(jdet, ang, scale_mm=scale))


def test_shepp_logan_volume_matches():
    _, _, jvol, pvol = _vols("roi")
    np.testing.assert_array_equal(
        port_phantom.shepp_logan_volume(pvol, 40.0),
        jax_phantom.shepp_logan_volume(jvol, 40.0))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_golden_fdk_stream_matches(name):
    jdet, pdet, jvol, pvol = _vols(name)
    rng = np.random.default_rng(9)
    projs = rng.standard_normal((3, pdet.n_col, pdet.n_row)).astype(
        np.float32)
    ang = [0.0, 71.0, 190.5]
    slabs = [(0, 2), (pvol.dim_z // 2, 3)]
    roi = (ROI["x1"], ROI["y1"], ROI["z1"]) if name == "roi" else (0, 0, 0)
    got = port_golden.golden_fdk_stream(zip(projs, ang), pdet, pvol, slabs,
                                        roi_offset=roi, dtype=np.float32)
    want = jax_golden.golden_fdk_stream(zip(projs, ang), jdet, jvol, slabs,
                                        roi_offset=roi, dtype=np.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.abs(got[1]).max() > 0


def test_golden_fdk_matches():
    jdet, pdet, jvol, pvol = _vols("roi")
    projs = np.random.default_rng(10).standard_normal(
        (2, pdet.n_col, pdet.n_row)).astype(np.float32)
    ang = np.asarray([12.0, 200.0], np.float32)
    np.testing.assert_array_equal(
        port_golden.golden_fdk(projs, ang, pdet, pvol),
        jax_golden.golden_fdk(projs, ang, jdet, jvol))


def test_throughput_meter_matches():
    j = jax_profiling.ThroughputMeter(1000, report_every_s=1e9)
    p = port_profiling.ThroughputMeter(1000, report_every_s=1e9)
    for m in (j, p):
        m.add(7)
        m.add(5)
    assert (p.projections, p.voxel_updates) == (j.projections,
                                                j.voxel_updates) == (12, 12000)
