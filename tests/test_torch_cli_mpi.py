"""Both MPI CLIs (``sagecal_tpu.cli_mpi`` and ``sagecal_tpu_torch.
cli_mpi``) on ``tests/test_cli_mpi.py``'s four-subband data in float64 on
the CPU, each on its own copy, at -R 0 (the JAX CLI on a one-device mesh,
``--mesh-devices 1 --host-loop``, which the port takes as no-ops): every
subband's written column within 1e-8 of the data's largest magnitude,
and the Z file and the per-subband worker files within 1e-6 of their
largest entry (the text format's 7 digits). Option sets here: the
default solver mode (robust RTR) with no ``--kernel`` flag (each CLI on
its default route), ``-C 1 -G --mdl`` (the MDL report's orders equal)
and ``-X`` with ``-u`` (the spatial model's file too); the others in
``test_torch_cli_mpi_options.py``, the execution plans (``-N``,
``--block-f``, ``--staleness``, ``--time-shard``) in
``test_torch_cli_mpi_plans.py``. The flags the port does not run raise
``NotImplementedError`` naming ROADMAP (``--faults`` a plan naming
another point than ``admm_subband_slow``), and ``--jones diag`` raises
as the JAX CLI does."""

import os
import shutil

import numpy as np
import pytest
import torch

from sagecal_tpu import cli_mpi
from sagecal_tpu_torch import cli_mpi as tcli_mpi
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol

from test_cli_mpi import make_subbands

COL_TOL = 1e-8
FILE_TOL = 1e-6
BASE = ["-A", "3", "-P", "2", "-Q", "2", "-r", "2", "-e", "2", "-g", "6",
        "-l", "3", "-t", "3", "-R", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The subband SimMS data and sky, made once."""
    root = tmp_path_factory.mktemp("mpi")
    sky_path, clus_path, paths, sky = make_subbands(root)
    return root, sky_path, clus_path, paths, sky


def _copy(data, tag):
    """A copy of the subbands for one run: (list file, paths, workdir)."""
    root, _, _, paths, _ = data
    work = root / tag
    if work.exists():
        shutil.rmtree(work)
    work.mkdir()
    out = []
    for p in paths:
        dst = work / os.path.basename(p)
        shutil.copytree(p, dst)
        out.append(str(dst))
    lst = work / "mslist.txt"
    lst.write_text("\n".join(out) + "\n")
    return str(lst), out, work


def run_both(data, tag, flags, extra_files=()):
    """Both CLIs on their own copies with ``flags`` (``@rho`` a -G file
    beside the data); returns {side: (paths, solutions path, stdout
    lines)} after holding every written column, the Z file and the
    worker files (and ``extra_files``, names beside the Z file) of the
    port against the JAX CLI's."""
    _, sky_path, clus_path, _, sky = data
    out = {}
    for side in ("jax", "torch"):
        lst, paths, work = _copy(data, f"{tag}_{side}")
        sol = str(work / "zsol.txt")
        fl = [str(work / "rho.txt") if f == "@rho" else f for f in flags]
        if "@rho" in flags:
            (work / "rho.txt").write_text("0 1 1.5\n1 1 3.0\n")
        argv = ["-f", lst, "-s", str(sky_path), "-c", str(clus_path), "-p",
                sol] + BASE + fl
        lines = []
        if side == "jax":
            import contextlib
            import io
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_mpi.main(argv + ["--mesh-devices", "1",
                                          "--host-loop"])
            lines = buf.getvalue().splitlines()
        else:
            rc = tcli_mpi.main(argv + ["--platform", "cpu"],
                               log=lines.append)
        assert rc == 0
        out[side] = (paths, sol, lines)
    (pj, sj, _), (pt, st, _) = out["jax"], out["torch"]
    for a, b in zip(pt, pj):
        xa = tds.SimMS(a, data_column="CORRECTED_DATA")
        xb = tds.SimMS(b, data_column="CORRECTED_DATA")
        x0 = tds.SimMS(b)
        for ti in range(xb.n_tiles):
            ref = xb.read_tile(ti).x
            scale = np.abs(x0.read_tile(ti).x).max()
            assert np.abs(xa.read_tile(ti).x - ref).max() <= COL_TOL * scale
            assert not np.array_equal(ref, x0.read_tile(ti).x)
    nchunk = sky.nchunk
    pairs = [(st, sj, nchunk * 2)] + [(a + ".solutions", b + ".solutions",
                                       nchunk) for a, b in zip(pt, pj)]
    for a, b, nc in pairs:
        ha, ba = tsol.read_solutions(a, nc)
        hb, bb = tsol.read_solutions(b, nc)
        assert ha == hb and len(ba) == len(bb) >= 1
        ba, bb = np.asarray(ba), np.asarray(bb)
        assert np.abs(ba - bb).max() <= FILE_TOL * np.abs(bb).max()
    for name in extra_files:
        fa = np.loadtxt(os.path.join(os.path.dirname(st), name), skiprows=6)
        fb = np.loadtxt(os.path.join(os.path.dirname(sj), name), skiprows=6)
        assert fa.shape == fb.shape
        assert np.abs(fa - fb).max() <= FILE_TOL * np.abs(fb).max()
    return out


def test_mpi_cli_default_matches_reference(data):
    """The default solver (-j 5, robust RTR) without a --kernel flag: the
    port's fused-sweep route against the JAX CLI's XLA default."""
    run_both(data, "default", [])


def test_mpi_cli_adaptive_rho_file_mdl(data):
    """-C 1 (Barzilai-Borwein rho), -G (per-cluster rho) and --mdl: the
    MDL report names the same orders."""
    out = run_both(data, "cgmdl", ["-j", "1", "-C", "1", "-G", "@rho",
                                   "--mdl"])
    reports = {side: [ln for ln in v[2] if ln.startswith("Finding best")]
               for side, v in out.items()}
    assert len(reports["torch"]) == 1
    pick = lambda ln: [w for w in ln.split() if "terms=" in w]
    assert pick(reports["torch"][0]) == pick(reports["jax"][0])


def test_mpi_cli_spatialreg(data):
    """-X l2,l1,order,fista_iters,cadence with -u: Z pulled toward the
    spatial model, and its spatial_ file beside the Z file."""
    run_both(data, "spatial", ["-j", "1", "-X", "0.1,0.01,2,20,2", "-u",
                               "0.5"], extra_files=("spatial_zsol.txt",))


@pytest.mark.parametrize("flag,value", [
    ("--coordinator", "localhost:1"),
    ("--num-processes", "2"), ("--cpu-devices", "4"),
    ("--prior-cache", "read"), ("--diag", "d.jsonl"),
    ("--metrics", "m.json"),
    ("--faults", '[{"point": "ms_read", "at": [0]}]'), ("--prefetch", "0")])
def test_mpi_cli_unported_flags_raise(flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item"):
        tcli_mpi.main(["-f", "x", "-s", "s", "-c", "c", flag, value,
                       "--platform", "cpu"])


def test_mpi_cli_jones_mode_raises(data):
    _, sky_path, clus_path, paths, _ = data
    for cli in (cli_mpi, tcli_mpi):
        with pytest.raises(ValueError, match="full-Jones"):
            cli.main(["-f", paths[0], "-s", str(sky_path), "-c",
                      str(clus_path), "--jones", "diag"])


def test_mpi_cli_needs_the_card_without_platform(data):
    """Without --platform cpu the run needs a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lst, _, _ = _copy(data, "nocard")
    _, sky_path, clus_path, _, _ = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli_mpi.main(["-f", lst, "-s", str(sky_path), "-c",
                       str(clus_path)] + BASE)
