"""The MPI CLIs' execution plans (``sagecal_tpu.cli_mpi`` and
``sagecal_tpu_torch.cli_mpi``) in float64 on the CPU, each CLI on its own
copy of the subbands, at -R 0:

- ``-N 1 -M 2 -w 2 -A 2 -u 0.5`` (federated stochastic calibration) on 2
  subbands of ``tests/test_aux.py``'s federated fixture (4 channels):
  the JAX CLI's mesh run over the CPU devices against the port's slaves
  in turn;
- ``--block-f 2`` (3 subbands: a ragged last block; the JAX CLI on a
  one-device mesh, ``--mesh-devices 1``, as the plan needs),
  ``--staleness 2 --faults`` a plan slowing subband 1 for 2 rounds, and
  ``--time-shard 2`` over 3 intervals (the JAX CLI on a 3 x 2 mesh of the
  CPU devices, the port's shards in turn), on 3 subbands of 6 stations
  with 3 intervals each.

Every subband's written column within COL_TOL of the data's largest
magnitude, and the solution files (the Z file and the worker files; under
``-N`` the multi-band solutions) within FILE_TOL of their largest entry
(``test_torch_cli_mpi.py``'s gates), and under ``-N`` the FEDA dual
residuals printed by ``-V`` within 1e-5. The JAX CLI's refusals around
the plans raise the same error type in the port."""

import contextlib
import io
import json
import math
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import cli_mpi, faults, skymodel
from sagecal_tpu.io import dataset as ds
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import cli_mpi as tcli_mpi
from sagecal_tpu_torch import faults as tfaults
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol

from test_aux import _make_subband_datasets
from test_torch_cli_mpi import COL_TOL, FILE_TOL

BASE = ["-A", "3", "-P", "2", "-r", "2", "-j", "1", "-e", "2", "-g", "5",
        "-l", "3", "-t", "2", "-R", "0"]
SLOW = json.dumps([{"point": "admm_subband_slow", "at": [1], "times": 2}])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_plan():
    yield
    for mod in (faults, tfaults):
        mod.disable()


def make_interval_subbands(root, nf=3, n_stations=6, tilesz=2, nt=3):
    """``nf`` subbands of one point-source cluster and one of two sources,
    gains smooth in frequency, ``nt`` intervals each: (sky, cluster,
    paths, nchunk)."""
    sky_path = root / "sky.txt"
    sky_path.write_text(
        "P0A 0 40 0 40 0 0 3.0 0 0 0 0 0 0 0 0 150e6\n"
        "P1A 1 20 0 38 0 0 2.5 0 0 0 0 0 0 0 0 150e6\n")
    clus_path = root / "sky.cluster"
    clus_path.write_text("0 1 P0A\n1 1 P1A\n")
    ra0 = (41 / 60) * math.pi / 12
    dec0 = 40 * math.pi / 180
    srcs = skymodel.parse_sky_model(str(sky_path), ra0, dec0, 150e6)
    sky = skymodel.build_cluster_sky(
        srcs, skymodel.parse_cluster_file(str(clus_path)))
    dsky = rp.sky_to_device(sky, jnp.float64)
    Jb = ds.random_jones(sky.n_clusters, sky.nchunk, n_stations, seed=1,
                         scale=0.2)
    slope = ds.random_jones(sky.n_clusters, sky.nchunk, n_stations, seed=2,
                            scale=0.05) - np.eye(2)
    paths = []
    for f in range(nf):
        fr = 150e6 * (1 + 0.02 * f)
        tiles = [ds.simulate_dataset(
            dsky, n_stations=n_stations, tilesz=tilesz, freqs=[fr],
            ra0=ra0, dec0=dec0, jones=Jb + slope * 0.02 * f,
            nchunk=sky.nchunk, noise_sigma=0.01, seed=5 + 7 * t)
            for t in range(nt)]
        p = root / f"sb{f:02d}.ms"
        ds.SimMS.create(str(p), tiles)
        paths.append(str(p))
    return str(sky_path), str(clus_path), paths, sky.nchunk


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpi_plans")
    return root, make_interval_subbands(root)


@pytest.fixture(scope="module")
def fed_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpi_fed")
    paths, sky = _make_subband_datasets(root, nf=2, tilesz=4, nchan=4)
    return root, (str(root / "sky.txt"), str(root / "sky.txt.cluster"),
                  paths, sky.nchunk)


def _copy(root, paths, tag):
    work = root / tag
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    out = []
    for p in paths:
        dst = work / os.path.basename(p)
        shutil.copytree(p, dst)
        out.append(str(dst))
    lst = work / "mslist.txt"
    lst.write_text("\n".join(out) + "\n")
    return str(lst), out, work


def _jax_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_mpi.main(argv)
    faults.disable()
    return rc, buf.getvalue().splitlines()


def run_both(data, tag, flags, jax_flags=(), fed=False, n_tiles=None):
    """Both CLIs on their own copies; holds every written column (of
    the first ``n_tiles`` intervals, all without it) and the solution
    files of the port against the JAX CLI's. Returns {side: (paths,
    stdout lines, the port's records)}."""
    root, (sky, clus, paths, nchunk) = data
    out = {}
    for side in ("jax", "torch"):
        lst, ps, work = _copy(root, paths, f"{tag}_{side}")
        argv = ["-f", lst, "-s", sky, "-c", clus, "-p",
                str(work / "sol.txt")] + flags
        if side == "jax":
            rc, lines = _jax_main(argv + list(jax_flags))
            assert rc == 0
            out[side] = (ps, lines, None)
        else:
            lines = []
            hist = tcli_mpi.run(argv + ["--platform", "cpu"],
                                log=lines.append)
            out[side] = (ps, lines, hist)
    (pj, _, _), (pt, _, _) = out["jax"], out["torch"]
    for a, b, raw in zip(pt, pj, paths):
        xa = tds.SimMS(a, data_column="CORRECTED_DATA")
        xb = ds.SimMS(b, data_column="CORRECTED_DATA")
        x0 = ds.SimMS(raw)
        for ti in range(n_tiles or x0.n_tiles):
            ref = xb.read_tile(ti).x
            scale = np.abs(x0.read_tile(ti).x).max()
            assert np.abs(xa.read_tile(ti).x - ref).max() <= COL_TOL * scale
            assert not np.array_equal(ref, x0.read_tile(ti).x)
    pairs = [(os.path.join(os.path.dirname(pt[0]), "sol.txt"),
              os.path.join(os.path.dirname(pj[0]), "sol.txt"),
              nchunk if fed else nchunk * 2)]
    if not fed:
        pairs += [(a + ".solutions", b + ".solutions", nchunk)
                  for a, b in zip(pt, pj)]
    for a, b, nc in pairs:
        ha, ba = tsol.read_solutions(a, nc)
        hb, bb = tsol.read_solutions(b, nc)
        assert ha == hb and len(ba) == len(bb) >= 1
        ba, bb = np.asarray(ba), np.asarray(bb)
        assert np.abs(ba - bb).max() <= FILE_TOL * np.abs(bb).max()
    return out


def test_mpi_cli_federated(fed_data, capsys):
    """-N through both MPI CLIs: the JAX mesh program over the CPU
    devices against the port's slaves in turn, the FEDA lines printed
    under -V; -x, which the -N route does not apply, warns on stderr in
    both."""
    out = run_both(fed_data, "fed", ["-N", "1", "-M", "2", "-w", "2", "-A",
                                     "2", "-u", "0.5", "-r", "2", "-l", "6",
                                     "-m", "5", "-t", "4", "-V", "-x", "1"],
                   fed=True)
    err = capsys.readouterr().err
    assert err.count("-x/-y uv cuts are not applied in federated") == 2
    fj = [ln for ln in out["jax"][1] if ln.startswith("FEDA:")]
    ft = [ln for ln in out["torch"][1] if ln.startswith("FEDA:")]
    assert len(ft) == len(fj) == 2
    for a, b in zip(ft, fj):
        va, vb = float(a.split("=")[1]), float(b.split("=")[1])
        assert abs(va - vb) <= 1e-5 * abs(vb) + 1e-6
    hist = out["torch"][2]
    assert len(hist) == 1 and hist[0]["res_1"] < hist[0]["res_0"]


def test_mpi_cli_block_f(data):
    """--block-f 2 on 3 subbands (a ragged last block) on the first
    interval: the ADMM wall-clock line, the timer a solve entry a block."""
    out = run_both(data, "blockf", BASE + ["--block-f", "2", "-T", "1"],
                   jax_flags=["--mesh-devices", "1"], n_tiles=1)
    assert any(ln.startswith("ADMM wall-clock/iter:")
               and "(blocks of 2 subbands, 2 solve executions" in ln
               for ln in out["torch"][1])
    rec = out["torch"][2][0]
    assert [lb for lb, _ in rec["timer"]][:3] == ["solve[0]", "solve[1]",
                                                  "cons0"]
    assert len(rec["iter_s"]) == 3


def test_mpi_cli_staleness(data):
    """--staleness 2 with a --faults plan slowing subband 1 for two
    rounds, on the first interval: the port's schedule skips it twice."""
    out = run_both(data, "stale", BASE + ["--staleness", "2", "--faults",
                                          SLOW, "-T", "1"], n_tiles=1)
    rec = out["torch"][2][0]
    assert [r[1] for r in rec["schedule"]] == [0.0, 0.0]
    assert rec["dead"] == []
    assert tfaults.get() is None


def test_mpi_cli_time_shard(data):
    """--time-shard 2 over 3 intervals (padded to 4): shard 0 the chain
    of intervals 0 and 1, shard 1 interval 2 cold-started."""
    out = run_both(data, "tshard", BASE + ["--time-shard", "2"])
    hist = out["torch"][2]
    assert [h["tile"] for h in hist] == [0, 1, 2]
    assert all(h["res_1"] < h["res_0"] for h in hist)
    keys = {"coh", "sweep", "matvec", "visits"}
    assert all(set(h["launches"]) == keys and h["xla_solves"] == 0
               for h in hist)
    assert set(hist[0]["run_launches"]) == keys
    assert hist[0]["run_xla_solves"] == 0
    assert not any("run_launches" in h for h in hist[1:])


REFUSALS = {
    "pick_one": ["--block-f", "1", "--staleness", "1"],
    "pick_one_host_loop": ["--host-loop", "--time-shard", "2"],
    "time_shard_1": ["--time-shard", "1"],
    "time_shard_mdl": ["--time-shard", "2", "--mdl"],
    "staleness_beam": ["--staleness", "2", "-B", "1"],
    "staleness_adaptive_rho": ["--staleness", "2", "-C", "1"],
    "block_f_negative": ["--block-f", "-1"],
    "federated_num_processes": ["-N", "1", "--num-processes", "2"],
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_mpi_cli_plan_refusals_match_reference(data, case):
    """Each refusal of the JAX CLI raises the same error type in the
    port (-N with --num-processes 2: the parser's exit)."""
    root, (sky, clus, paths, _) = data
    lst, _, work = _copy(root, paths, f"refuse_{case}")
    argv = ["-f", lst, "-s", sky, "-c", clus] + BASE + REFUSALS[case]
    errs = {}
    for side in ("jax", "torch"):
        try:
            if side == "jax":
                with contextlib.redirect_stderr(io.StringIO()):
                    _jax_main(argv)
            else:
                with contextlib.redirect_stderr(io.StringIO()):
                    tcli_mpi.main(argv + ["--platform", "cpu"],
                                  log=lambda *a: None)
        except (ValueError, SystemExit, NotImplementedError) as e:
            errs[side] = type(e)
    assert errs.get("torch") is not None
    assert errs["torch"] is errs.get("jax"), errs
