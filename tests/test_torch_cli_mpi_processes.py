"""The MPI CLI over processes (``--coordinator``, ``--num-processes``,
``--process-id``; ``sagecal_tpu_torch/distributed.py``) on the CPU in
float64, against the JAX MPI CLI in one process on a CPU mesh of the
same padded layout, on ``tests/test_cli_mpi.py``'s subbands (3 of them),
each side on its own copy, at ``-j 1 -C 1 -U 1 -R 0``:

- 2 ranks (3 subbands padded to 4 slots, rank 1 holding subband 2 and
  the padded slot) against ``--mesh-devices 2`` (fpad 4: the same
  padding);
- 4 ranks (rank 3 holds only a padded slot) against ``--mesh-devices 4``,
  which the JAX CLI folds to 3 devices at nf = 3 (``ndev = min(ndev,
  nf)``, unpadded), both with ``--mdl``: the padded slot changes nothing,
  and rank 3 meets the others at the MDL report's gathers (its one
  report against the JAX CLI's);
- 2 ranks with ``-X``, ``-u``, ``--mdl`` and ``-G`` against the port's
  one-process run (the spatial file and the MDL report too).

Every written column within ``COL_TOL`` of the data's largest magnitude,
the Z file and the worker files within ``FILE_TOL`` of their largest
entry (``test_torch_cli_mpi.py``'s gates), and only rank 0 writes and
logs. Also the refusals raised before any handshake, ``-N`` with more
than one process a parser error, and ``--cpu-devices`` inert on both
CLIs (``torch.equal`` outputs)."""

import contextlib
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from sagecal_tpu import cli_mpi
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import cli_mpi as tcli_mpi
from sagecal_tpu_torch import distributed as dist
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol

from test_cli_mpi import make_subbands
from test_torch_cli_mpi import BASE, COL_TOL, FILE_TOL

FLAGS = BASE + ["-j", "1", "-C", "1", "-U", "1"]
NF = 3
#: flags of the run at each world size (and of its JAX reference)
EXTRA = {2: [], 4: ["--mdl"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpi_procs")
    sky_path, clus_path, paths, sky = make_subbands(root, nf=NF)
    return root, str(sky_path), str(clus_path), paths, sky


def _copy(data, tag):
    """A copy of the subbands: (argv of the run with its Z file, paths)."""
    root, sky_path, clus_path, paths, _ = data
    work = root / tag
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    out = []
    for p in paths:
        out.append(str(work / os.path.basename(p)))
        shutil.copytree(p, out[-1])
    lst = work / "mslist.txt"
    lst.write_text("\n".join(out) + "\n")
    return ["-f", str(lst), "-s", sky_path, "-c", clus_path, "-p",
            str(work / "zsol.txt")] + FLAGS, out


@pytest.fixture(scope="module")
def reference(data):
    """The JAX MPI CLI at --mesh-devices 2 and 4, one process each:
    {devices: (paths, Z file, stdout lines)}."""
    out = {}
    for ndev in (2, 4):
        argv, paths = _copy(data, f"jax{ndev}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli_mpi.main(argv + ["--mesh-devices", str(ndev)]
                                + EXTRA[ndev]) == 0
        out[ndev] = (paths, argv[argv.index("-p") + 1],
                     buf.getvalue().splitlines())
    return out


def _hold(got_paths, got_z, ref, sky):
    """The port's written columns, Z file and worker files against the
    JAX CLI's (``test_torch_cli_mpi.run_both``'s gates)."""
    paths, z, _ = ref
    for a, b in zip(got_paths, paths):
        xa = tds.SimMS(a, data_column="CORRECTED_DATA").read_tile(0).x
        xb = tds.SimMS(b, data_column="CORRECTED_DATA").read_tile(0).x
        scale = np.abs(tds.SimMS(b).read_tile(0).x).max()
        assert np.abs(xa - xb).max() <= COL_TOL * scale
    for a, b, nc in [(got_z, z, sky.nchunk * 2)] + [
            (a + ".solutions", b + ".solutions", sky.nchunk)
            for a, b in zip(got_paths, paths)]:
        ha, ba = tsol.read_solutions(a, nc)
        hb, bb = tsol.read_solutions(b, nc)
        assert ha == hb and len(ba) == len(bb) == 1
        ba, bb = np.asarray(ba), np.asarray(bb)
        assert np.abs(ba - bb).max() <= FILE_TOL * np.abs(bb).max()


@pytest.mark.parametrize("world", [2, 4])
def test_mpi_cli_ranks_match_reference(data, reference, world):
    argv, paths = _copy(data, f"torch{world}")
    ranks = dist.run_ranks(argv + ["--platform", "cpu"] + EXTRA[world],
                           world, timeout=600)
    (hist, lines), rest = ranks[0], ranks[1:]
    _hold(paths, argv[argv.index("-p") + 1], reference[world], data[4])
    mdl = [[ln for ln in ls if ln.startswith("Finding best")]
           for ls in (lines, reference[world][2])]
    assert len(mdl[0]) == len(mdl[1]) == ("--mdl" in EXTRA[world])
    for a, b in zip(*mdl):
        na, nb = (np.array(re.findall(r"[-+]?\d+(?:\.\d+)?", x), float)
                  for x in (a, b))
        np.testing.assert_allclose(na, nb, rtol=1e-6, atol=1e-6)
    fpad = 4
    assert any(ln.startswith(f"Subbands: {NF} over {world} device(s) "
                             f"(padded to {fpad})") for ln in lines)
    assert any(ln.startswith("Timeslot:0 ADMM:3") for ln in lines)
    h = hist[0]
    assert (h["world"], h["fpad"], h["backend"]) == (world, fpad, "gloo")
    assert len(h["rank_launches"]) == world
    assert h["res_1"] < h["res_0"] and len(h["res_0_f"]) == NF
    # rank 0 wrote every file and column; no other rank wrote or logged
    assert sorted(h["wrote"]) == sorted(
        [p + ".solutions" for p in paths] + paths
        + [argv[argv.index("-p") + 1]])
    for hist_r, lines_r in rest:
        assert lines_r == [] and all(r["wrote"] == [] for r in hist_r)
        assert [r["res_1_f"] for r in hist_r] == [r["res_1_f"] for r in hist]


def test_mpi_cli_ranks_spatial_mdl_match_one_process(data):
    """-X with -u (the spatial prior: Zbar and X replicated on the ranks;
    rank 0 writes the spatial file), --mdl (the report from the gathered
    iteration-0 Y) and -G: 2 ranks against the port's own one-process run
    (which ``test_torch_cli_mpi.py`` holds against the JAX CLI; the JAX
    CLI's -X aborts on a multi-device mesh under jaxlib 0.4), at the same
    gates, the spatial file and the MDL report included."""
    extra = ["-X", "0.1,0.01,2,20,2", "-u", "0.5", "--mdl", "-G", "@rho"]
    runs = {}
    for tag in ("one", "two"):
        argv, paths = _copy(data, f"xmdl_{tag}")
        work = os.path.dirname(argv[argv.index("-p") + 1])
        rho = os.path.join(work, "rho.txt")
        with open(rho, "w") as f:
            f.write("0 1 1.5\n1 1 3.0\n")
        argv = argv + [rho if a == "@rho" else a for a in extra] \
            + ["--platform", "cpu"]
        if tag == "one":
            lines = []
            tcli_mpi.run(argv, log=lines.append)
        else:
            (_, lines), (_, lines1) = dist.run_ranks(argv, 2, timeout=600)
            assert lines1 == []
        runs[tag] = (paths, argv[argv.index("-p") + 1], lines)
    (pa, za, la), ref = runs["two"], runs["one"]
    _hold(pa, za, ref, data[4])
    fa, fb = (np.loadtxt(os.path.join(os.path.dirname(z), "spatial_zsol.txt"),
                         skiprows=6) for z in (za, ref[1]))
    assert fa.shape == fb.shape
    assert np.abs(fa - fb).max() <= FILE_TOL * np.abs(fb).max()
    mdl = [[ln for ln in lines if ln.startswith("Finding best")]
           for lines in (la, ref[2])]
    assert len(mdl[0]) == 1 and mdl[0] == mdl[1]


@pytest.mark.parametrize("extra,match", [
    (["--time-shard", "2"], "--time-shard stages the whole observation"),
    (["--staleness", "1"], "--staleness is a single-device"),
    (["--block-f", "2"], "--block-f is the single-device execution plan"),
    (["--process-id", "2"], "--process-id 2 of --num-processes 2")])
def test_multi_process_refusals_before_handshake(extra, match):
    """Raised before the handshake: the coordinator's port is never
    contacted."""
    with pytest.raises(ValueError, match=match):
        tcli_mpi.main(["-f", "x", "-s", "s", "-c", "c", "--coordinator",
                       "127.0.0.1:1", "--num-processes", "2",
                       "--platform", "cpu"] + extra)


def test_multi_process_needs_coordinator_and_refuses_n():
    base = ["-f", "x", "-s", "s", "-c", "c", "--num-processes", "2",
            "--platform", "cpu"]
    with pytest.raises(ValueError, match="needs --coordinator"):
        tcli_mpi.main(base)
    with pytest.raises(SystemExit):
        tcli_mpi.main(base + ["--coordinator", "127.0.0.1:1", "-N", "1"])


def test_cpu_devices_is_inert_on_both_clis(data):
    """Each CLI with and without --cpu-devices 4 on its own copy: the
    written columns and the solution files equal, bit for bit."""
    outs = {}
    for tag in ("plain", "cpu4"):
        extra = ["--cpu-devices", "4"] if tag == "cpu4" else []
        argv, paths = _copy(data, f"cpudev_mpi_{tag}")
        assert tcli_mpi.main(argv + ["--platform", "cpu"] + extra,
                             log=lambda *a: None) == 0
        argv_fb, paths_fb = _copy(data, f"cpudev_fb_{tag}")
        sol = argv_fb[argv_fb.index("-p") + 1]
        assert tcli.main(["-d", paths_fb[0], "-s", argv[3], "-c", argv[5],
                          "-p", sol, "-j", "1", "-e", "1", "-g", "3", "-l",
                          "2", "-t", "3", "-R", "0", "--platform", "cpu"]
                         + extra) == 0
        outs[tag] = [tds.SimMS(p, data_column="CORRECTED_DATA").read_tile(0).x
                     for p in paths + paths_fb[:1]] + [
            open(f).read() for f in [argv[argv.index("-p") + 1], sol]
            + [p + ".solutions" for p in paths]]
    for a, b in zip(outs["plain"], outs["cpu4"]):
        if isinstance(a, str):
            assert a == b
        else:
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
