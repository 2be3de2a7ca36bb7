"""The port imports neither ``jax`` nor ``sagecal_tpu``, and its entry
points refuse to run on the CPU unless asked to."""

import os
import pkgutil
import subprocess
import sys

import pytest

import sagecal_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ["sagecal_tpu_torch"]
    for m in pkgutil.walk_packages(sagecal_tpu_torch.__path__,
                                   "sagecal_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def test_every_module_imports_without_jax():
    """In a fresh interpreter where importing jax or sagecal_tpu fails,
    every port module and chip_smoke.py import."""
    mods = _modules()
    for m in ("cli", "cli_mpi", "config", "consensus", "consensus.admm",
              "consensus.manifold", "consensus.mdl", "consensus.poly",
              "consensus.spatial", "convert", "coords", "device", "dtypes",
              "faults", "federated", "io", "io.dataset", "io.native",
              "io.solutions", "obs", "obs.metrics", "ops", "ops.coh",
              "ops.cuda_lib", "ops.sweep", "pipeline", "rime", "rime.beam",
              "rime.envelopes", "rime.predict", "rime.residual",
              "skymodel", "solvers", "solvers.lbfgs", "solvers.lm",
              "solvers.normal_eq", "solvers.robust", "solvers.rtr",
              "solvers.sage", "stochastic", "utils"):
        assert "sagecal_tpu_torch." + m in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sagecal_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sagecal_tpu' or m.startswith('sagecal_tpu.')]\n"
        "bad = [m for m in bad if sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_cpu_fallback():
    """Without a CUDA device and without device='cpu', the pipeline and
    the CLI raise instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sagecal_tpu_torch import cli, device, pipeline
    from sagecal_tpu_torch.config import RunConfig, SolverMode
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve()
    cfg = RunConfig(ms="unused", sky_model="unused", cluster_file="unused",
                    solver_mode=SolverMode.LM_LBFGS)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-d", "unused", "-s", "unused", "-c", "unused", "-j", "1"])
    assert device.resolve("cpu").type == "cpu"


def test_stochastic_entry_points_refuse_cpu_fallback():
    """The stochastic path (-N > 0) raises without a card too, before it
    opens the dataset."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sagecal_tpu_torch import cli, stochastic
    from sagecal_tpu_torch.config import RunConfig
    cfg = RunConfig(ms="unused", sky_model="unused", cluster_file="unused",
                    n_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        stochastic.run_minibatch(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-d", "unused", "-s", "unused", "-c", "unused", "-N", "1",
                  "-w", "2"])


def test_consensus_entry_points_refuse_cpu_fallback():
    """The MPI CLI (each execution plan) and stochastic consensus raise
    without a card unless asked for the CPU, before they open a
    dataset."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sagecal_tpu_torch import cli, cli_mpi, stochastic
    from sagecal_tpu_torch.config import RunConfig
    cfg = RunConfig(ms="unused", sky_model="unused", cluster_file="unused",
                    n_epochs=1, n_admm=3, channel_avg_per_band=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        stochastic.run_minibatch_consensus(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-d", "unused", "-s", "unused", "-c", "unused", "-N", "1",
                  "-w", "2", "-A", "3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_mpi.main(["-f", "unused", "-s", "unused", "-c", "unused"])
    for plan in (["-N", "1", "-w", "2"], ["--block-f", "2"],
                 ["--staleness", "1"], ["--time-shard", "2"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_mpi.main(["-f", "unused", "-s", "unused", "-c", "unused"]
                         + plan)


def test_kernel_build_is_lazy():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    from sagecal_tpu_torch.ops import coh, cuda_lib, sweep
    assert coh.LAUNCHES == 0 and sweep.LAUNCHES == 0
    assert sweep.MATVEC_LAUNCHES == 0
    assert cuda_lib._LIBS == {}
    assert set(cuda_lib.SOURCES) == {"coh", "sweep", "matvec"}
    assert set(cuda_lib.SIGNATURES) == set(cuda_lib.SOURCES)
    for name in cuda_lib.SOURCES:
        assert (cuda_lib.CSRC / f"{name}.cu").is_file()
