"""The port's process group (``sagecal_tpu_torch/distributed.py``) and
the pieces of consensus ADMM that meet over it, against the JAX package
in float64 on the CPU:

- ``admm.pad_subbands`` against JAX's, as numpy arrays, nf below, at and
  above the device count;
- the grouped manifold average and the runner's consensus steps
  (``iter0_post``, ``body_post``: z-sum, Bii over every slot's rho, duals,
  Barzilai-Borwein rho) in 2 gloo processes
  (``torch_group_steps.run_group``) against JAX ``manifold_average_mesh``
  and the mesh runner's parts on a 2-device CPU mesh, 3 subbands padded
  to 4 slots, at rtol 1e-10; the
  padded slot holds other values on each side (a copy of subband 0 and
  its J in JAX, zeros in the port) and changes nothing; Z is bitwise equal
  on both ranks;
- the collectives' identity without a group;
- ``ops/cuda_lib.build_all``'s per-process output names, with a stand-in
  compiler on PATH (no nvcc here): two processes building at once each
  leave a whole library and report and no temporary file."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from sagecal_tpu.compat import shard_map
from sagecal_tpu.consensus import admm as jadmm
from sagecal_tpu.consensus import poly as jpoly
from sagecal_tpu_torch import distributed as dist
from sagecal_tpu_torch.consensus import admm as tadmm

import torch_group_steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10
M, K, N, PP, NF, NITER = 2, 2, 4, 2, 3, 5
CFG = dict(rho=2.0, adaptive_rho=True, manifold_iters=NITER, npoly=PP)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nf,ndev", [(3, 2), (3, 4), (4, 2), (5, 1),
                                     (2, 8)])
def test_pad_subbands_matches_reference(nf, ndev):
    rng = np.random.default_rng(nf * 10 + ndev)
    arrays = [rng.normal(size=(nf, 3, 2)), rng.normal(size=(nf,))]
    B = rng.normal(size=(nf, 2))
    want = jadmm.pad_subbands(arrays, B, nf, ndev)
    got = tadmm.pad_subbands(arrays, B, nf, ndev)
    assert got[2] == want[2] and got[2] % ndev == 0 and got[2] >= nf
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_collectives_are_the_identity_without_a_group():
    t = torch.arange(6.0).reshape(3, 2)
    for f in (dist.all_reduce_sum, dist.all_gather, dist.gather_to_root,
              dist.broadcast_from):
        assert f(t, None) is t
    assert dist.all_gather_object({"a": 1}, None) == [{"a": 1}]
    dist.barrier(None)
    dist.shutdown(None)


def _inputs():
    """J after iteration 0 and after iteration 1 [4 slots, M, K, N, 8]
    (slot 3 padded: a copy of subband 0, as the JAX CLI stages it), each
    slot's unflagged fraction, the padded basis."""
    rng = np.random.default_rng(3)
    eye = np.array([1, 0, 0, 0, 0, 0, 1, 0], float)
    JF = eye + 0.3 * rng.normal(size=(NF, M, K, N, 8))
    Jr = JF + 0.05 * rng.normal(size=JF.shape)
    fratio = np.array([1.0, 0.8, 0.9])
    freqs = 150e6 + np.array([-5e6, 1e6, 6e6])
    B = jpoly.setup_polynomials(freqs, float(freqs.mean()), PP, 2)
    (JF, Jr, fratio), B_pad, fpad = jadmm.pad_subbands((JF, Jr, fratio), B,
                                                       NF, 2)
    assert fpad == 4
    return JF, Jr, fratio, np.asarray(B_pad)


@pytest.fixture(scope="module")
def reference():
    """The JAX mesh runner's consensus steps and manifold_average_mesh
    on a 2-device CPU mesh ("freq" axis)."""
    JF, Jr, fratio, B_pad = _inputs()
    cmask = np.ones((M, K), bool)
    mesh = Mesh(np.array(jax.devices()[:2]), ("freq",))
    cfg = jadmm.ADMMConfig(**CFG)
    rows = NF * 2
    z = np.zeros(rows, np.int32)
    parts = jadmm.make_admm_runner(
        None, z, z, np.zeros((M, rows), np.int32), cmask, N, 1e5, B_pad,
        cfg, mesh, NF, _return_parts=True)

    def step(JF, Jr, fratio, JFm):
        avg = jadmm.manifold_average_mesh(JFm, "freq", NF, M, K, N, NITER)
        zero = jnp.zeros(JF.shape[0], JF.dtype)
        carry, _, _, Y0F = parts["iter0_post"](JF, zero, zero, fratio)
        out = (avg, Y0F, carry[2], carry[1], carry[3])
        carry, (_, _, dual) = parts["body_post"](Jr, zero, zero, carry,
                                                 jnp.int32(1))
        return out + (carry[2], carry[1], carry[3], dual)

    f, r = P("freq"), P()
    prog = jax.jit(shard_map(step, mesh=mesh, in_specs=(f, f, f, f),
                             out_specs=(f, f, r, f, f, r, f, f, r),
                             check_vma=False))
    # the manifold average alone takes the padded slot zeroed, as
    # iter0_post hands it over
    JFm = JF.copy()
    JFm[NF:] = 0.0
    out = prog(jnp.asarray(JF), jnp.asarray(Jr), jnp.asarray(fratio),
               jnp.asarray(JFm))
    return [np.asarray(o) for o in out]


def test_grouped_consensus_step_matches_mesh_runner(reference):
    JF, Jr, fratio, B_pad = _inputs()
    # the port's padded slot: zeros, where the JAX CLI staged subband 0
    JF[NF:], Jr[NF:], fratio[NF:] = 0.0, 0.0, 0.0
    cmask = np.ones((M, K), bool)
    ranks = torch_group_steps.run_group(
        torch_group_steps.consensus_step, 2,
        args=(JF, Jr, fratio, B_pad, cmask, NF, CFG, NITER), timeout=300)
    names = ("manifold average", "Y0", "Z", "Y", "rho", "Z after body",
             "Y after body", "rho after body", "dual")
    replicated = {"Z", "Z after body", "dual"}
    for i, name in enumerate(names):
        want = reference[i]
        if name in replicated:
            got = ranks[0][i]
            assert np.array_equal(ranks[0][i], ranks[1][i]), name
        else:
            got = np.concatenate([r[i] for r in ranks])
            if name == "manifold average":
                want = jadmm._blocks(jnp.asarray(want))
                want = np.asarray(want).reshape(got.shape)
            got, want = got[:NF], want[:NF]
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(),
                                   err_msg=name)
    # the padded slot: no rho, no dual
    assert not ranks[1][4][1].any() and not ranks[1][3][1].any()


def test_run_group_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        torch_group_steps.run_group(torch_group_steps.fail_on_rank, 2,
                                    args=(1,), timeout=120)


def test_cuda_lib_builds_into_per_process_names(tmp_path):
    """Two processes run ``build_all`` at once with a stand-in compiler
    (it writes its ``-o`` file slowly, then a report): both end with the
    same whole library and report and leave no temporary file; each
    compiled into names of its own (``build_paths``)."""
    from sagecal_tpu_torch.ops import cuda_lib
    out = tmp_path / "libx-0123.so"
    a, b = cuda_lib.build_paths(out, 11), cuda_lib.build_paths(out, 12)
    assert a != b and all(p.parent == tmp_path for p in a + b)
    assert {p.name for p in a} == {"libx-0123.11.tmp.so",
                                   "libx-0123.11.tmp.log"}
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(textwrap.dedent("""\
        #!/bin/sh
        while [ "$1" != "-o" ]; do shift; done
        printf 'part-' > "$2"; sleep 0.3; printf 'whole' >> "$2"
        echo "ptxas info    : Used 40 registers"
        """))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    code = ("import sys\nfrom pathlib import Path\n"
            "from sagecal_tpu_torch.ops import cuda_lib\n"
            "cuda_lib.BUILD_DIR = Path(sys.argv[1])\n"
            "print(sorted(cuda_lib.build_all()))\n")
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = sorted(os.listdir(build))
    assert not [n for n in names if ".tmp." in n], names
    libs = [n for n in names if n.endswith(".so")]
    assert len(libs) == len(cuda_lib.SOURCES)
    for n in libs:
        assert (build / n).read_text() == "part-whole"
        assert "Used 40 registers" in (build / n).with_suffix(
            ".log").read_text()
